"""The port's developer tools on the CPU (no JAX).

- The parity CLI (tpu_splat_torch/tools/parity.py) at 48x48 on 300
  Gaussians: every case passes at the JAX scripts' bounds and it exits 0;
  with the kernel path's colour moved by 1e-2 (a monkeypatched blend) it
  exits 1 and says which side is nearer the float64 scan blend.
- The scaling table (tpu_splat_torch/tools/scaling_table.py) over 1 and 2
  gloo ranks at 48x48 on 300 Gaussians: the tile-sharded ranks' instances
  and tested pairs sum to the unsharded step's, a DP rank's equal its
  camera's unsharded step's, and each collective carries the bytes
  dist/collectives.py implies: the table all-reduce 19 float32 a Gaussian
  of the capacity, the slab gather a rank's tile rows of out_px (16 rows of
  256 float32 a tile) and their int32 counts, the env sample gather a
  rank's share of the frame's RGB, the DP all-reduce every parameter value
  and 5 loss scalars.
"""
import pytest
import torch

from tpu_splat_torch.raster.config import TILE, tile_grid
from tpu_splat_torch.tools import parity, scaling_table

SIZE, N = 48, 300


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's spinning worker threads then take the cores from each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_parity_cli_passes_on_the_cpu(tmp_path):
    out = tmp_path / "parity.json"
    assert parity.main(["--device", "cpu", "--size", str(SIZE), "--gaussians", str(N),
                        "--json", str(out)]) == 0
    assert out.stat().st_size > 0


def test_parity_cli_fails_on_a_perturbed_blend(monkeypatch, capsys):
    import tpu_splat_torch.raster as rp

    kernel_path = rp.blend_kernel_path

    def moved(*a, **kw):
        o = kernel_path(*a, **kw)
        return o._replace(color=o.color + 1e-2)

    monkeypatch.setattr(rp, "blend_kernel_path", moved)
    assert parity.main(["--device", "cpu", "--size", str(SIZE), "--gaussians", str(N),
                        "--case", "kernel_repro"]) == 1
    text = capsys.readouterr().out
    assert "FAIL" in text and "nearer_f64 scan" in text


@pytest.fixture(scope="module")
def table():
    return scaling_table.table(ranks=(1, 2), size=SIZE, gaussians=N, threads=1)


def test_scaling_table_work_per_rank(table):
    un = table["unsharded"]
    for n, ranks in table["tiles"].items():
        assert sum(r["instances"] for r in ranks) == un[0]["instances"] > 0, n
        assert sum(r["pairs"] for r in ranks) == un[0]["pairs"] > 0, n
    for n, ranks in table["dp"].items():
        for r in ranks:
            assert (r["instances"], r["pairs"]) == (un[r["rank"]]["instances"],
                                                    un[r["rank"]]["pairs"]), (n, r["rank"])
    assert len({r["replicated"]["gaussians"] for r in table["tiles"][2]}) == 1


def test_scaling_table_collective_bytes(table):
    cap = table["capacity"]
    ty, tx = tile_grid(SIZE, SIZE)
    for n, ranks in table["tiles"].items():
        rows = -(-ty // n) * tx  # a rank's tiles
        for r in ranks:
            s = {k.split(":")[0]: v for k, v in r["sites"].items()}
            assert s["table all-reduce"]["bytes"] == 19 * 4 * cap
            assert s["slab gather"]["bytes"] == rows * (16 * TILE * TILE * 4 + 4)
            assert s["env sample gather"]["bytes"] == SIZE * SIZE * 3 * 4 // n
            assert r["carried"] == sum(v["bytes"] for v in r["sites"].values())
    for n, ranks in table["dp"].items():
        for r in ranks:
            s = {k.split(":")[0]: v for k, v in r["sites"].items()}
            assert s["DP flat all-reduce"]["bytes"] == 4 * (r["replicated"]["adam_values"] + 5)


def test_scaling_table_markdown(table):
    md = scaling_table.markdown(table)
    assert "host copies, not scaling" in md and md.count("| tiles | 2 |") >= 2
