"""The port's profiler (tpu_splat_torch/tools/profile.py) on the CPU (no
JAX): each of its seven sections at a tiny size through the module's
functions prints its named rows, each finite and above 0; the rows kept
from the JAX tool keep their names; the stage rows read the port's stage
spans (record_stages on the host clock); the micro-benchmarks' rows stand
in `binning` and `regroup`; the CLI writes its rows as JSON and refuses an
unknown section.
"""
import json
import math

import pytest
import torch

from tpu_splat_torch.core.device import record_stages, stage
from tpu_splat_torch.raster.config import production_config
from tpu_splat_torch.scripts import bench
from tpu_splat_torch.tools import profile

TINY = profile.Scale(
    bench.Setup(32, 48, 300, 512, production_config(
        max_tiles_per_gaussian=16, max_instances=8192, tile_depth=256, chunk=16), 1),
    gaussians=1 << 10, cap=8192, cap_bench=8192, n_tiles=6, env_size=(16, 24), env_res=8,
    iters=1)

# rows each section must print (the JAX tool's names where the port has the
# computation, the stage spans' names where a row reads one)
ROWS = {
    "full": ["render fwd+bwd (full)", "render fwd (full)", "[fwd+bwd] preprocess",
             "[fwd+bwd] tile_blend_forward", "[fwd+bwd] tile_blend_backward",
             "[fwd+bwd] segment_sum", "[fwd+bwd] cubemap_accumulate", "[fwd+bwd] backward"],
    "stages": ["preprocess", "binning+sort", "pack_features", "pack_features (bf16 16-row)",
               "tile_blend fwd (full)", "tile_blend fwd (train-shape)", "tile_blend bwd (full)",
               "tile_blend bwd (train-shape)", "regroup_sort", "reflection",
               "rasterize fwd (full)"],
    "binning": ["depth argsort (P)", "expand (mark+cumsum+gather)",
                "expand (run_expand kernel)", "bin_gaussians whole (gather)",
                "bin_gaussians whole (kernel)", "bin_gaussians whole (tight)",
                "[tight] tight_column_range", "num_instances rect", "num_instances tight",
                "capacity", "used-chunk fraction", "mark scatter (P -> cap)", "cumsum [cap]",
                "cummax [cap]", "row gather [cap,2] <- [P,2]", "counts 1-col sort [cap]",
                "searchsorted n_tiles queries", "aligned stable sort key+3 [cap_al]",
                "aligned stable sort key+2 [cap_al]", "window-gather expand [cap,2]",
                "plain row gather [cap,2]", "plain row gather [cap,16]",
                "window-gather [cap,16]", "monotone scatter 1col cap->cap_al"],
    "regroup": ["bwd sort-regroup + segsum (f32)", "bwd sort-regroup + segsum (bf16)",
                "bwd sort-regroup + segsum (packed kernel)", "[packed kernel] segment_sum",
                "sort 1key+1payloads", "sort 1key+3payloads", "sort 1key+10payloads",
                "segment_sum_ranges [19,cap_al] (kernel #3)", "rank_of gather [P,19]",
                "sort stable 1key+1payload", "regroup: 19-col sort",
                "regroup: unique row scatter-set", "regroup: row gather by perm"],
    "env": ["[smooth] env fwd", "[smooth] env fwd+bwd", "[random] env fwd",
            "[random] env fwd+bwd"],
    "render": ["step fwd+bwd (deferred)", "step fwd+bwd (initial-stage)"],
    "tail": ["assemble(10ch)+L1 fwd", "assemble(10ch)+L1 fwd+bwd",
             "assemble color-only + L1 fwd+bwd", "tile-space composite+L1 fwd+bwd",
             "post-raster tail (nrm+env+L1) f+b"],
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sections_are_the_jax_tools():
    assert list(profile.SECTIONS) == list(ROWS)


@pytest.mark.parametrize("section", list(ROWS))
def test_section_prints_its_rows(capsys, section):
    rows = profile.run([section], "cpu", scale=TINY)[section]
    names = [r["name"] for r in rows]
    assert set(ROWS[section]) <= set(names), sorted(set(ROWS[section]) - set(names))
    assert len(set(names)) == len(names)
    assert all(math.isfinite(r["value"]) and r["value"] > 0 for r in rows), rows
    out = capsys.readouterr().out
    assert f"--- {section} ---" in out
    assert all(n in out for n in names)


def test_binning_counts_instances_against_the_capacity():
    rows = {r["name"]: r for r in profile.run(["binning"], "cpu", scale=TINY)["binning"]}
    cap = rows["capacity"]["value"]
    assert cap == TINY.setup.cfg.max_instances
    assert 0 < rows["num_instances tight"]["value"] <= rows["num_instances rect"]["value"] <= cap
    assert 0 < rows["used-chunk fraction"]["value"] <= 1


def test_record_stages_on_the_host_clock():
    with record_stages("cpu") as st:
        with stage("a"):
            torch.ones(100).sum()
        with stage("a"):
            pass
    assert set(st) == {"a"} and st["a"] > 0


def test_cli_writes_its_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(profile, "cpu_scale", lambda: TINY)
    out = tmp_path / "rows.json"
    rows = profile.main(["env", "tail", "--device", "cpu", "--json", str(out)])
    saved = json.loads(out.read_text())
    assert saved["device"] == "cpu" and saved["sections"] == rows
    assert list(rows) == ["env", "tail"]
    with pytest.raises(SystemExit):
        profile.main(["no_such_section", "--device", "cpu"])
