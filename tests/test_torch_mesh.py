"""The port's mesh extraction (`tpu_splat_torch/eval/mesh.py`,
`scripts/extract_mesh.py`) against the JAX package's on the CPU.

Tolerances:
- tsdf_fusion on the same seeded numpy maps and cameras: the tsdf within
  1e-6 abs, colour within 1e-6, weights exact (both fuse in float64
  geometry; the JAX package's projections go through BLAS, the port's are
  written out as the same dot sums, so the float64 values may differ in
  the last bits and the float32 grid by an ulp);
- marching_tetrahedra and extract_mesh_tsdf on one grid: vertices, faces
  and colours exact; save_mesh_ply: the same bytes;
- both extract_mesh CLIs on the 32x32 scene of tests/test_scripts.py, the
  JAX renderer on its Pallas kernels (backend="pallas", jitted), as
  tests/test_torch_eval_cli.py runs it. The renders agree within 2e-5
  (tests/test_torch_render.py), so a voxel's tsdf may move by 2e-5 * its
  view's depth / trunc; the alpha ~ 1/255 accept flips (up to 8 per 4096
  px, PARITY.md D4) and the alpha 0.5 threshold can change a whole
  update. So: the tsdf within 2e-5 * max depth / trunc and the weights
  equal on all but 8/4096 of the voxels; vertex and face counts within 2%;
  every vertex of each mesh within one voxel of the other mesh (Hausdorff).
"""
import os

import numpy as np
import pytest
import torch

from tests.test_mesh import _sphere_sdf
from tpu_splat.eval import mesh as jmesh
from tpu_splat_torch.eval import mesh as tmesh

H, W = 24, 32


def _w2c(angle, t):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
    m[:3, 3] = t
    return m


def _maps(seed=3, views=3):
    """Seeded maps and cameras in general position (no voxel projects onto
    a pixel boundary, where the two projections' last bits decide)."""
    rng = np.random.default_rng(seed)
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    w2cs = [_w2c(0.1234 + a, [0.0371, -0.0219, 3.0137]) for a in (0.0, 0.3, -0.4)][:views]
    return dict(
        depths=[rng.uniform(2.5, 3.5, (H, W)).astype(np.float32) for _ in w2cs],
        colors=[rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in w2cs],
        alphas=[rng.uniform(0, 1, (H, W)).astype(np.float32) for _ in w2cs],
        Ks=[K] * len(w2cs), w2cs=w2cs,
        bounds_min=np.array([-1.013, -0.987, -1.021]),
        bounds_max=np.array([1.017, 0.991, 1.003]),
    )


@pytest.fixture(scope="module")
def fused():
    m = _maps()
    return m, jmesh.tsdf_fusion(**m, resolution=40), tmesh.tsdf_fusion(**m, resolution=40)


def test_tsdf_fusion_matches_jax(fused):
    _, want, got = fused
    for name, a, b, tol in (("tsdf", want[0], got[0], 1e-6), ("color", want[1], got[1], 1e-6),
                            ("weight", want[2], got[2], 0.0)):
        b = b.numpy()
        assert a.shape == b.shape and b.dtype == np.float32, name
        assert np.abs(a - b).max() <= tol, name
    assert (want[2] > 0).mean() > 0.1  # the views update a real share of the grid
    np.testing.assert_array_equal(want[3], got[3])
    assert want[4] == got[4]


def test_tsdf_fusion_chunking_and_depth_trunc(fused):
    """The z-chunk sets the memory, not the grid; depth_trunc as numpy's."""
    m, _, got = fused
    whole = tmesh.tsdf_fusion(**m, resolution=40, z_chunk=1000)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], whole[:3]))
    want = jmesh.tsdf_fusion(**m, resolution=24, depth_trunc=3.0, trunc=0.2)
    have = tmesh.tsdf_fusion(**m, resolution=24, depth_trunc=3.0, trunc=0.2)
    np.testing.assert_array_equal(want[2], have[2].numpy())
    assert np.abs(want[0] - have[0].numpy()).max() <= 1e-6


@pytest.mark.parametrize("grid", ["sphere", "sphere_f32_noisy", "fused"])
def test_marching_tetrahedra_matches_jax_exactly(fused, grid):
    if grid == "fused":
        sdf, kw = fused[1][0], dict(origin=fused[1][3], spacing=fused[1][4])
    else:
        sdf, spacing = _sphere_sdf(48, 0.6)
        kw = dict(origin=(-1, -1, -1), spacing=spacing)
        if grid == "sphere_f32_noisy":
            rng = np.random.default_rng(0)
            sdf = (sdf + rng.normal(0, 0.02, sdf.shape)).astype(np.float32)
    want = jmesh.marching_tetrahedra(sdf, 0.0, **kw)
    got = tmesh.marching_tetrahedra(sdf, 0.0, **kw)
    assert len(want.vertices) > 500
    for a, b in ((want.vertices, got.vertices), (want.faces, got.faces)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_marching_tetrahedra_empty():
    mesh = tmesh.marching_tetrahedra(np.ones((8, 8, 8)))
    assert mesh.vertices.shape == (0, 3) and mesh.faces.shape == (0, 3)


def test_extract_mesh_tsdf_and_ply_bytes_match_jax(tmp_path):
    m = _maps(seed=4)
    want = jmesh.extract_mesh_tsdf(**m, resolution=32)
    got = tmesh.extract_mesh_tsdf(**m, resolution=32)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    jmesh.save_mesh_ply(want, str(tmp_path / "j.ply"))
    tmesh.save_mesh_ply(got, str(tmp_path / "t.ply"))
    tmesh.save_mesh_ply(got._replace(colors=None), str(tmp_path / "t_plain.ply"))
    jmesh.save_mesh_ply(want._replace(colors=None), str(tmp_path / "j_plain.ply"))
    for name in ("", "_plain"):
        assert (tmp_path / f"t{name}.ply").read_bytes() == (tmp_path / f"j{name}.ply").read_bytes()


# --- both extract_mesh CLIs on a trained-looking model -------------------

MESH_RES = 24
# the JAX CLI reads these three without a default (get_combined_args drops
# flags that are None): it raises AttributeError unless all are given
JAX_NEEDS = ["--bounds", "1.5", "--depth_trunc", "100", "--num_views", "3"]


def _hausdorff(a: np.ndarray, b: np.ndarray) -> float:
    d = torch.cdist(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    return float(max(d.min(1).values.max(), d.min(0).values.max()))


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """Each package's extract_mesh CLI on its own copy of one model dir,
    with tsdf_fusion wrapped to keep the grid it returns."""
    from tests.test_scripts import _make_scene
    from tests.test_torch_eval_cli import _build_model, _jax_rendering, _model_dirs

    import tpu_splat.eval.mesh as jm
    import tpu_splat_torch.eval.mesh as tm
    from tpu_splat.scripts import extract_mesh as jcli
    from tpu_splat_torch.scripts import extract_mesh as tcli

    root = tmp_path_factory.mktemp("mesh_cli")
    src = str(root / "scene")
    _make_scene(src, n=3, size=32)
    state, ts = _build_model(src)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for pkg, mod, cli, kw in (("port", tm, tcli, {"device": "cpu"}), ("jax", jm, jcli, {})):
            model, _ = _model_dirs(root / pkg, src, state, ts)
            grids = []
            real = mod.tsdf_fusion
            mp.setattr(mod, "tsdf_fusion", lambda *a, _r=real, _g=grids, **k: _g.append(
                _r(*a, **k)) or _g[-1])
            if pkg == "jax":
                _jax_rendering(mp)
            assert cli.main(["-m", model, "--mesh_res", str(MESH_RES), "--export_images",
                             *JAX_NEEDS], **kw) == 0
            out[pkg] = dict(model=model, grid=grids[0],
                            ply=open(os.path.join(model, "mesh", "fuse.ply"), "rb").read())
    return out


def _read_mesh_ply(data: bytes):
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    nv = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
    nf = int(next(l for l in lines if l.startswith("element face")).split()[-1])
    v = np.frombuffer(body, np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]), nv)
    f = np.frombuffer(body[v.nbytes:], np.dtype([("n", "u1"), ("idx", "<i4", 3)]), nf)
    return np.ascontiguousarray(v["xyz"]), np.ascontiguousarray(f["idx"])


def test_extract_mesh_cli_grid_matches_jax(clis):
    (tj, cj, wj, oj, sj), (tt, ct, wt, ot, st) = clis["jax"]["grid"], clis["port"]["grid"]
    np.testing.assert_array_equal(oj, ot)
    assert sj == st
    tt, wt = tt.numpy(), wt.numpy()
    trunc = 4.0 * sj
    depth_max = 8.0  # the cameras sit at radius 4 around the cube of the cloud
    off = (np.abs(tj - tt) > 2e-5 * depth_max / trunc) | (wj != wt)
    assert (wj > 0).mean() > 0.05
    assert off.sum() <= 8 * off.size / 4096, int(off.sum())


def test_extract_mesh_cli_mesh_matches_jax(clis):
    vj, fj = _read_mesh_ply(clis["jax"]["ply"])
    vt, ft = _read_mesh_ply(clis["port"]["ply"])
    assert len(vj) > 50 and len(fj) > 50
    assert abs(len(vt) - len(vj)) <= 0.02 * len(vj)
    assert abs(len(ft) - len(fj)) <= 0.02 * len(fj)
    assert _hausdorff(vj, vt) <= clis["jax"]["grid"][4]


def test_extract_mesh_cli_writes_the_jax_files(clis):
    """--export_images: the same files, each PNG the JAX CLI's pixels but
    +-1 level on at most 8 px per 4096 (the accept flips, quantised)."""
    from tpu_splat_torch.data.native_loader import decode_png

    files = {k: sorted(os.path.relpath(os.path.join(d, f), v["model"])
                       for d, _, fs in os.walk(os.path.join(v["model"], "mesh")) for f in fs)
             for k, v in clis.items()}
    assert files["port"] == files["jax"] and "mesh/fuse.ply" in files["port"]
    pngs = [f for f in files["port"] if f.endswith(".png")]
    assert len(pngs) == 6
    for name in pngs:
        a, b = (decode_png(os.path.join(clis[k]["model"], name)).astype(np.int16)
                for k in ("port", "jax"))
        off = np.abs(a - b).max(-1)
        assert off.max() <= 1 and int((off > 0).sum()) <= 8 * off.size / 4096, name


def test_extract_mesh_cli_defaults_where_the_jax_cli_raises(clis, tmp_path):
    """Without --bounds, --depth_trunc and --num_views the JAX CLI raises
    AttributeError; the port fuses over the cameras' cube, every view."""
    import shutil

    from tpu_splat.scripts import extract_mesh as jcli
    from tpu_splat_torch.scripts import extract_mesh as tcli

    model = str(tmp_path / "m")
    shutil.copytree(clis["port"]["model"], model)
    with pytest.raises(AttributeError):
        jcli.main(["-m", model, "--mesh_res", "8"])
    assert tcli.main(["-m", model, "--mesh_res", str(MESH_RES)], device="cpu") == 0
    v, f = _read_mesh_ply(open(os.path.join(model, "mesh", "fuse.ply"), "rb").read())
    assert len(v) > 0 and len(f) > 0 and np.isfinite(v).all()
