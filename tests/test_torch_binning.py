"""tpu_splat_torch binning with the run decode vs the JAX package, on the CPU.

The plain version of each kernel (what the port's wrapper runs on CPU
tensors) and the port's `bin_gaussians` against the JAX functions on
identical inputs; the JAX side runs its Pallas kernels in interpret mode.
The binning inputs are the JAX package's own `preprocess` outputs, carried
across as numpy arrays, so the comparison holds binning alone. Every JAX
reference is computed once per module.

Tolerances:
- run_expand: rows and j exactly equal (the JAX kernel's 3-way bf16 split
  rebuilds every finite f32 exactly; the tables are asserted finite);
- bin_gaussians in kernel mode and with tight culling: every field of
  `Binned` exactly equal, on tests/test_raster.py's scenes (the 900-surfel
  scene and the anisotropic 220-surfel load at 8192 slots), on a
  2600-surfel scene that overflows its 4096 slots, or its 4096 columns at
  8192 slots, and with a
  capacity that is not a multiple of 4096 (both packages then bin by
  gather with tight culling off); at 1088x1920 on 100k surfels, exactly
  equal on the JAX package's jitted preprocess output, and the port's own
  preprocess + binning exactly equal to the JAX package's jitted
  preprocess + binning, as its trainer runs them;
- segment_sum_rows: 1e-6 of each column's max |sum| (the JAX kernel sums a
  run as an f32 MXU product, the port in run order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.data import orbit_camera, random_scene
from tpu_splat.kernels import run_expand as jre
from tpu_splat.kernels import segment_reduce as jsr
from tpu_splat.raster.binning import bin_gaussians as j_bin
from tpu_splat.raster.config import RasterConfig
from tpu_splat.raster.preprocess import preprocess

import tpu_splat_torch.raster.config as tcfg
from tpu_splat_torch.kernels import run_expand as tre
from tpu_splat_torch.kernels import segment_reduce as tsr
from tpu_splat_torch.raster.binning import Binned, bin_gaussians as t_bin
from tpu_splat_torch.raster.preprocess import Preprocessed

H = W = 48


def _t(x):
    return torch.from_numpy(np.array(x))


def _runs(rng, P, n_out, K, zero_tail):
    """A run table as binning builds it: lengths >= 1 up to the emitting
    prefix, zero-length runs after it; offsets clipped at n_out."""
    lens = rng.integers(1, 9, P)
    lens[P - zero_tail:] = 0
    off = np.cumsum(lens) - lens
    total = int(lens.sum())
    mark = np.zeros(n_out + P + 1, np.int64)
    mark[np.where((lens > 0) & (off < n_out), off, n_out + np.arange(P))] += 1
    r0 = np.maximum(np.cumsum(mark[:n_out])[::128] - 1, 0).astype(np.int32)
    table = rng.normal(size=(P, K)).astype(np.float32)
    table[:, 0] = rng.integers(0, 1 << 20, P)  # integer columns ride as f32
    table[::7, 1] = -0.0
    return (table, np.minimum(off, n_out).astype(np.int32),
            np.int32(min(total, n_out)), r0)


# (K, n_out, runs, zero-length tail): every slot covered; total < n_out;
# an overflowing table clipped at n_out
EXPAND_CASES = [(4, 4096, 500, 40), (5, 4096, 1200, 3), (11, 4096, 300, 100),
                (4, 8192, 1800, 0), (5, 8192, 900, 250), (11, 8192, 1500, 50)]


@pytest.mark.parametrize("K,n_out,P,zero_tail", EXPAND_CASES)
def test_run_expand_matches_jax(K, n_out, P, zero_tail):
    rng = np.random.default_rng(K * 7 + n_out)
    table, off, total, r0 = _runs(rng, P, n_out, K, zero_tail)
    assert np.isfinite(table).all()
    want_rows, want_j = jre.run_expand(jnp.asarray(table), jnp.asarray(off), jnp.asarray(total),
                                       jnp.asarray(r0), n_out)
    got_rows, got_j = tre.run_expand(_t(table), _t(off), _t(total), _t(r0), n_out)
    assert got_rows.shape == (K, n_out) and got_j.dtype == torch.int32
    np.testing.assert_array_equal(got_rows.numpy().view(np.int32),
                                  np.asarray(want_rows).view(np.int32))
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))
    if total < n_out:  # slots past the last run: zero rows, j = i
        assert not got_rows[:, total:].any()
        assert torch.equal(got_j[total:], torch.arange(int(total), n_out, dtype=torch.int32))


@pytest.mark.parametrize("K,n_out,r0_len", [(15, 4096, 32), (4, 4096 + 128, 33),
                                           (4, 1 << 23, 1 << 16), (4, 4096, 31)],
                         ids=["K>14", "n_out%4096", "n_out>=2^23", "r0_sub-length"])
def test_run_expand_raises_as_jax(K, n_out, r0_len):
    P = 16
    args = (np.zeros((P, K), np.float32), np.zeros(P, np.int32), np.int32(0),
            np.zeros(r0_len, np.int32))
    with pytest.raises(ValueError) as want:
        jre.run_expand(*(jnp.asarray(a) for a in args), n_out)
    with pytest.raises(ValueError) as got:
        tre.run_expand(*(_t(a) for a in args), n_out)
    assert str(got.value) == str(want.value)


def _scene_prep(name):
    """tests/test_raster.py's binning scenes, preprocessed by the JAX
    package."""
    if name == "aniso":  # test_tight_culling_parity_bound's load
        rng = np.random.default_rng(5)
        n = 220
        xyz = jnp.asarray(rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32))
        scales = jnp.asarray(np.exp(rng.normal(-2.2, 0.8, (n, 2))).astype(np.float32))
        scales = scales.at[:, 0].mul(6.0)
        rot = jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32))
        cam = orbit_camera(H, W, radius=4.0)
    else:  # test_binning_expand_modes_identical's scene, or a denser one
        n, seed = (900, 3) if name == "n900" else (2600, 8)
        raw = random_scene(n, seed=seed)
        xyz, rot = jnp.asarray(raw["xyz"]), jnp.asarray(raw["rotation"])
        scales = jnp.exp(jnp.asarray(raw["scaling"]))
        cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3)
    return preprocess(xyz, scales, rot, cam.world_view, cam.full_proj, cam.camera_center,
                      H, W, colors=jnp.zeros((n, 3)))


BASE = dict(max_tiles_per_gaussian=16, tile_depth=256, chunk=16)
# (scene, switches): kernel mode and tight culling at each scene's capacity
BIN_CASES = [
    ("n900", dict(max_instances=4096, expand_mode="kernel")),
    ("n900", dict(max_instances=4096, tight_culling=True)),
    ("aniso", dict(max_instances=8192, expand_mode="kernel")),
    ("aniso", dict(max_instances=8192, tight_culling=True)),
    ("n2600", dict(max_instances=4096, expand_mode="kernel")),
    ("n2600", dict(max_instances=4096, tight_culling=True)),
    ("n2600", dict(max_instances=8192, max_columns=4096, tight_culling=True)),
    ("n900", dict(max_instances=5000, expand_mode="kernel", tight_culling=True)),
]


@pytest.fixture(scope="module")
def binned():
    preps = {name: _scene_prep(name) for name in ("n900", "aniso", "n2600")}
    out = {}
    for k, (name, sw) in enumerate(BIN_CASES):
        cfg = RasterConfig(**BASE, **sw, backend="pallas")
        want = jax.jit(lambda p, _c=cfg: j_bin(p, H, W, _c, aligned=True))(preps[name])
        tprep = Preprocessed(*(_t(getattr(preps[name], f)) for f in Preprocessed._fields))
        got = t_bin(tprep, H, W, tcfg.RasterConfig(**BASE, **sw))
        out[k] = (want, got)
    return out


@pytest.mark.parametrize("case", range(len(BIN_CASES)),
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in sw.items())}"
                              for n, sw in BIN_CASES])
def test_bin_gaussians_run_decode_matches_jax(binned, case):
    want, got = binned[case]
    for f in Binned._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    n_inst = int(got.num_instances)
    assert n_inst > 0
    name, sw = BIN_CASES[case]
    if name == "n2600":  # overflowing instances or columns report >= the capacity
        assert n_inst >= sw["max_instances"]


def test_tight_culling_culls_and_scan_equals_gather(binned):
    kernel, tight = binned[0][1], binned[1][1]
    assert int(tight.num_instances) < int(kernel.num_instances)
    # a Gaussian's run [seg_start, seg_end) holds its tight instances and
    # dummy rows, not its rect area: the runs tile the emitted slots
    t_len, k_len = tight.seg_end - tight.seg_start, kernel.seg_end - kernel.seg_start
    assert int(t_len.sum()) == int(tight.num_instances)
    assert bool((t_len < k_len).any())
    prep = _scene_prep("aniso")
    tprep = Preprocessed(*(_t(getattr(prep, f)) for f in Preprocessed._fields))
    # expand_mode="scan" bins exactly as "gather"
    scan = t_bin(tprep, H, W, tcfg.RasterConfig(**BASE, max_instances=8192, expand_mode="scan"))
    gather = t_bin(tprep, H, W, tcfg.RasterConfig(**BASE, max_instances=8192))
    for f in scan._fields:
        assert torch.equal(getattr(scan, f), getattr(gather, f)), f


def _segments(rng, n, p):
    lens = rng.integers(0, 7, p)  # empty runs included
    gaps = rng.integers(0, 3, p) * (rng.uniform(size=p) < 0.3)
    starts = np.cumsum(lens + gaps) - lens
    starts = np.minimum(starts, n).astype(np.int32)
    ends = np.minimum(starts + lens, n).astype(np.int32)
    return starts, ends


@pytest.mark.parametrize("F", [19, 32])
def test_segment_sum_rows_matches_jax(F):
    rng = np.random.default_rng(F)
    n, p = 3000, 700
    rows = rng.normal(size=(n, F)).astype(np.float32)
    starts, ends = _segments(rng, n, p)
    want = np.asarray(jsr.segment_sum_rows(jnp.asarray(rows), jnp.asarray(starts),
                                           jnp.asarray(ends)))
    got = tsr.segment_sum_rows(_t(rows), _t(starts), _t(ends)).numpy()
    assert got.shape == want.shape == (p, F)
    scale = np.abs(want).max(0)
    assert (np.abs(got - want) <= 1e-6 * scale).all(), np.abs(got - want).max()
    assert not got[starts == ends].any()
    # the same sums as the feature-major segment_sum_ranges
    by_ranges = tsr.segment_sum_ranges(_t(rows.T.copy()), _t(starts), _t(ends)).numpy().T
    np.testing.assert_array_equal(got, by_ranges)


def test_tight_binning_at_bench_size():
    """Tight binning at 1088x1920 on the bench cloud (bench.py:22, drawn at
    100k surfels as chip_smoke.py draws it) from the bench view, production
    switches: the port's binning of the JAX package's jitted preprocess
    output is exact, and so is the port's whole preprocess + binning
    against the JAX package's jitted preprocess + binning, the camera passed
    as an argument as its trainer passes it (343,575 instances)."""
    from tpu_splat.raster.config import production_config as j_production
    from tpu_splat_torch.raster.preprocess import preprocess as t_preprocess

    Hb, Wb, n = 1088, 1920, 100_000
    rng = np.random.default_rng(0)
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    log_s = (-4.8 + 0.5 * rng.normal(size=(n, 2))).astype(np.float32)
    rot = (np.stack([np.ones(n), 0.4 * np.sin(1.3 * xyz[:, 0]), 0.4 * np.cos(1.1 * xyz[:, 1]),
                     0.4 * np.sin(0.9 * xyz[:, 2])], axis=1)
           + 0.05 * rng.normal(size=(n, 4))).astype(np.float32)
    rng.uniform(0, 1, (n, 3))  # the cloud's colours (unused here)
    opa = 1.0 / (1.0 + np.exp(-rng.uniform(-1, 2, n).astype(np.float64)))
    scales = np.exp(log_s.astype(np.float64)).astype(np.float32)  # one exp for both packages
    opa = opa.astype(np.float32)
    cam = orbit_camera(Hb, Wb, radius=6.0, azimuth=0.4, elevation=0.3)
    kw = dict(max_tiles_per_gaussian=32, max_instances=401_408, tile_depth=2048, chunk=32,
              tight_culling=True)
    pre_kw = dict(colors=jnp.zeros((n, 3)), opacity=jnp.asarray(opa))
    j_jit = jax.jit(lambda x, s, r, wv, fp, cc: preprocess(x, s, r, wv, fp, cc, Hb, Wb, **pre_kw))(
        xyz, scales, rot, cam.world_view, cam.full_proj, cam.camera_center)
    jcfg = j_production(backend="pallas", **kw)
    want = jax.jit(lambda p: j_bin(p, Hb, Wb, jcfg, aligned=True))(j_jit)
    tc = tcfg.production_config(**kw)
    got_on_jit = t_bin(Preprocessed(*(_t(getattr(j_jit, f)) for f in Preprocessed._fields)),
                       Hb, Wb, tc)
    tcam = {k: _t(getattr(cam, k)) for k in ("world_view", "full_proj", "camera_center")}
    tprep = t_preprocess(_t(xyz), _t(scales), _t(rot), tcam["world_view"], tcam["full_proj"],
                         tcam["camera_center"], Hb, Wb, colors=torch.zeros((n, 3)),
                         opacity=_t(opa))
    for f in ("hom", "xy", "depth", "rect_min", "rect_max", "tiles_touched", "valid"):
        np.testing.assert_array_equal(getattr(tprep, f).numpy(), np.asarray(getattr(j_jit, f)),
                                      err_msg=f)
    got = t_bin(tprep, Hb, Wb, tc)
    for f in Binned._fields:
        np.testing.assert_array_equal(getattr(got_on_jit, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.num_instances) == 343_575
