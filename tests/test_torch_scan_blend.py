"""tpu_splat_torch scan blend (backend="xla"), its dense binning layout and
expand_mode="scan" against the JAX package, on the CPU.

The same numpy-seeded scenes (activations computed once in numpy, so both
packages get the same float32 inputs) go through both packages at 48x48;
the JAX side runs its own XLA scan blend (backend="xla"), jitted. Each JAX
reference is computed once per module.

Tolerances:
- binning: every integer field exact (the dense `[T, tile_depth]` layout
  with its per-tile truncation, and the aligned layout under "scan");
- rasterize / render_fast images (tests/test_pallas.py's): colour, T and
  refl 2e-5 absolute and 1e-4 relative; the other allmap channels 5e-5 and
  1e-3; gaussian_weights 2e-5; n_contrib at most 8 flips per 4096 pixels
  (the T < 1e-4 knife edge, PARITY.md D4); radii and diagnostics exact;
- gradients: 1e-3 of each leaf's max |g|; in the training step, the rows of
  Gaussians seen nearly edge-on (tests/test_torch_train.py:_edge_on, at
  most 1 in 40) 1e-2: autograd through the scan's cross products loses
  digits in proportion to 1/|det hom| (one such row differs by 3.8e-3);
- render_fast and the training step's render: at most 8 pixels per 4096
  beyond the image tolerance (the knife edge; tests/test_torch_train.py);
- the port's scan blend against its own tile-kernel path: the same image
  tolerances; in float64 against its brute-force oracle: 1e-9 absolute and
  n_contrib exact (no knife edge is that close).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.config import OptimizationParams
from tpu_splat.data import orbit_camera, random_scene
from tpu_splat.isp import ppisp as jisp
from tpu_splat.raster import rasterize as j_rasterize
from tpu_splat.raster.binning import bin_gaussians as j_bin
from tpu_splat.raster.config import RasterConfig, production_config
from tpu_splat.raster.preprocess import preprocess as j_preprocess
from tpu_splat.renderer import render_fast as j_render_fast
from tpu_splat.train.step import make_train_step

import tpu_splat_torch.raster.config as tcfg
from tpu_splat_torch.config import OptimizationParams as TOptimizationParams
from tpu_splat_torch.isp import ppisp as tisp
from tpu_splat_torch.model.convert import camera_from_numpy, train_state_from_numpy
from tpu_splat_torch.raster import rasterize as t_rasterize
from tpu_splat_torch.raster.binning import bin_gaussians as t_bin
from tpu_splat_torch.raster.blend import blend as t_blend
from tpu_splat_torch.raster.bruteforce import blend_bruteforce as t_bruteforce
from tpu_splat_torch.raster.preprocess import Preprocessed, preprocess as t_preprocess
from tpu_splat_torch.renderer import render_fast as t_render_fast
from tpu_splat_torch.train.step import make_train_step as t_make_train_step

from tests.test_torch_train import (
    ISP_CFG,
    _camera_arrays,
    _edge_on,
    _jax_train_state,
    _scene as _train_scene,
    _ts_to_numpy,
)

H = W = 48
N = 200
KW = dict(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256, chunk=16)
BG = np.array([0.15, 0.25, 0.35], np.float32)
GRAD_ARGS = ("means3d", "scales", "rotations", "opacity", "refl", "sh")
FLIPS_PER_4096 = 8


def _sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(np.float32)


def _act(n, seed):
    raw = random_scene(n, seed=seed)
    return dict(
        means3d=raw["xyz"], scales=np.exp(raw["scaling"].astype(np.float64)).astype(np.float32),
        rotations=raw["rotation"], opacity=_sigmoid(raw["opacity"][:, 0]),
        refl=_sigmoid(raw["refl"][:, 0]), sh=raw["sh"],
    )


def _cams(az=0.4, el=0.3):
    cam = orbit_camera(H, W, radius=4.0, azimuth=az, elevation=el)
    return cam, camera_from_numpy(_camera_arrays(cam), device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_prep(act, cam):
    return jax.jit(lambda x, s, r: j_preprocess(x, s, r, cam.world_view, cam.full_proj,
                                                cam.camera_center, H, W,
                                                colors=jnp.zeros((x.shape[0], 3))))(
        act["means3d"], act["scales"], act["rotations"])


def _as_port_prep(p):
    return Preprocessed(*(_t(getattr(p, f)) for f in Preprocessed._fields))


def _assert_images(a, b, tag=""):
    """a, b: (color, final_T, refl_map, others, n_contrib[, gw]) numpy."""
    np.testing.assert_allclose(b[0], a[0], atol=2e-5, rtol=1e-4, err_msg=tag + "color")
    np.testing.assert_allclose(b[1], a[1], atol=2e-5, rtol=1e-4, err_msg=tag + "final_T")
    np.testing.assert_allclose(b[2], a[2], atol=2e-5, rtol=1e-4, err_msg=tag + "refl_map")
    np.testing.assert_allclose(b[3], a[3], atol=5e-5, rtol=1e-3, err_msg=tag + "others")
    flips = int((np.asarray(a[4]) != np.asarray(b[4])).sum())
    assert flips <= FLIPS_PER_4096 * a[4].size / 4096, (tag, flips)
    if len(a) > 5:
        np.testing.assert_allclose(b[5], a[5], atol=2e-5, err_msg=tag + "gaussian_weights")


def _images(out):
    return tuple(np.asarray(x.detach() if isinstance(x, torch.Tensor) else x) for x in (
        out.color, out.final_T, out.refl_map, out.others, out.n_contrib, out.gaussian_weights))


# -- binning: the dense layout and expand_mode="scan" ---------------------------

DENSE_CASES = {
    "gather": dict(KW),
    "scan": dict(KW, expand_mode="scan"),
    "kernel": dict(KW, expand_mode="kernel"),
    "gather-truncated": dict(KW, tile_depth=32),
    "scan-truncated-overflow": dict(KW, tile_depth=32, expand_mode="scan", max_instances=512),
}


@pytest.fixture(scope="module")
def dense():
    act = _act(N, 5)
    cam, _ = _cams()
    prep = _jax_prep(act, cam)
    out = {}
    for name, kw in DENSE_CASES.items():
        want = jax.jit(lambda p, _c=RasterConfig(**kw): j_bin(p, H, W, _c, aligned=False))(prep)
        out[name] = (want, t_bin(_as_port_prep(prep), H, W, tcfg.RasterConfig(**kw),
                                 aligned=False))
    return out


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_binning_matches_jax(dense, name):
    want, got = dense[name]
    for f in ("tile_gid", "tile_mask", "tile_counts", "sorted_gid", "tile_starts",
              "num_instances", "max_area", "pad_overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.tile_gid.shape == (tcfg.tile_grid(H, W)[0] * tcfg.tile_grid(H, W)[1],
                                  DENSE_CASES[name]["tile_depth"])
    if "truncated" in name:  # some tile holds more than tile_depth instances
        assert int(got.tile_counts.max()) > DENSE_CASES[name]["tile_depth"]
        depth = DENSE_CASES[name]["tile_depth"]
        assert bool((got.tile_mask.sum(1) == got.tile_counts.clamp(max=depth)).all())
    if "overflow" in name:
        assert int(got.num_instances) > DENSE_CASES[name]["max_instances"]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "dense"])
def test_scan_expansion_matches_gather_and_jax(aligned):
    """tests/test_raster.py:test_binning_expand_modes_identical's scene of
    900 Gaussians; it bins 2548 instances, so the capacity here is 2048
    and the truncated tail is compared too."""
    act = _act(900, 3)
    cam, _ = _cams()
    prep = _jax_prep(act, cam)
    cfg = dict(KW, max_instances=2048)
    want = jax.jit(lambda p: j_bin(p, H, W, RasterConfig(**cfg, expand_mode="scan"),
                                   aligned=aligned))(prep)
    tp = _as_port_prep(prep)
    got = t_bin(tp, H, W, tcfg.RasterConfig(**cfg, expand_mode="scan"), aligned=aligned)
    gather = t_bin(tp, H, W, tcfg.RasterConfig(**cfg), aligned=aligned)
    assert int(got.num_instances) > cfg["max_instances"]
    for f in got._fields:
        a = getattr(got, f).numpy()
        np.testing.assert_array_equal(a, getattr(gather, f).numpy(), err_msg=f"gather {f}")
        np.testing.assert_array_equal(a, np.asarray(getattr(want, f)), err_msg=f"jax {f}")


# -- the scan blend -------------------------------------------------------------

def _loss_weights():
    rng = np.random.default_rng(11)
    return dict(color=rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
                others=rng.uniform(-1, 1, (H, W, 8)).astype(np.float32),
                refl=rng.uniform(-1, 1, (H, W)).astype(np.float32),
                T=rng.uniform(-1, 1, (H, W)).astype(np.float32))


def _loss(out, w, xp):
    """A loss that reads every differentiable output channel."""
    s = xp.sum
    return (s(out.color * w["color"]) + s(out.others * w["others"])
            + s(out.refl_map * w["refl"]) + s(out.final_T * w["T"]))


@pytest.fixture(scope="module")
def scan():
    act = _act(N, 7)
    jcam, tcam = _cams()
    w = _loss_weights()
    cfg = dict(KW, backend="xla")

    def jloss(*a):
        out = j_rasterize(*a[:5], jcam, jnp.asarray(BG), RasterConfig(**cfg), sh=a[5],
                          sh_degree=1)
        return _loss(out, {k: jnp.asarray(v) for k, v in w.items()}, jnp), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True))(
        *(act[k] for k in GRAD_ARGS))
    targs = {k: _t(act[k]).requires_grad_() for k in GRAD_ARGS}

    def trun(c, **kw):
        return t_rasterize(*(targs[k] for k in GRAD_ARGS[:5]), tcam, _t(BG), c,
                           sh=targs["sh"], sh_degree=1, **kw)

    tout = trun(tcfg.RasterConfig(**cfg))
    tg = torch.autograd.grad(_loss(tout, {k: _t(v) for k, v in w.items()}, torch),
                             list(targs.values()))
    kout = trun(tcfg.RasterConfig(**KW))
    return dict(jout=jout, jg=[np.asarray(g) for g in jg], tout=tout,
                tg=[g.numpy() for g in tg], kout=kout, act=act, tcam=tcam)


def test_scan_blend_images_match_jax(scan):
    jout, tout = scan["jout"], scan["tout"]
    _assert_images(_images(jout), _images(tout))
    for f in ("radii", "num_instances", "max_area", "tile_counts", "pad_overflow"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                      err_msg=f)
    assert float(np.asarray(jout.others[..., 1]).max()) > 0.5  # the frame is not empty
    assert float(np.asarray(jout.gaussian_weights).max()) > 0.0


@pytest.mark.parametrize("i", range(len(GRAD_ARGS)), ids=GRAD_ARGS)
def test_scan_blend_gradients_match_jax(scan, i):
    want, got = scan["jg"][i], scan["tg"][i]
    scale = np.abs(want).max()
    assert scale > 0.0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=0, err_msg=GRAD_ARGS[i])


def test_scan_blend_matches_kernel_path(scan):
    """tests/test_pallas.py:test_pallas_matches_xla on the port: the scan
    blend against the tile kernels' plain versions."""
    _assert_images(_images(scan["tout"]), _images(scan["kout"]))


def test_scan_blend_collect_weights_off(scan):
    act, tcam = scan["act"], scan["tcam"]
    with torch.no_grad():
        out = t_rasterize(*(_t(act[k]) for k in GRAD_ARGS[:5]), tcam, _t(BG),
                          tcfg.RasterConfig(**KW, backend="xla"), sh=_t(act["sh"]),
                          sh_degree=1, collect_weights=False)
    assert not out.gaussian_weights.any()
    np.testing.assert_array_equal(out.color.numpy(), scan["tout"].color.detach().numpy())


def test_scan_blend_float64_matches_bruteforce():
    """The scan blend's dtype follows its inputs: on a float64 copy of the
    preprocess it equals the brute-force oracle's walk of every Gaussian in
    depth order."""
    act = _act(60, 9)
    _, tcam = _cams(az=1.0, el=0.2)
    a = {k: _t(v) for k, v in act.items()}
    prep = t_preprocess(a["means3d"], a["scales"], a["rotations"], tcam.world_view,
                        tcam.full_proj, tcam.camera_center, H, W, sh=a["sh"], sh_degree=1)
    p64 = prep._replace(**{f: getattr(prep, f).double() for f in
                           ("hom", "xy", "depth", "normal_view", "color")})
    cfg = tcfg.RasterConfig(**KW, backend="xla")
    binned = t_bin(prep, H, W, cfg, aligned=False)
    scope = torch.ones(60, dtype=torch.bool)
    opa, refl, bg = a["opacity"].double(), a["refl"].double(), _t(BG).double()
    out = t_blend(binned.tile_gid, binned.tile_mask, p64.hom, p64.xy, opa, p64.normal_view,
                  p64.color, refl, scope, bg, H, W, cfg)
    bf = t_bruteforce(p64, opa, refl, scope, bg, H, W)
    assert out.color.dtype == torch.float64
    for name, x, y in zip(("color", "others", "refl", "T"), bf[:4],
                          (out.color, out.others, out.refl_map, out.final_T)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(out.n_contrib.numpy(), bf[4].numpy())
    assert float(out.others[..., 1].max()) > 0.5


# -- render_fast and one training step under backend="xla" ----------------------

def test_render_fast_xla_matches_jax():
    d = _train_scene()
    jts = _jax_train_state(d)
    jcam, tcam = _cams()
    jc, tc = production_config(backend="xla", **KW), tcfg.production_config(backend="xla", **KW)
    a = jax.jit(lambda g: j_render_fast(g, jcam, jc, jnp.asarray(BG)))(jts.gaussians)
    ts = train_state_from_numpy(_ts_to_numpy(jts), device="cpu")
    b = t_render_fast(ts.gaussians, tcam, tc, _t(BG))
    for f in ("render", "alpha", "refl_strength"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        bad = (np.abs(y - x) > 2e-5 + 1e-4 * np.abs(x)).any(-1)
        assert bad.sum() <= FLIPS_PER_4096 * bad.size / 4096, (f, int(bad.sum()))
    for f in ("radii", "num_instances", "max_tile_count"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), f)


def test_train_step_xla_matches_jax():
    d = _train_scene()
    jts = _jax_train_state(d).replace(step=jnp.asarray(600, jnp.int32))
    jcam, tcam = _cams()
    gt = np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32)
    jc, tc = production_config(backend="xla", **KW), tcfg.production_config(backend="xla", **KW)
    jstep = make_train_step(OptimizationParams(), jc, 1.0, isp_cfg=jisp.ISPConfig(**ISP_CFG))
    params = {**jts.gaussians.param_pytree(),
              **{f"isp_{k}": v for k, v in jts.isp._asdict().items()}}
    n = d["xyz"].shape[0]
    (loss, (jout, *_)), (jg, jgso) = jax.jit(jax.value_and_grad(
        jstep._loss_fn, argnums=(0, 1), has_aux=True))(
        params, jnp.zeros((n, 2)), jts.gaussians, jcam, jnp.asarray(gt), None,
        jnp.asarray(BG), jnp.asarray(False), jnp.asarray(1, jnp.int32), jnp.asarray(False))
    ts = train_state_from_numpy(_ts_to_numpy(jts), device="cpu")
    tstep = t_make_train_step(TOptimizationParams(), tc, 1.0, isp_cfg=tisp.ISPConfig(**ISP_CFG))
    _, aux = tstep(ts, tcam, _t(gt), _t(BG), frame_idx=1)
    assert abs(float(aux.loss) - float(loss)) <= 1e-5 * abs(float(loss))
    assert int(aux.max_tile_count) == int(jout.max_tile_count)
    bad = (np.abs(aux.render.numpy() - np.asarray(jout.render)) > 2e-5).any(-1)
    assert bad.sum() <= FLIPS_PER_4096 * bad.size / 4096, int(bad.sum())
    want = {k: np.asarray(v) for k, v in jg.items()}
    want["screen_offset"] = np.asarray(jgso)
    ill = _edge_on(dict(jts=jts, tcam=tcam))
    assert ill.sum() <= n / 40
    for k, w_ in want.items():
        err = np.abs(aux.grads[k].numpy() - w_)
        scale = np.abs(w_).max()
        if err.shape[:1] == (n,):
            assert err[ill].max(initial=0.0) <= 1e-2 * scale, (k, "edge-on")
            err = err[~ill]
        assert err.max() <= 1e-3 * scale + 1e-30, (k, float(err.max()), float(scale))
