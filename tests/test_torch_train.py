"""tpu_splat_torch training step vs the JAX package, on the CPU.

One training step of each package from the same carried-across
`TrainState` (tpu_splat_torch/model/convert.py), under the production switch
set (bf16 gradient regroup and content rows) and the exact-f32 one, in the
deferred-reflection stage and (production) in the initial stage. The port
runs its `make_train_step`; the JAX side the loss function of its
`make_train_step`, then its `adam_step` and `add_stats`. The JAX side runs
its Pallas kernels in interpret mode (backend="pallas"); the port runs its
plain kernel versions. Every JAX reference is computed once per module.

Tolerances:
- loss, l1, ssim, normal_loss: 1e-5 relative;
- render and surf_normal images: 2e-5 absolute, except at most 8 pixels per
  4096 (the alpha / T knife edge, PARITY.md D4);
- every parameter gradient and the screen_offset gradient: 1e-3 of the
  leaf's max |g| under exact f32; 1e-2 under the production bf16 switches
  (each per-instance gradient is rounded to bf16 before the per-Gaussian
  sum, so a last-bit difference in it can move the sum by 2^-8 relative;
  the JAX package's own bf16-vs-exact test allows 2e-2). Under exact f32
  the rows of Gaussians seen nearly edge-on, whose homography is near
  singular (at most 1 in 40; see _edge_on), are held to 1.5e-3: one such
  row differs by 1.2e-3 of the rotation gradient's max;
- Adam mu / nu: the gradient tolerances (twice them for nu, which squares
  g); the step's parameters are not compared (Adam's first update is
  lr * sign(g), which a rounding-level difference in a tiny g flips);
- DensifyStats: 1e-3 of each field's max, radii and counts exactly;
- the learning-rate schedule: exact against the JAX step's;
- normalize: bit-exact against jnp.linalg.norm on 1e5 quaternions;
  init_from_pcd (but the cubemap draw) and the moment surgery: exact;
- ssim, apply_isp, isp_regularization, adam_step fed with the JAX
  package's gradients: 1e-6 relative; the SSIM map 1e-5 absolute (XLA and
  PyTorch sum the 11x11 window in another order, and the map subtracts
  E[x]^2 from E[x^2], which lifts that rounding to ~6e-6 of a value near 1).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.config import OptimizationParams
from tpu_splat.core.transforms import normalize as j_normalize
from tpu_splat.data import orbit_camera, random_scene
from tpu_splat.envmap.cubemap import CubemapParams
from tpu_splat.isp import ppisp as jisp
from tpu_splat.model import optim as jopt
from tpu_splat.model.densify import add_stats
from tpu_splat.model.state import GaussianState, init_from_pcd
from tpu_splat.raster.config import production_config
from tpu_splat.train import losses as jlosses
from tpu_splat.train.step import TrainState, make_train_step

import tpu_splat_torch.raster.config as tcfg
from tpu_splat_torch.config import OptimizationParams as TOptimizationParams
from tpu_splat_torch.core.transforms import normalize as t_normalize
from tpu_splat_torch.isp import ppisp as tisp
from tpu_splat_torch.model import optim as topt
from tpu_splat_torch.model.convert import (
    camera_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from tpu_splat_torch.model.state import init_from_pcd as t_init_from_pcd
from tpu_splat_torch.train import losses as tlosses
from tpu_splat_torch.train.step import make_train_step as t_make_train_step

H = W = 48
N = 120
KW = dict(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256, chunk=16)
BG = [0.1, 0.2, 0.3]
FRAME = 1
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl")
SWITCHES = {
    "production": {},
    "exact": dict(bf16_grads=False, bf16_feats=False),
}
CASES = [("production", False), ("exact", False), ("production", True)]
GRAD_TOL = {"production": 1e-2, "exact": 1e-3}
EDGE_ON_TOL = {"production": 1e-2, "exact": 1.5e-3}
ISP_CFG = dict(controller_activation_ratio=0.875)


def _scene():
    raw = random_scene(N, seed=3, sh_degree=1)
    rng = np.random.default_rng(3)
    return dict(
        xyz=raw["xyz"], features_dc=raw["sh"][:, :1], features_rest=raw["sh"][:, 1:],
        scaling=raw["scaling"], rotation=raw["rotation"], opacity=raw["opacity"],
        refl=raw["refl"] + 3.0,  # reflective enough to move the env map
        texture=rng.uniform(-0.5, 0.5, (6, 3, 8, 8)).astype(np.float32),
        fail_value=rng.uniform(-0.5, 0.5, 3).astype(np.float32),
        alive=np.arange(N) < N - 5,
        active_sh_degree=1, max_sh_degree=1,
    )


def _jax_train_state(d):
    g = GaussianState(
        **{k: jnp.asarray(d[k]) for k in LEAVES + ("alive",)},
        env=CubemapParams(jnp.asarray(d["texture"]), jnp.asarray(d["fail_value"])),
        active_sh_degree=jnp.asarray(d["active_sh_degree"], jnp.int32),
        max_sh_degree=d["max_sh_degree"],
    )
    ts = TrainState.create(g, OptimizationParams(), seed=0, num_frames=2)
    # a non-identity ISP, so every ISP path carries a gradient
    rng = np.random.default_rng(9)
    isp = ts.isp._replace(**{
        k: v + jnp.asarray(0.05 * rng.normal(size=v.shape).astype(np.float32))
        for k, v in ts.isp._asdict().items()
    })
    return ts.replace(isp=isp)


def _ts_to_numpy(ts):
    g = ts.gaussians
    gd = {k: np.asarray(getattr(g, k)) for k in LEAVES + ("alive",)}
    gd.update(texture=np.asarray(g.env.texture), fail_value=np.asarray(g.env.fail_value),
              active_sh_degree=int(g.active_sh_degree), max_sh_degree=g.max_sh_degree)
    return dict(
        gaussians=gd,
        mu={k: np.asarray(v) for k, v in ts.opt.mu.items()},
        nu={k: np.asarray(v) for k, v in ts.opt.nu.items()},
        count=int(ts.opt.count),
        stats={k: np.asarray(v) for k, v in ts.stats._asdict().items()},
        isp={k: np.asarray(v) for k, v in ts.isp._asdict().items()},
        step=int(ts.step), opacity_lr=float(ts.opacity_lr),
    )


def _camera_arrays(cam):
    d = {k: np.asarray(getattr(cam, k))
         for k in ("world_view", "proj", "full_proj", "camera_center", "K")}
    d.update({k: getattr(cam, k) for k in ("height", "width", "fovx", "fovy", "znear", "zfar")})
    return d


@pytest.fixture(scope="module")
def setup():
    d = _scene()
    jts = _jax_train_state(d)
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3)
    gt = np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32)
    return dict(jts=jts, jcam=cam, tcam=camera_from_numpy(_camera_arrays(cam), device="cpu"),
                gt=gt)


@pytest.fixture(scope="module")
def steps(setup):
    """Per case, on the JAX side: the loss and its gradients in the
    parameters and the screen_offset probe, from the loss function of the
    package's `make_train_step` (jitted: eager dispatch compiles every op
    on its own and takes minutes here), then the package's `adam_step` and
    `add_stats` on them, as its train step applies them. On the port's side:
    one `make_train_step` call from the same state."""
    out = {}
    jbg, tbg = jnp.asarray(BG), torch.tensor(BG)
    for name, initial in CASES:
        jcfg = production_config(backend="pallas", **SWITCHES[name], **KW)
        tc = tcfg.production_config(**SWITCHES[name], **KW)
        jts = setup["jts"].replace(step=jnp.asarray(0 if initial else 600, jnp.int32))
        jstep = make_train_step(OptimizationParams(), jcfg, 1.0,
                                isp_cfg=jisp.ISPConfig(**ISP_CFG))
        params = {**jts.gaussians.param_pytree(),
                  **{f"isp_{k}": v for k, v in jts.isp._asdict().items()}}
        so = jnp.zeros((N, 2))
        (loss, (jout, l1, ssim_v, normal_loss, _)), (jg, jgso) = jax.jit(jax.value_and_grad(
            jstep._loss_fn, argnums=(0, 1), has_aux=True
        ))(params, so, jts.gaussians, setup["jcam"], jnp.asarray(setup["gt"]), None, jbg,
           jnp.asarray(initial), jnp.asarray(FRAME, jnp.int32), jnp.asarray(False))
        _, jopt_new = jopt.adam_step(params, jg, jts.opt,
                                     jopt.default_lrs(OptimizationParams(), 1.0))
        jstats = add_stats(jts.stats, jgso, jout.visibility, jout.gaussian_weights, jout.radii)
        jaux = dict(loss=loss, l1=l1, ssim=ssim_v, normal_loss=normal_loss,
                    num_instances=jout.num_instances, max_tile_count=jout.max_tile_count,
                    pad_overflow=jout.pad_overflow)
        jnew = dict(opt=jopt_new, stats=jstats)
        jg = {k: np.asarray(v) for k, v in jg.items()}
        jg["screen_offset"] = np.asarray(jgso)

        tts = train_state_from_numpy(_ts_to_numpy(jts), device="cpu")
        tstep = t_make_train_step(TOptimizationParams(), tc, 1.0,
                                  isp_cfg=tisp.ISPConfig(**ISP_CFG))
        tnew, taux = tstep(tts, setup["tcam"], torch.from_numpy(setup["gt"]), tbg,
                           frame_idx=FRAME)
        out[name, initial] = dict(jnew=jnew, jaux=jaux, jg=jg, jout=jout, tnew=tnew, taux=taux)
    return out


@pytest.mark.parametrize("name,initial", CASES)
def test_step_losses_match_jax(steps, name, initial):
    s = steps[name, initial]
    for f in ("loss", "l1", "ssim", "normal_loss"):
        a, b = float(s["jaux"][f]), float(getattr(s["taux"], f))
        assert abs(a - b) <= 1e-5 * abs(a), (f, a, b)
    for f in ("num_instances", "max_tile_count", "pad_overflow"):
        assert int(s["jaux"][f]) == int(getattr(s["taux"], f)), f
    assert int(s["taux"].n_alive) == N - 5


@pytest.mark.parametrize("name,initial", CASES)
def test_step_images_match_jax(steps, name, initial):
    s = steps[name, initial]
    for f in ("render", "surf_normal"):
        a = np.asarray(getattr(s["jout"], f))
        b = getattr(s["taux"], f).numpy()
        bad = np.abs(a - b).max(-1) > 2e-5
        assert bad.sum() <= 8 * bad.size / 4096, (f, int(bad.sum()), float(np.abs(a - b).max()))
    assert float(np.asarray(s["jout"].alpha).max()) > 0.5  # the frame is not empty


def _edge_on(setup):
    """[N] bool: Gaussians seen nearly edge-on, whose splat-to-pixel
    homography is near singular: |det| below 2^-24 / 1e-3 of the product of
    its row norms. The backward's cross-product VJPs then lose digits in
    proportion, so float32 rounding of the homography (which the two
    packages round apart) moves their gradients by more than 1e-3; they are
    held to EDGE_ON_TOL."""
    from tpu_splat_torch.raster.preprocess import preprocess as t_preprocess

    ts = train_state_from_numpy(_ts_to_numpy(setup["jts"]), device="cpu").gaussians
    c = setup["tcam"]
    hom = t_preprocess(ts.xyz, ts.get_scaling(), ts.rotation, c.world_view, c.full_proj,
                       c.camera_center, H, W, colors=torch.zeros((N, 3))).hom.double().numpy()
    ratio = np.abs(np.linalg.det(hom)) / np.prod(np.linalg.norm(hom, axis=-1), axis=-1)
    return ratio < 2.0**-24 / 1e-3


def _gaussian_rows(k):
    return k in LEAVES or k == "screen_offset"


@pytest.mark.parametrize("name,initial", CASES)
def test_step_gradients_match_jax(steps, setup, name, initial):
    s = steps[name, initial]
    tol = GRAD_TOL[name]
    ill = _edge_on(setup)
    assert ill.sum() <= N / 40, np.nonzero(ill)
    over, edge_on = {}, {}
    for k, want in s["jg"].items():
        got = s["taux"].grads[k].numpy()
        assert got.shape == want.shape, k
        scale = np.abs(want).max()
        err = np.abs(got - want)
        if scale == 0.0:
            # the env map in the initial stage; the fail value (no pixel
            # reflects a zero direction); dead rows
            assert err.max() == 0.0, k
            continue
        if _gaussian_rows(k):
            edge = err[ill].max(initial=0.0)
            assert edge <= EDGE_ON_TOL[name] * scale, (k, "edge-on", float(edge / scale))
            edge_on[k] = float(f"{edge / scale:.3g}")
            err_ok = err[~ill]
        else:
            err_ok = err
        assert err_ok.max() <= tol * scale, (k, float(err_ok.max()), float(scale))
        over[k] = int((err > 1e-3 * scale).sum())
    print(f"{name} initial={initial}: edge-on Gaussians {np.nonzero(ill)[0].tolist()}, "
          "their largest error over the leaf's max:", edge_on, "entries beyond 1e-3 of max:",
          over)


@pytest.mark.parametrize("name,initial", CASES)
def test_step_adam_and_stats_match_jax(steps, setup, name, initial):
    s = steps[name, initial]
    jnew, tnew = s["jnew"], train_state_to_numpy(s["tnew"])
    ok = ~_edge_on(setup)
    assert tnew["step"] == (1 if initial else 601)
    assert tnew["count"] == int(jnew["opt"].count) == 1
    for moments, tm in ((jnew["opt"].mu, tnew["mu"]), (jnew["opt"].nu, tnew["nu"])):
        for k, want in moments.items():
            want, got = np.asarray(want), tm[k]
            scale = np.abs(want).max()
            # nu = (1 - b2) g^2 doubles g's relative error
            twice = 2.0 if moments is jnew["opt"].nu else 1.0
            tol = GRAD_TOL[name] * twice
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=EDGE_ON_TOL[name] * twice * scale + 1e-30, err_msg=k)
            if _gaussian_rows(k):
                got, want = got[ok], want[ok]
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale + 1e-30, err_msg=k)
    for f in ("grad_accum", "accum_w"):
        want, got = np.asarray(getattr(jnew["stats"], f)), tnew["stats"][f]
        scale = np.abs(want).max()
        # grad_accum is the screen_offset gradient's norm: edge-on rows at
        # EDGE_ON_TOL
        np.testing.assert_allclose(got, want, rtol=0, atol=EDGE_ON_TOL[name] * scale,
                                   err_msg=f)
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-3 * scale, err_msg=f)
    for f in ("denom", "denom_w", "max_radii"):
        np.testing.assert_array_equal(tnew["stats"][f], np.asarray(getattr(jnew["stats"], f)),
                                      err_msg=f)
    assert tnew["gaussians"]["active_sh_degree"] == 1


# across the xyz decay (30,000 steps), the freeze of xyz and rotation (after
# step 30,000) and SH-degree bump steps
SCHEDULE_STEPS = (1, 600, 7_000, 8_000, 15_000, 29_999, 30_000, 30_001, 35_000, 40_000)


def _jax_learning_rates(jstep):
    """The rates of the JAX step (tpu_splat/train/step.py:245-257) from its
    `_schedules`, jitted with a traced step as its training loop runs it."""
    base_lrs, xyz_sched, freeze_xyz_from = jstep._schedules

    @jax.jit
    def lrs_of(step, opacity_lr, frozen):
        lrs = dict(base_lrs)
        lrs["xyz"] = xyz_sched(step)
        lrs["opacity"] = opacity_lr
        frozen_xyz = step > freeze_xyz_from
        lrs["xyz"] = jnp.where(frozen_xyz, 0.0, lrs["xyz"])
        lrs["rotation"] = jnp.where(frozen_xyz, 0.0, base_lrs["rotation"])
        lrs = {k: jnp.where(frozen, 0.0, jnp.asarray(v, jnp.float32)) for k, v in lrs.items()}
        lrs["isp"] = jnp.asarray(base_lrs["isp"], jnp.float32)
        return lrs

    return lambda step, opacity_lr, frozen: {
        k: float(v) for k, v in lrs_of(jnp.asarray(step, jnp.int32),
                                       jnp.asarray(opacity_lr, jnp.float32),
                                       jnp.asarray(frozen)).items()}


@pytest.mark.parametrize("frozen", [False, True], ids=["training", "frozen"])
def test_learning_rates_match_jax(frozen):
    """The port step's schedule against the JAX step's, exactly, at a
    spatial scale of 2.5 and for the default and a pulsed opacity rate."""
    jstep = make_train_step(OptimizationParams(), production_config(backend="pallas", **KW),
                            2.5, isp_cfg=jisp.ISPConfig(**ISP_CFG))
    tstep = t_make_train_step(TOptimizationParams(), tcfg.production_config(**KW), 2.5,
                              isp_cfg=tisp.ISPConfig(**ISP_CFG))
    want_of = _jax_learning_rates(jstep)
    xyz = []
    for step in SCHEDULE_STEPS:
        for opacity_lr in (0.05, 0.6):
            opacity_lr = float(np.float32(opacity_lr))
            want = want_of(step, opacity_lr, frozen)
            assert tstep.learning_rates(step, opacity_lr, frozen) == want, (step, opacity_lr)
        xyz.append(want["xyz"])
    if frozen:
        assert set(want) == {"xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation",
                             "refl", "env", "isp"}
        assert all(v == 0.0 for k, v in want.items() if k != "isp") and want["isp"] > 0.0
    else:  # the cases span the decay and the freeze
        assert xyz[0] > xyz[4] > xyz[6] > 0.0 and xyz[7] == 0.0


@pytest.mark.parametrize("start,frozen", [(7_999, False), (7_999, True), (30_000, False)],
                         ids=["sh-bump", "scene-frozen", "xyz-frozen"])
def test_port_step_applies_its_schedule(setup, start, frozen):
    """One port step applies `learning_rates`: a leaf moves exactly when its
    group's rate and its gradient are nonzero (the ISP trains while the
    scene is frozen), and the SH degree follows the JAX step's bump
    (tpu_splat/train/step.py:265-272) from degree 0 of 1."""
    d = _ts_to_numpy(setup["jts"])
    d["step"] = start
    d["gaussians"]["active_sh_degree"] = 0
    ts = train_state_from_numpy(d, device="cpu")
    step = t_make_train_step(TOptimizationParams(), tcfg.production_config(**KW), 1.0,
                             isp_cfg=tisp.ISPConfig(**ISP_CFG))
    isp_leaves = lambda isp: {f"isp_{k}": v for k, v in isp._asdict().items()}
    before = {**ts.gaussians.param_pytree(), **isp_leaves(ts.isp)}
    new, aux = step(ts, setup["tcam"], torch.from_numpy(setup["gt"]), torch.tensor(BG),
                    frozen=frozen, frame_idx=FRAME)
    lrs = step.learning_rates(start + 1, ts.opacity_lr, frozen)
    after = {**new.gaussians.param_pytree(), **isp_leaves(new.isp)}
    moved = {k: not torch.equal(v, after[k]) for k, v in before.items()}
    want = {k: lrs[topt.param_group(k)] > 0.0 and bool(aux.grads[k].abs().max() > 0.0)
            for k in before}
    assert moved == want
    assert moved["isp_gain"] and moved["opacity"] != frozen
    assert moved["xyz"] == moved["rotation"] == (not frozen and start < 30_000)
    n = start + 1
    bump = n > TOptimizationParams().feature_rest_from_iter and n % 1000 == 0 and not frozen
    assert new.gaussians.active_sh_degree == min(int(bump), 1)


def test_normalize_bits_match_jax():
    rng = np.random.default_rng(0)
    q = (rng.normal(size=(100_000, 4)) * rng.uniform(0.1, 3.0, (100_000, 1))).astype(np.float32)
    want = np.asarray(j_normalize(jnp.asarray(q)))
    got = t_normalize(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_ssim_value_and_map_match_jax():
    # a rendering against a noisy copy (SSIM ~0.9: the value is not a small
    # difference of large terms)
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (40, 52, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    for ret_map, atol in ((False, 0.0), (True, 1e-5)):
        want = np.asarray(jlosses.ssim(jnp.asarray(a), jnp.asarray(b), return_map=ret_map))
        got = tlosses.ssim(torch.from_numpy(a), torch.from_numpy(b), return_map=ret_map).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)


def _isp_params(rng):
    p = jisp.init_isp(3, num_cameras=2)
    return p._replace(**{k: v + jnp.asarray(0.1 * rng.normal(size=v.shape).astype(np.float32))
                         for k, v in p._asdict().items()})


@pytest.mark.parametrize("frame,controller", [(2, False), (-1, False), (1, True)],
                         ids=["known", "unknown", "controller"])
def test_apply_isp_matches_jax(frame, controller):
    rng = np.random.default_rng(6)
    jp = _isp_params(rng)
    tp = tisp.ISPParams(**{k: torch.from_numpy(np.array(v)) for k, v in jp._asdict().items()})
    rgb = rng.uniform(-0.1, 1.0, (24, 36, 3)).astype(np.float32)
    rgb[0, :4] = 0.0  # exactly-zero pixels
    want = np.asarray(jisp.apply_isp(jp, jnp.asarray(rgb), frame, use_controller=controller,
                                     camera_idx=1))
    got = tisp.apply_isp(tp, torch.from_numpy(rgb), frame, use_controller=controller,
                         camera_idx=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    cfg = jisp.ISPConfig()
    a = float(jisp.isp_regularization(jp, cfg))
    b = float(tisp.isp_regularization(tp, tisp.ISPConfig()))
    assert abs(a - b) <= 1e-6 * abs(a)


def test_isp_gradient_finite_where_the_gamma_slope_is_infinite():
    """A pre-gamma value exactly 0 with gamma < 1 (x ** gamma's slope is
    infinite there): the JAX package's gradient is not finite; the port's
    takes that value's gradient as 0, and equals the JAX gradient taken
    without it."""
    rng = np.random.default_rng(8)
    rgb = rng.uniform(0.1, 1.0, (6, 7, 3)).astype(np.float32)
    gain = (np.eye(3) + 0.05 * rng.normal(size=(3, 3))).astype(np.float32)
    bias = np.array([-0.02, 0.01, -0.03], np.float32)
    log_gamma = np.array([-0.2, 0.1, -0.3], np.float32)
    # two black pixels: channel 0 lands on 0 exactly, channel 2 clamps below
    rgb[0, :2] = 0.0
    bias[0] = 0.0
    w = rng.uniform(0.5, 1.5, rgb.shape).astype(np.float32)

    def jgrads(r, wt):
        return jax.grad(lambda *a: jnp.sum(wt * jisp._transform(*a)), argnums=(0, 1, 2, 3))(
            jnp.asarray(r), jnp.asarray(gain), jnp.asarray(bias), jnp.asarray(log_gamma))

    bad = jgrads(rgb, w)
    assert not all(bool(np.isfinite(np.asarray(g)).all()) for g in bad)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (rgb, gain, bias, log_gamma)]
    out = tisp._transform(*leaves)
    want_out = np.asarray(jisp._transform(*map(jnp.asarray, (rgb, gain, bias, log_gamma))))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-6,
                               atol=1e-6 * np.abs(want_out).max())
    got = torch.autograd.grad((torch.from_numpy(w) * out).sum(), leaves)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    # over the other pixels the JAX gradient; the parameters' gradients are
    # that plus the black pixels' own (finite) part
    keep = np.ones(rgb.shape[:2], bool)
    keep[0, :2] = False
    want = jgrads(rgb[keep][None], w[keep][None])
    np.testing.assert_allclose(got[0].numpy()[keep], np.asarray(want[0])[0], rtol=1e-6)
    black = [torch.from_numpy(rgb[~keep][None]).requires_grad_()] + [
        torch.from_numpy(x).requires_grad_() for x in (gain, bias, log_gamma)]
    part = torch.autograd.grad((torch.from_numpy(w[~keep][None]) * tisp._transform(*black)).sum(),
                               black)
    for g, wnt, p in zip(got[1:], want[1:], part[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt) + p.numpy(), rtol=1e-5, atol=1e-6)


def test_adam_step_matches_jax():
    rng = np.random.default_rng(12)
    shapes = {"xyz": (50, 3), "opacity": (50, 1), "env_texture": (6, 3, 4, 4), "isp_gain": (2, 3, 3)}
    arr = lambda s, k=1.0: (k * rng.normal(size=s)).astype(np.float32)
    params = {k: arr(s) for k, s in shapes.items()}
    grads = {k: arr(s, 1e-3) for k, s in shapes.items()}
    mu = {k: arr(s, 1e-4) for k, s in shapes.items()}
    nu = {k: np.abs(arr(s, 1e-7)) for k, s in shapes.items()}
    lrs = {"xyz": 1.6e-4, "opacity": 0.05, "env": 0.05, "isp": 1e-3}
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    jp, js = jopt.adam_step(j(params), j(grads), jopt.AdamState(j(mu), j(nu), jnp.asarray(6, jnp.int32)),
                            {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()})
    tp, ts = topt.adam_step(t(params), t(grads), topt.AdamState(t(mu), t(nu), 6), lrs)
    assert ts.count == int(js.count) == 7
    for a, b in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        for k in shapes:
            want = np.asarray(a[k])
            np.testing.assert_allclose(b[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)


def test_port_steps_lower_the_loss(setup):
    """12 port steps on the CPU lower the loss (as tests/test_train.py)."""
    d = _ts_to_numpy(setup["jts"])
    d["step"] = 600  # deferred-reflection stage
    ts = train_state_from_numpy(d, device="cpu")
    step = t_make_train_step(TOptimizationParams(), tcfg.production_config(**KW), 1.0,
                             isp_cfg=tisp.ISPConfig(**ISP_CFG))
    gt, bg = torch.from_numpy(setup["gt"]), torch.tensor(BG)
    losses = []
    for _ in range(12):
        ts, aux = step(ts, setup["tcam"], gt, bg, frame_idx=FRAME)
        losses.append(float(aux.loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_init_from_pcd_matches_jax():
    """Everything but the cubemap texture (jax.random's draw) exactly."""
    rng = np.random.default_rng(21)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    a = init_from_pcd(pts, cols, capacity=256, max_sh_degree=1, cubemap_resolution=8, seed=3)
    b = t_init_from_pcd(pts, cols, capacity=256, max_sh_degree=1, cubemap_resolution=8, seed=3,
                        device="cpu")
    for k in LEAVES + ("alive",):
        np.testing.assert_array_equal(getattr(b, k).numpy(), np.asarray(getattr(a, k)), err_msg=k)
    assert b.env.texture.shape == a.env.texture.shape
    assert float(b.env.texture.abs().max()) <= 0.5


def test_moment_surgery_matches_jax():
    rng = np.random.default_rng(22)
    mu = {"xyz": rng.normal(size=(10, 3)).astype(np.float32),
          "opacity": rng.normal(size=(10, 1)).astype(np.float32)}
    nu = {k: np.abs(v) for k, v in mu.items()}
    src = rng.integers(0, 10, 10).astype(np.int32)
    keep = rng.uniform(size=10) < 0.6
    ja = jopt.AdamState({k: jnp.asarray(v) for k, v in mu.items()},
                        {k: jnp.asarray(v) for k, v in nu.items()}, jnp.asarray(3, jnp.int32))
    ta = topt.AdamState({k: torch.from_numpy(v) for k, v in mu.items()},
                        {k: torch.from_numpy(v) for k, v in nu.items()}, 3)
    jr = jopt.reset_moments(jopt.remap_rows(ja, ["xyz"], jnp.asarray(src), jnp.asarray(keep)),
                            "opacity")
    tr = topt.reset_moments(topt.remap_rows(ta, ["xyz"], torch.from_numpy(src),
                                            torch.from_numpy(keep)), "opacity")
    for d_j, d_t in ((jr.mu, tr.mu), (jr.nu, tr.nu)):
        for k in mu:
            np.testing.assert_array_equal(d_t[k].numpy(), np.asarray(d_j[k]), err_msg=k)
