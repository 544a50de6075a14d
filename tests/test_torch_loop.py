"""tpu_splat_torch training loop (slice 3) vs the JAX package, on the CPU.

The scheduled events (model/ops.py, model/densify.py:densify_and_prune,
train/loop.py:run_scheduled_events), capacity growth (train/grow.py), the
cubemap resize and sharpen, and one training step with tight culling, each
against the JAX function on identical inputs carried across as numpy arrays
(tpu_splat_torch/model/convert.py). The JAX draws (the split children's
normals, the sabotage noise), computed from the JAX key the test tracks,
are handed to the port: jax.random's bits are not reproduced. The JAX side
runs its Pallas kernels in interpret mode (backend="pallas"). Every JAX step
reference is computed once per module.

Tolerances:
- resize_cubemap: 1e-6 of the texture's max |value| (the weights are summed
  in another order); sharpen_cubemap: 1e-6 absolute in activated (sigmoid)
  space, the logits within 2e-6 of their max (the logit of a value clamped
  at 1 - 1e-3 lifts an ulp of sigmoid or log by up to ~1000);
- the event ops, densify_and_prune and every event of the loop: the alive
  set, the counts, the event log and the pulsed opacity rate exactly;
  parameters, Adam moments and densify statistics within 1e-6 of each
  leaf's max |value| (sigmoid, exp and log round apart by an ulp);
- check_growth: decisions, reasons and padded shapes exactly, padded rows
  exactly;
- the tight training step: slice 2's (tests/test_torch_train.py): losses
  1e-5 relative; render within 2e-5 except at most 8 pixels per 4096;
  gradients 1e-3 of the leaf's max under exact f32 (the edge-on rows 1.5e-3)
  and 1e-2 under the production bf16 switches.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.config import OptimizationParams
from tpu_splat.data import orbit_camera, random_scene
from tpu_splat.envmap import cubemap as jcm
from tpu_splat.isp import ppisp as jisp
from tpu_splat.model import ops as jops
from tpu_splat.model import optim as jopt
from tpu_splat.model.densify import DensifyStats, add_stats, densify_and_prune as j_densify
from tpu_splat.model.state import GaussianState
from tpu_splat.raster.config import production_config
from tpu_splat.train import grow as jgrow
from tpu_splat.train import loop as jloop
from tpu_splat.train.step import TrainState, make_train_step

import tpu_splat_torch.raster.config as tcfg
from tpu_splat_torch.config import OptimizationParams as TOptimizationParams
from tpu_splat_torch.envmap import cubemap as tcm
from tpu_splat_torch.isp import ppisp as tisp
from tpu_splat_torch.model import ops as tops
from tpu_splat_torch.model.convert import (
    camera_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from tpu_splat_torch.model.densify import densify_and_prune as t_densify
from tpu_splat_torch.train import grow as tgrow
from tpu_splat_torch.train import loop as tloop
from tpu_splat_torch.train.step import make_train_step as t_make_train_step

H = W = 48
N = 120
CAP = 128
KW = dict(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256, chunk=16,
          tight_culling=True)
BG = [0.1, 0.2, 0.3]
FRAME = 1
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl")
STATS = ("grad_accum", "denom", "accum_w", "denom_w", "max_radii")
ISP_CFG = dict(controller_activation_ratio=0.875)


def _scene():
    raw = random_scene(N, seed=3, sh_degree=1)
    rng = np.random.default_rng(3)

    def pad(a, fill=0.0):
        out = np.full((CAP,) + a.shape[1:], fill, np.float32)
        out[:N] = a
        return out

    rot = pad(raw["rotation"])
    rot[N:, 0] = 1.0
    scaling = raw["scaling"].copy()
    scaling[:6, 1] = scaling[:6, 0]  # equal axes: reset_scale keeps the first
    return dict(
        xyz=pad(raw["xyz"]), features_dc=pad(raw["sh"][:, :1]), features_rest=pad(raw["sh"][:, 1:]),
        scaling=pad(scaling, -10.0), rotation=rot, opacity=pad(raw["opacity"], -10.0),
        refl=pad(raw["refl"] + 3.0, -10.0),
        texture=rng.uniform(-0.5, 0.5, (6, 3, 8, 8)).astype(np.float32),
        fail_value=rng.uniform(-0.5, 0.5, 3).astype(np.float32),
        alive=np.arange(CAP) < N - 5,
        active_sh_degree=1, max_sh_degree=1,
    )


def _jax_ts(d, key):
    """A JAX TrainState from the numpy form train_state_to_numpy gives."""
    gd = d["gaussians"]
    g = GaussianState(
        **{k: jnp.asarray(gd[k]) for k in LEAVES + ("alive",)},
        env=jcm.CubemapParams(jnp.asarray(gd["texture"]), jnp.asarray(gd["fail_value"])),
        active_sh_degree=jnp.asarray(gd["active_sh_degree"], jnp.int32),
        max_sh_degree=gd["max_sh_degree"],
    )
    isp = None if d["isp"] is None else jisp.ISPParams(
        **{k: jnp.asarray(v) for k, v in d["isp"].items()})
    return TrainState(
        gaussians=g,
        opt=jopt.AdamState({k: jnp.asarray(v) for k, v in d["mu"].items()},
                           {k: jnp.asarray(v) for k, v in d["nu"].items()},
                           jnp.asarray(d["count"], jnp.int32)),
        stats=DensifyStats(*(jnp.asarray(d["stats"][k]) for k in STATS)),
        step=jnp.asarray(d["step"], jnp.int32),
        opacity_lr=jnp.asarray(d["opacity_lr"], jnp.float32),
        key=key, isp=isp,
    )


def _jax_to_numpy(ts):
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
        isp=None if ts.isp is None else {k: np.asarray(v) for k, v in ts.isp._asdict().items()},
        step=int(ts.step), opacity_lr=float(ts.opacity_lr),
    )


def _start_state(seed=0):
    """A port TrainState past a few steps: random moments and statistics."""
    rng = np.random.default_rng(seed)
    d = dict(gaussians=_scene(), count=7, step=600, opacity_lr=0.05,
             isp={k: np.asarray(v) for k, v in jisp.init_isp(2)._asdict().items()})
    params = {**{k: d["gaussians"][k] for k in LEAVES},
              "env_texture": d["gaussians"]["texture"], "env_fail": d["gaussians"]["fail_value"],
              **{f"isp_{k}": v for k, v in d["isp"].items()}}
    d["mu"] = {k: (1e-3 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
    d["nu"] = {k: (1e-6 * rng.uniform(size=v.shape)).astype(np.float32) for k, v in params.items()}
    alive = d["gaussians"]["alive"]
    d["stats"] = {
        "grad_accum": np.where(alive, rng.uniform(0, 4e-3, CAP), 0).astype(np.float32),
        "denom": np.where(alive, rng.integers(0, 6, CAP), 0).astype(np.float32),
        "accum_w": np.where(alive, rng.uniform(0, 2, CAP), 0).astype(np.float32),
        "denom_w": np.where(alive, rng.integers(0, 4, CAP), 0).astype(np.float32),
        "max_radii": np.where(alive, rng.uniform(0, 9, CAP), 0).astype(np.float32),
    }
    return d


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale + 1e-30, err_msg=what)


def _assert_states_match(t, j, label):
    """A port TrainState (numpy form) against a JAX one (numpy form)."""
    tg, jg = t["gaussians"], j["gaussians"]
    np.testing.assert_array_equal(tg["alive"], jg["alive"], err_msg=f"{label}: alive")
    for k in LEAVES + ("texture", "fail_value"):
        _close(tg[k], jg[k], f"{label}: {k}")
    for m in ("mu", "nu"):
        assert set(t[m]) == set(j[m]), label
        for k in j[m]:
            _close(t[m][k], j[m][k], f"{label}: {m}[{k}]")
    for k in STATS:
        _close(t["stats"][k], j["stats"][k], f"{label}: stats.{k}")
    assert np.float32(t["opacity_lr"]) == np.float32(j["opacity_lr"]), label


# -- the cubemap resize and sharpen ---------------------------------------

def test_resize_and_sharpen_cubemap_match_jax():
    rng = np.random.default_rng(2)
    tex = rng.normal(size=(6, 3, 8, 8)).astype(np.float32)
    fail = rng.normal(size=3).astype(np.float32)
    jp = jcm.CubemapParams(jnp.asarray(tex), jnp.asarray(fail))
    tp = tcm.CubemapParams(torch.from_numpy(tex), torch.from_numpy(fail))
    up_j, up_t = jcm.resize_cubemap(jp, 16), tcm.resize_cubemap(tp, 16)
    _close(up_t.texture.numpy(), up_j.texture, "resized texture")
    sh_j, sh_t = jcm.sharpen_cubemap(jp), tcm.sharpen_cubemap(tp)
    # the sharpened texture is a logit of values clamped to [1e-3, 1 - 1e-3],
    # whose condition number (up to ~1000) lifts an ulp of the two packages'
    # sigmoid and log: 1e-6 absolute in activated space, where it is used,
    # and the logits within 2e-6 of their max
    act = lambda t: 1.0 / (1.0 + np.exp(-np.asarray(t, np.float64)))
    got, want = sh_t.texture.numpy(), np.asarray(sh_j.texture)
    assert np.abs(act(got) - act(want)).max() <= 1e-6
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    for p in (up_t, sh_t):
        np.testing.assert_array_equal(p.fail_value.numpy(), fail)
    assert tcm.resize_cubemap(tp, 16).texture.shape == (6, 3, 16, 16)


# -- the event ops ----------------------------------------------------------

def _ops_cases():
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.uniform(key, (CAP, 1, 3), minval=-0.4, maxval=0.4))
    m = np.random.default_rng(9).uniform(size=CAP) < 0.4
    return {
        "reset_refl": (lambda g, o: jops.reset_refl(g, o, 0.3, jnp.asarray(m)),
                       lambda g, o: tops.reset_refl(g, o, 0.3, torch.from_numpy(m))),
        "reset_opacity": (lambda g, o: jops.reset_opacity(g, o),
                          lambda g, o: tops.reset_opacity(g, o)),
        "raise_opacity": (lambda g, o: jops.raise_opacity(g, o, 0.9, jnp.asarray(m)),
                          lambda g, o: tops.raise_opacity(g, o, 0.9, torch.from_numpy(m))),
        "dist_color": (lambda g, o: jops.dist_color(g, o, key, exclusive_msk=jnp.asarray(m)),
                       lambda g, o: tops.dist_color(g, o, torch.from_numpy(noise),
                                                    exclusive_msk=torch.from_numpy(m))),
        "reset_scale": (lambda g, o: jops.reset_scale(g, o, 1.5, jnp.asarray(m)),
                        lambda g, o: tops.reset_scale(g, o, 1.5, torch.from_numpy(m))),
        "double_env_map": (jops.double_env_map, tops.double_env_map),
        "filter_env_map": (jops.filter_env_map, tops.filter_env_map),
    }


@pytest.mark.parametrize("op", list(_ops_cases()))
def test_event_op_matches_jax(op):
    j_op, t_op = _ops_cases()[op]
    d = _start_state()
    jts = _jax_ts(d, jax.random.PRNGKey(0))
    tts = train_state_from_numpy(d, device="cpu")
    jg, jo = j_op(jts.gaussians, jts.opt)
    tg, to = t_op(tts.gaussians, tts.opt)
    want = _jax_to_numpy(jts.replace(gaussians=jg, opt=jo))
    got = train_state_to_numpy(dataclasses.replace(tts, gaussians=tg, opt=to))
    _assert_states_match(got, want, op)
    if op == "reset_scale":  # tied axes keep the first as the smallest
        assert (got["gaussians"]["scaling"][:6, 0] == d["gaussians"]["scaling"][:6, 0]).all()


# -- densify_and_prune --------------------------------------------------------

@pytest.mark.parametrize("size_prune", [False, True])
def test_densify_and_prune_matches_jax(size_prune):
    d = _start_state(1)
    d["gaussians"]["scaling"][100:104] = np.log(2.0)  # world-size pruning candidates
    jts = _jax_ts(d, None)
    tts = train_state_from_numpy(d, device="cpu")
    key = jax.random.PRNGKey(11)
    eps = np.asarray(jax.random.normal(key, (2, CAP, 2)))
    # extent 15: clone below 0.15, split above, prune above 1.5 (rows 100-103)
    kw = dict(grad_threshold=2e-4, percent_dense=0.01, extent=15.0, size_prune=size_prune)
    mean = np.array([0.1, -0.2, 0.05], np.float32)
    a = j_densify(jts.gaussians, jts.opt, jts.stats, key, cameras_mean=jnp.asarray(mean), **kw)
    b = t_densify(tts.gaussians, tts.opt, tts.stats, torch.from_numpy(eps),
                  cameras_mean=torch.from_numpy(mean), **kw)
    for f in ("n_cloned", "n_split", "n_pruned", "overflow"):
        assert int(getattr(a, f)) == int(getattr(b, f)), f
    assert int(a.n_cloned) > 0 and int(a.n_split) > 0 and int(a.n_pruned) > 0
    assert int(a.overflow) > 0  # the 128 rows fill: candidates are dropped
    want = _jax_to_numpy(jts.replace(gaussians=a.state, opt=a.opt_state, stats=a.stats))
    got = train_state_to_numpy(dataclasses.replace(tts, gaussians=b.state, opt=b.opt_state,
                                                   stats=b.stats))
    _assert_states_match(got, want, "densify")
    new = got["gaussians"]["alive"] & ~(d["gaussians"]["alive"] & (
        got["gaussians"]["xyz"] == d["gaussians"]["xyz"]).all(-1))
    assert new.any()
    for k in LEAVES:  # new rows start from zero moments
        assert not got["mu"][k][new].any() and not got["nu"][k][new].any(), k


# -- check_growth -------------------------------------------------------------

@pytest.mark.parametrize("diag", [
    dict(n_alive=100, num_instances=1000, max_tile_count=40, densify_overflow=0),
    dict(n_alive=120, num_instances=1000, max_tile_count=40, densify_overflow=0),
    dict(n_alive=50, num_instances=3900, max_tile_count=900, densify_overflow=3),
    dict(n_alive=50, num_instances=4000, max_tile_count=40, densify_overflow=0, pad_overflow=2),
    # the scan blend (backend="xla"): a tile past tile_depth grows it
    dict(n_alive=100, num_instances=1000, max_tile_count=300, densify_overflow=0,
         backend="xla"),
    dict(n_alive=120, num_instances=3900, max_tile_count=1000, densify_overflow=0,
         backend="xla"),
    dict(n_alive=100, num_instances=1000, max_tile_count=256, densify_overflow=0,
         backend="xla"),
], ids=["none", "rows", "rows-instances-columns", "instances-pads", "scan-tile_depth",
        "scan-rows-instances-tile_depth", "scan-tile_depth-full"])
def test_check_growth_matches_jax(diag):
    diag = dict(diag)
    backend = diag.pop("backend", "pallas")
    d = _start_state(2)
    jts = _jax_ts(d, jax.random.PRNGKey(0))
    tts = train_state_from_numpy(d, device="cpu")
    cols = 4096 if diag["num_instances"] == 3900 else 0
    sw = dict(KW, max_columns=cols, backend=backend)
    a = jgrow.check_growth(jts, production_config(**sw), **diag)
    b = tgrow.check_growth(tts, tcfg.production_config(**sw), **diag)
    if backend == "xla":
        assert ("tile_depth" in " ".join(b.reasons)) == (diag["max_tile_count"] > KW["tile_depth"])
    assert (a.grew, a.reasons) == (b.grew, b.reasons)
    for f in ("max_instances", "max_columns", "pad_per_tile", "tile_depth"):
        assert getattr(a.cfg, f) == getattr(b.cfg, f), f
    want, got = _jax_to_numpy(a.ts), train_state_to_numpy(b.ts)
    for k in LEAVES + ("alive",):
        np.testing.assert_array_equal(got["gaussians"][k], want["gaussians"][k], err_msg=k)
    for m in ("mu", "nu"):
        for k in want[m]:
            np.testing.assert_array_equal(got[m][k], want[m][k], err_msg=f"{m}[{k}]")
    for k in STATS:
        np.testing.assert_array_equal(got["stats"][k], want["stats"][k], err_msg=k)


# -- one tight training step --------------------------------------------------

def _camera_arrays(cam):
    d = {k: np.asarray(getattr(cam, k))
         for k in ("world_view", "proj", "full_proj", "camera_center", "K")}
    d.update({k: getattr(cam, k) for k in ("height", "width", "fovx", "fovy", "znear", "zfar")})
    return d


SWITCHES = {"production": {}, "exact": dict(bf16_grads=False, bf16_feats=False)}
GRAD_TOL = {"production": 1e-2, "exact": 1e-3}
EDGE_ON_TOL = {"production": 1e-2, "exact": 1.5e-3}


@pytest.fixture(scope="module")
def setup():
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3)
    gt = np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32)
    return dict(jcam=cam, tcam=camera_from_numpy(_camera_arrays(cam), device="cpu"), gt=gt)


def _step_state():
    """tests/test_torch_train.py's step state: its scene (no capacity
    padding), fresh moments and statistics, a perturbed ISP."""
    raw = random_scene(N, seed=3, sh_degree=1)
    rng = np.random.default_rng(3)
    d = dict(
        xyz=raw["xyz"], features_dc=raw["sh"][:, :1], features_rest=raw["sh"][:, 1:],
        scaling=raw["scaling"], rotation=raw["rotation"], opacity=raw["opacity"],
        refl=raw["refl"] + 3.0,
        texture=rng.uniform(-0.5, 0.5, (6, 3, 8, 8)).astype(np.float32),
        fail_value=rng.uniform(-0.5, 0.5, 3).astype(np.float32),
        alive=np.arange(N) < N - 5, active_sh_degree=1, max_sh_degree=1,
    )
    g = GaussianState(
        **{k: jnp.asarray(d[k]) for k in LEAVES + ("alive",)},
        env=jcm.CubemapParams(jnp.asarray(d["texture"]), jnp.asarray(d["fail_value"])),
        active_sh_degree=jnp.asarray(1, jnp.int32), max_sh_degree=1,
    )
    ts = TrainState.create(g, OptimizationParams(), seed=0, num_frames=2)
    rng = np.random.default_rng(9)
    isp = ts.isp._replace(**{
        k: v + jnp.asarray(0.05 * rng.normal(size=v.shape).astype(np.float32))
        for k, v in ts.isp._asdict().items()
    })
    return _jax_to_numpy(ts.replace(isp=isp, step=jnp.asarray(600, jnp.int32)))


@pytest.fixture(scope="module")
def tight_steps(setup):
    """Per switch set: the JAX step's loss, gradients and add_stats (its
    loss function jitted, as tests/test_torch_train.py runs it) and one port
    step, from the same state, with tight culling on."""
    out = {}
    d = _step_state()
    jbg = jnp.asarray(BG)
    for name, sw in SWITCHES.items():
        jts = _jax_ts(d, jax.random.PRNGKey(0))
        jstep = make_train_step(OptimizationParams(), production_config(
            backend="pallas", **sw, **KW), 1.0, isp_cfg=jisp.ISPConfig(**ISP_CFG))
        params = {**jts.gaussians.param_pytree(),
                  **{f"isp_{k}": v for k, v in jts.isp._asdict().items()}}
        (loss, (jout, *_)), (jg, jgso) = jax.jit(jax.value_and_grad(
            jstep._loss_fn, argnums=(0, 1), has_aux=True
        ))(params, jnp.zeros((N, 2)), jts.gaussians, setup["jcam"], jnp.asarray(setup["gt"]),
           None, jbg, jnp.asarray(False), jnp.asarray(FRAME, jnp.int32), jnp.asarray(False))
        jstats = add_stats(jts.stats, jgso, jout.visibility, jout.gaussian_weights, jout.radii)
        jg = {k: np.asarray(v) for k, v in jg.items()}
        jg["screen_offset"] = np.asarray(jgso)
        tts = train_state_from_numpy(d, device="cpu")
        tstep = t_make_train_step(TOptimizationParams(), tcfg.production_config(**sw, **KW), 1.0,
                                  isp_cfg=tisp.ISPConfig(**ISP_CFG))
        tnew, taux = tstep(tts, setup["tcam"], torch.from_numpy(setup["gt"]), torch.tensor(BG),
                           frame_idx=FRAME)
        out[name] = dict(loss=float(loss), jout=jout, jg=jg, jstats=jstats, tnew=tnew, taux=taux)
    return out


def _edge_on(setup, d):
    """Gaussians seen nearly edge-on (tests/test_torch_train.py:_edge_on)."""
    from tpu_splat_torch.raster.preprocess import preprocess as t_preprocess

    ts = train_state_from_numpy(d, device="cpu").gaussians
    c = setup["tcam"]
    hom = t_preprocess(ts.xyz, ts.get_scaling(), ts.rotation, c.world_view, c.full_proj,
                       c.camera_center, H, W, colors=torch.zeros((ts.capacity, 3))).hom.double().numpy()
    ratio = np.abs(np.linalg.det(hom)) / np.prod(np.linalg.norm(hom, axis=-1), axis=-1)
    return ratio < 2.0**-24 / 1e-3


@pytest.mark.parametrize("name", list(SWITCHES))
def test_tight_step_matches_jax(tight_steps, setup, name):
    s = tight_steps[name]
    taux, jout = s["taux"], s["jout"]
    assert abs(float(taux.loss) - s["loss"]) <= 1e-5 * abs(s["loss"])
    # the port's preprocess rounds as the jitted JAX step: the same instances
    assert int(taux.num_instances) == int(jout.num_instances)
    a, b = np.asarray(jout.render), taux.render.numpy()
    bad = np.abs(a - b).max(-1) > 2e-5
    assert bad.sum() <= 8 * bad.size / 4096, int(bad.sum())
    ill = _edge_on(setup, _step_state())
    assert ill.sum() <= N / 40, np.nonzero(ill)
    for k, want in s["jg"].items():
        got = taux.grads[k].numpy()
        scale = np.abs(want).max()
        err = np.abs(got - want)
        if scale == 0.0:
            assert err.max() == 0.0, k
            continue
        if k in LEAVES or k == "screen_offset":
            assert err[ill].max(initial=0.0) <= EDGE_ON_TOL[name] * scale, k
            err = err[~ill]
        assert err.max() <= GRAD_TOL[name] * scale, (k, float(err.max() / scale))
    tstats = train_state_to_numpy(s["tnew"])["stats"]
    for f in ("denom", "denom_w", "max_radii"):
        np.testing.assert_array_equal(tstats[f], np.asarray(getattr(s["jstats"], f)), err_msg=f)


# -- a short loop over the scheduled events ----------------------------------

# small intervals: the events' "- 500" offsets are the JAX package's
LOOP_OPT = dict(init_until_iter=2, densify_from_iter=2, densification_interval=3,
                densification_interval_when_prop=3, opacity_reset_interval=7,
                densify_until_iter=9, opac_lr0_interval=2, normal_prop_interval=4,
                normal_prop_until_iter=20, color_sabotage_interval=5,
                color_sabotage_until_iter=20, densify_grad_threshold=2e-5)
LOOP_ITERS = 10
# iteration -> what fires there under LOOP_OPT (JAX train/loop.py)
LOOP_EVENTS = {3: "densify", 4: "normal_prop", 5: "color_sabotage", 6: "densify",
               7: "reset_opacity", 8: "normal_prop", 9: "double_env_map", 10: "color_sabotage"}
# the opacity-LR pulse: even iterations in (init_until_iter, densify_until_iter)
LOOP_PULSES = [4, 6, 8]


def _jax_keyed_draws(state):
    """The port's draws as the JAX loop takes them from its key."""
    def draw(name, shape):
        state["key"], sub = jax.random.split(state["key"])
        if name == "densify_eps":
            return torch.from_numpy(np.asarray(jax.random.normal(sub, shape)))
        return torch.from_numpy(np.asarray(
            jax.random.uniform(sub, shape, minval=-0.4, maxval=0.4)))
    return draw


def test_loop_events_match_jax(setup):
    """Port steps and events over LOOP_ITERS iterations; at every iteration
    the JAX events (and growth) run on the port's state before them and the
    two results agree."""
    jopt_cfg = OptimizationParams(**LOOP_OPT)
    topt_cfg = TOptimizationParams(**LOOP_OPT)
    d = _start_state()
    d["step"] = 0
    ts = train_state_from_numpy(d, device="cpu")
    cfg = tcfg.production_config(**KW)
    jcfg = production_config(backend="pallas", **KW)
    step = t_make_train_step(topt_cfg, cfg, 1.0, isp_cfg=tisp.ISPConfig(**ISP_CFG))
    gt, bg = torch.from_numpy(setup["gt"]), torch.tensor(BG)
    extent, mean = 1.6, np.array([0.0, 0.1, 0.0], np.float32)
    key = {"key": jax.random.PRNGKey(7)}
    jlog, tlog = jloop.EventLog(), tloop.EventLog()
    fired = {}
    for it in range(1, LOOP_ITERS + 1):
        ts, aux = step(ts, setup["tcam"], gt, bg, frame_idx=FRAME)
        before = train_state_to_numpy(ts)
        jts = _jax_ts(before, key["key"])
        densified = (jlog.densified, jlog.pruned)
        jts = jloop.run_scheduled_events(jts, it, jopt_cfg, extent, mean, log=jlog)
        ts = tloop.run_scheduled_events(ts, it, topt_cfg, extent, mean, log=tlog,
                                        draws=_jax_keyed_draws(key))
        assert np.array_equal(np.asarray(jts.key), np.asarray(key["key"])), it
        # the port's log also records the opacity-LR pulse; the rest is JAX's
        got_log = dataclasses.asdict(tlog)
        got_log["events"] = [e for e in got_log["events"] if e[1] != "opacity_lr_pulse"]
        assert got_log == dataclasses.asdict(jlog), it
        _assert_states_match(train_state_to_numpy(ts), _jax_to_numpy(jts), f"iteration {it}")
        names = [e for i, e in tlog.events if i == it]
        if (jlog.densified, jlog.pruned) != densified:
            names.append("densify")
        fired[it] = names
        # growth after every iteration (the trainer checks after a densify
        # overflow and every 100 iterations)
        diag = dict(n_alive=int(aux.n_alive), num_instances=int(aux.num_instances),
                    max_tile_count=int(aux.max_tile_count), densify_overflow=0,
                    pad_overflow=int(aux.pad_overflow))
        a = jgrow.check_growth(jts, jcfg, **diag)
        b = tgrow.check_growth(ts, cfg, **diag)
        assert (a.grew, a.reasons) == (b.grew, b.reasons), it
        if b.grew:
            ts, cfg, jcfg = b.ts, b.cfg, a.cfg
            step = t_make_train_step(topt_cfg, cfg, 1.0, isp_cfg=tisp.ISPConfig(**ISP_CFG))
            _assert_states_match(train_state_to_numpy(ts), _jax_to_numpy(a.ts), f"growth {it}")
            fired[it].append("growth")
    for it, name in LOOP_EVENTS.items():
        assert name in fired[it], (it, fired)
    assert [i for i, e in tlog.events if e == "opacity_lr_pulse"] == LOOP_PULSES, tlog.events
    assert any("growth" in v for v in fired.values()), fired
    assert ts.gaussians.env.resolution == 16 and ts.gaussians.capacity > CAP
    assert np.isfinite(float(aux.loss))
