"""The port's convergence certificate (tpu_splat_torch/scripts/validate_e2e.py)
against the root validate_e2e.py and the JAX package, on the CPU, at the
E2E_SMOKE sizes (64x64, float32 switches, backend="pallas": the JAX kernels
in interpret mode, the port's plain kernel versions). Every JAX reference is
computed once, in the module fixture `jax_refs`.

Tolerances:
- the structured scene and its quaternions: exact; the recover task's
  jittered start: exact (the same numpy draws);
- the ground-truth render: colour 2e-5 absolute;
- three smoke `recover` iterations from the JAX start carried across
  (model/convert.py): the same view order, each loss within 1e-5 relative,
  every parameter afterwards within 1e-3 of its leaf's max (as
  tests/test_torch_train.py holds the step); no event draws are asked for;
- two `recover_vol` Adam steps (torch.optim.Adam against optax.adam): the
  losses 1e-5 relative, the leaves 1e-3 of each leaf's max; and on three
  fixed gradients, the two optimizers' parameters within 1e-6 of their max;
- the artifacts' keys: those of the JAX script's (VALID_r05_*.json), and
  `device` for recover_vol, whose JAX artifact does not name its device.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import validate_e2e as root
from tpu_splat.config import OptimizationParams as JOptimizationParams
from tpu_splat.core.transforms import quat_to_rotmat as j_quat_to_rotmat
from tpu_splat.model.state import GaussianState as JGaussianState
from tpu_splat.raster import rasterize as j_rasterize
from tpu_splat.raster.config import production_config as j_production_config
from tpu_splat.renderer import render as j_render
from tpu_splat.train import losses as jlosses
from tpu_splat.train.loop import EventLog as JEventLog
from tpu_splat.train.step import TrainState as JTrainState
from tpu_splat.train.step import make_train_step as j_make_train_step

from tpu_splat_torch.config import OptimizationParams
from tpu_splat_torch.model.convert import camera_from_numpy, state_from_numpy, state_to_numpy
from tpu_splat_torch.scripts import validate_e2e as tv
from tpu_splat_torch.train.loop import EventLog
from tpu_splat_torch.train.step import TrainState, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
STEPS = 3
VOL_STEPS = 2
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl")
VOL_KEYS = ("xyz", "scl", "rot", "opa", "col")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's spinning worker threads then take the cores from each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return j_production_config(max_tiles_per_gaussian=16, max_instances=1 << 14,
                               tile_depth=256, chunk=16, backend="pallas",
                               grad_channels="full", bf16_grads=False, bf16_feats=False)


def _cam_arrays(cam):
    d = {k: np.asarray(getattr(cam, k))
         for k in ("world_view", "proj", "full_proj", "camera_center", "K")}
    d.update({k: getattr(cam, k) for k in ("height", "width", "fovx", "fovy", "znear", "zfar")})
    return d


def _gaussians_np(g):
    d = {k: np.asarray(getattr(g, k)) for k in LEAVES + ("alive",)}
    d.update(texture=np.asarray(g.env.texture), fail_value=np.asarray(g.env.fail_value),
             active_sh_degree=int(g.active_sh_degree), max_sh_degree=g.max_sh_degree)
    return d


def _jax_recover_state(gt_state, n_gt):
    """The root script's recover start (validate_e2e.py:505-553), verbatim."""
    rng = np.random.default_rng(9)
    cap = 1 << int(np.ceil(np.log2(n_gt)))
    scale_sigma = np.exp(np.asarray(gt_state.scaling)).mean(axis=1, keepdims=True)

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n_gt] = np.asarray(a)
        return jnp.asarray(out)

    pert = dict(
        xyz=np.asarray(gt_state.xyz) + 0.5 * scale_sigma * rng.normal(size=(n_gt, 3)),
        features_dc=np.asarray(gt_state.features_dc) + 0.15 * rng.normal(size=(n_gt, 1, 3)),
        features_rest=np.asarray(gt_state.features_rest)
        + 0.05 * rng.normal(size=gt_state.features_rest.shape),
        scaling=np.asarray(gt_state.scaling) + 0.2 * rng.normal(size=(n_gt, 2)),
        rotation=np.asarray(gt_state.rotation) + 0.08 * rng.normal(size=(n_gt, 4)),
        opacity=np.asarray(gt_state.opacity) + 0.75 * rng.normal(size=(n_gt, 1)),
        refl=np.asarray(gt_state.refl) + 0.5 * rng.normal(size=(n_gt, 1)),
    )
    alive = np.zeros(cap, bool)
    alive[:n_gt] = True
    env_p = gt_state.env._replace(
        texture=gt_state.env.texture
        + 0.3 * jnp.asarray(rng.normal(size=gt_state.env.texture.shape), jnp.float32))
    return JGaussianState(
        xyz=pad(pert["xyz"]), features_dc=pad(pert["features_dc"]),
        features_rest=pad(pert["features_rest"]), scaling=pad(pert["scaling"], fill=-10.0),
        rotation=pad(pert["rotation"]).at[n_gt:, 0].set(1.0),
        opacity=pad(pert["opacity"], fill=-10.0), refl=pad(pert["refl"], fill=-10.0),
        env=env_p, alive=jnp.asarray(alive), active_sh_degree=jnp.asarray(3, np.int32),
        max_sh_degree=3)


def _jax_vol(cams):
    """The root script's recover_vol problem (validate_e2e.py:289-349) at the
    smoke size: (GT images, jittered leaves, normals, VOL_STEPS optax steps'
    losses and leaves, the views used)."""
    cfg = _jcfg()
    sc = root.make_structured_scene(True)
    n = len(sc["xyz"])
    scl3 = np.concatenate([sc["scaling"], sc["scaling"].mean(1, keepdims=True) + np.log(0.25)],
                          axis=1).astype(np.float32)
    normals = np.asarray(j_quat_to_rotmat(jnp.asarray(sc["rotation"])))[:, :, 2]
    gt = dict(xyz=sc["xyz"], scl=scl3, rot=sc["rotation"], opa=sc["opacity"][:, 0],
              col=sc["colors"], rfl=np.full((n,), -4.0, np.float32))
    bg = jnp.zeros(3)

    def render_vol(p, camera):
        return j_rasterize(p["xyz"], jnp.exp(p["scl"]), p["rot"], jax.nn.sigmoid(p["opa"]),
                           jax.nn.sigmoid(p["rfl"]), camera, bg, cfg, colors=p["col"],
                           mode="volumetric", normals=jnp.asarray(normals)).color

    views = tv.view_order(8, VOL_STEPS, 3)
    rj = jax.jit(render_vol)
    gts = {v: np.asarray(rj({k: jnp.asarray(a) for k, a in gt.items()}, cams[v])) for v in views}
    pert = tv.vol_perturb(gt, np.random.default_rng(13))
    params = {k: jnp.asarray(v) for k, v in pert.items()}
    tx = optax.multi_transform(
        {k: optax.adam(v) if v else optax.set_to_zero() for k, v in tv.VOL_LR.items()},
        {k: k for k in params})
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, camera, gt_img):
        def loss_fn(p):
            img = render_vol(p, camera)
            return 0.8 * jnp.mean(jnp.abs(img - gt_img)) + 0.2 * (1.0 - jlosses.ssim(img, gt_img))

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt_state = tx.update(g, opt_state)
        return optax.apply_updates(params, upd), opt_state, loss

    losses = []
    for v in views:
        params, opt_state, loss = step(params, opt_state, cams[v], jnp.asarray(gts[v]))
        losses.append(float(loss))
    return dict(gts=gts, pert=pert, normals=normals, losses=losses, views=views,
                params={k: np.asarray(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def jax_refs():
    cfg = _jcfg()
    gt_state, sc = root.build_gt_state(jnp, jax, True)
    n_gt = len(sc["xyz"])
    cams = root.make_cameras(H, W, 12, 2)
    bg = jnp.zeros(3)
    gt_render = jax.jit(lambda c: j_render(gt_state, c, cfg, bg, initial_stage=False).render)
    views = tv.view_order(12, STEPS, 5)
    gts = {v: np.asarray(gt_render(cams[v])) for v in set(views) | {12}}

    state = _jax_recover_state(gt_state, n_gt)
    opt = JOptimizationParams()
    tv.recover_schedule(opt, STEPS)
    ts = JTrainState.create(state, opt)
    start = _gaussians_np(ts.gaussians)
    jstep = jax.jit(j_make_train_step(opt, cfg, spatial_lr_scale=4.2))
    seen, losses = [], []

    def recording(ts_, cam, gt, bg_):
        seen.append(next(i for i, c in enumerate(cams) if c is cam))
        ts_, aux = jstep(ts_, cam, gt, bg_)
        losses.append(float(aux.loss))
        return ts_, aux

    full_gts = [gts.get(i, np.zeros((H, W, 3), np.float32)) for i in range(len(cams))]
    ts, _ = root.train_loop(jax, jnp, recording, ts, opt, cams, full_gts, 12, bg, JEventLog(), [])
    return dict(gt_state=gt_state, cams=cams, gts=gts, start=start, views=seen, losses=losses,
                end=_gaussians_np(ts.gaussians), vol=_jax_vol(root.make_cameras(H, W, 8, 2)))


def test_scene_equals_the_root_script():
    for smoke in (True, False):
        a, b = tv.make_structured_scene(smoke), root.make_structured_scene(smoke)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    nrm = np.random.default_rng(0).normal(size=(500, 3))
    nrm[:2] = [[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]]  # antiparallel and parallel to e_z
    np.testing.assert_array_equal(tv._normal_quats(nrm), root._normal_quats(nrm))


def test_gt_state_and_render_match_jax(jax_refs):
    t_state, _ = tv.build_gt_state(True, "cpu")
    want = _gaussians_np(jax_refs["gt_state"])
    got = state_to_numpy(t_state)
    for k in LEAVES + ("alive", "texture", "fail_value", "active_sh_degree"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = tv.task_config(True)
    bg = torch.zeros(3)
    for v, img in jax_refs["gts"].items():
        cam = camera_from_numpy(_cam_arrays(jax_refs["cams"][v]), "cpu")
        with torch.no_grad():
            out = tv.render(t_state, cam, cfg, bg, initial_stage=False).render.numpy()
        np.testing.assert_allclose(out, img, rtol=0, atol=2e-5, err_msg=f"view {v}")
        assert img.mean() > 0.1


def test_recover_start_equals_the_root_script(jax_refs):
    t_gt, _ = tv.build_gt_state(True, "cpu")
    got = state_to_numpy(tv.recover_state(t_gt, np.random.default_rng(9)))
    for k, v in jax_refs["start"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _no_draws(name, shape):
    raise AssertionError(f"the recover task drew {name}")


def test_recover_steps_match_jax(jax_refs):
    opt = tv.recover_schedule(OptimizationParams(), STEPS)
    ts = TrainState.create(state_from_numpy(jax_refs["start"], "cpu"), opt)
    cams = [camera_from_numpy(_cam_arrays(c), "cpu") for c in jax_refs["cams"]]
    gts = [torch.tensor(jax_refs["gts"].get(i, np.zeros((H, W, 3), np.float32)))
           for i in range(len(cams))]
    seen, losses = [], []
    step = make_train_step(opt, tv.task_config(True), spatial_lr_scale=4.2)

    def recording(ts_, cam, gt, bg_):
        seen.append(next(i for i, c in enumerate(cams) if c is cam))
        return step(ts_, cam, gt, bg_)

    ts, _ = tv.train_loop(recording, ts, opt, cams, gts, 12, torch.zeros(3), EventLog(), [],
                          draws=_no_draws,
                          on_step=lambda it, aux: it and losses.append(float(aux.loss)))
    assert seen == jax_refs["views"]
    np.testing.assert_allclose(losses, jax_refs["losses"], rtol=1e-5)
    got = state_to_numpy(ts.gaussians)
    for k in LEAVES + ("texture", "fail_value"):
        want = jax_refs["end"][k]
        assert np.abs(got[k] - want).max() <= 1e-3 * np.abs(want).max(), k
    np.testing.assert_array_equal(got["alive"], jax_refs["end"]["alive"])


def test_recover_vol_adam_steps_match_optax(jax_refs):
    ref = jax_refs["vol"]
    cams = [camera_from_numpy(_cam_arrays(c), "cpu") for c in root.make_cameras(H, W, 8, 2)]
    normals = torch.tensor(ref["normals"])
    cfg = tv.task_config(True)
    bg = torch.zeros(3)
    params = {k: torch.as_tensor(v).requires_grad_(tv.VOL_LR[k] > 0)
              for k, v in ref["pert"].items()}
    opt = tv.vol_optimizer(params)
    losses = []
    for v in ref["views"]:
        opt.zero_grad(set_to_none=True)
        loss = tv.vol_loss(tv.render_vol(params, normals, cams[v], bg, cfg),
                           torch.as_tensor(ref["gts"][v]))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k in VOL_KEYS:
        want = ref["params"][k]
        got = params[k].detach().numpy()
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), k
    np.testing.assert_array_equal(params["rfl"].detach().numpy(), ref["params"]["rfl"])


def test_torch_adam_equals_optax_adam():
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(64, 3)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    tx = optax.adam(2e-3)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    tp = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.Adam([tp], lr=2e-3)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.as_tensor(g)
        topt.step()
        got = tp.detach().numpy()
        assert np.abs(got - np.asarray(jp)).max() <= 1e-6 * np.abs(np.asarray(jp)).max()


@pytest.mark.parametrize("task", ["recover", "scratch", "recover_vol"])
def test_artifact_keys_equal_the_jax_scripts(task, tmp_path, monkeypatch):
    monkeypatch.setenv("E2E_SMOKE", "1")
    out = tmp_path / f"{task}.json"
    tv.main(["--task", task, "--device", "cpu", "--iterations", "2", "--out", str(out)])
    got = json.loads(out.read_text())
    name = {"recover": "recover", "scratch": "scratch", "recover_vol": "vol"}[task]
    with open(os.path.join(ROOT, f"VALID_r05_{name}.json")) as f:
        want = json.load(f)
    extra = {"device"} if task == "recover_vol" else set()
    assert set(got) == set(want) | extra
    assert set(got["workload"]) == set(want["workload"])
    assert got["bars"] == want["bars"]
    assert got["backend"] == "cpu" and got["verdict"] in ("PASS", "BELOW-BAR")
    assert got["config"] == {**want["config"], "grad_channels": "full", "bf16_grads": False,
                             "bf16_feats": False}
