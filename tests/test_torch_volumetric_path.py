"""The 3DGS-DR volumetric family on the port's normal path, on the CPU,
against the benchmark's plain reference (`splatbench/reference/
volumetric.py`: plain PyTorch, nothing of the port). No JAX.

A state with three scale columns renders through `render` and
`render_fast` in volumetric mode, trains through `make_train_step` and the
loop's events, saves and loads as a PLY with `scale_2`, and is served by
`scripts/view.py`. The scene: ~3,000 seeded random Gaussians (the
benchmark's synthetic distributions with its thin third axis, drawn here)
at 64x96. Of the benchmark only the reference is imported.

Tolerances, all for float32 rounding of the same equations evaluated in
another order (the readings they were set from in brackets, over seeds 11
and 12):
- the rendered image and alpha 2e-5 absolute [2.3e-6];
- the world normal map 2e-4 [2.0e-5]: a normalisation where alpha is thin;
- depth 5e-4 absolute at depths of 6-9 [5.6e-5], the depth-derived normal
  5e-4 [6.6e-5]: finite differences of the depth;
- the loss 1e-6 relative [0], each leaf's gradient 1e-4 of its norm
  [4.1e-6], the `screen_offset` probe's gradient 1e-4 of its norm [2.5e-6].
A fault of the normal rule moves the normal map by O(1).
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import os

import numpy as np
import pytest
import torch

from splatbench.reference import splat
from splatbench.reference import train as ref_train
from splatbench.reference import volumetric as ref_vol
from tpu_splat_torch.config import OptimizationParams
from tpu_splat_torch.core.graphics import Camera
from tpu_splat_torch.core.transforms import quat_to_rotmat
from tpu_splat_torch.envmap.cubemap import CubemapParams
from tpu_splat_torch.isp.ppisp import ISPConfig
from tpu_splat_torch.model import io as tio
from tpu_splat_torch.model.densify import DensifyStats, densify_and_prune
from tpu_splat_torch.model.optim import adam_init
from tpu_splat_torch.model.state import GaussianState
from tpu_splat_torch.raster import rasterize
from tpu_splat_torch.raster.config import RasterConfig
from tpu_splat_torch.raster.volumetric import preprocess_volumetric
from tpu_splat_torch.renderer.render import render, render_fast, shortest_axis_normals
from tpu_splat_torch.train.step import TrainState, make_train_step
from tests.torch_threads import one_thread  # noqa: F401

H, W, N, CAP = 64, 96, 3000, 4096
CFG = RasterConfig(max_tiles_per_gaussian=16, max_instances=16384, tile_depth=256, chunk=32)
TRAINING = dict(lambda_dssim=0.2, lambda_normal=0.05, position_lr_init=1.6e-4,
                position_lr_final=1.6e-6, position_lr_max_steps=30000, feature_lr=2.5e-3,
                opacity_lr=0.05, scaling_lr=5e-3, rotation_lr=1e-3, refl_lr=6e-3,
                envmap_cubemap_lr=0.05, isp_lr=1e-3)


def _cloud(seed: int, n: int = N) -> dict:
    """Raw leaves of n Gaussians uniform in [-2, 2]^3 whose orientations vary
    smoothly with position, two log-scales N(-4, 0.5) and a thin third at
    their mean + log 0.25, DC colour U(0, 1), higher SH bands zero, opacity
    logits U(-1, 2), reflection logit -2.2, a 16^2 cubemap U(-0.5, 0.5)."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g)
    nrm = lambda *s: torch.randn(s, generator=g)
    xyz = 4.0 * u(n, 3) - 2.0
    rot = torch.stack([torch.ones(n), 0.4 * torch.sin(1.3 * xyz[:, 0]),
                       0.4 * torch.cos(1.1 * xyz[:, 1]), 0.4 * torch.sin(0.9 * xyz[:, 2])], 1)
    rot = rot + 0.05 * nrm(n, 4)
    features_dc = (u(n, 1, 3) - 0.5) / 0.28209479177387814
    s2 = -4.0 + 0.5 * nrm(n, 2)
    opacity = 3.0 * u(n, 1) - 1.0
    env = u(6, 3, 16, 16) - 0.5
    return dict(xyz=xyz, features_dc=features_dc, features_rest=torch.zeros(n, 15, 3),
                scaling=torch.cat([s2, s2.mean(1, keepdim=True) + math.log(0.25)], 1),
                rotation=rot, opacity=opacity, refl=torch.full((n, 1), -2.2),
                env_texture=env, env_fail=torch.zeros(3))


def _state(c: dict, capacity: int) -> GaussianState:
    """The cloud padded with dead rows to `capacity` as the port pads (unit
    quaternions, log-scale and logits at -10), SH degree 3 active."""
    n = c["xyz"].shape[0]

    def pad(k, fill=0.0):
        out = torch.full((capacity,) + tuple(c[k].shape[1:]), fill)
        out[:n] = c[k]
        return out

    rot = pad("rotation")
    rot[n:, 0] = 1.0
    alive = torch.zeros(capacity, dtype=torch.bool)
    alive[:n] = True
    return GaussianState(
        xyz=pad("xyz"), features_dc=pad("features_dc"), features_rest=pad("features_rest"),
        scaling=pad("scaling", -10.0), rotation=rot, opacity=pad("opacity", -10.0),
        refl=pad("refl", -10.0),
        env=CubemapParams(texture=c["env_texture"].clone(), fail_value=c["env_fail"].clone()),
        alive=alive, active_sh_degree=3, max_sh_degree=3)


def _view(az=0.7):
    """(the port's camera, the reference's) on an orbit of radius 6 at
    elevation 0.3 and horizontal field of view 0.8, looking at the origin."""
    el, radius, fov = 0.3, 6.0, 0.8
    pos = radius * np.array([math.cos(el) * math.sin(az), math.sin(el),
                             math.cos(el) * math.cos(az)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    T = -R.T @ pos
    R, T = R.astype(np.float32), T.astype(np.float32)
    fovy = 2 * math.atan(math.tan(fov / 2) * H / W)
    return (Camera.create(R=R, T=T, fovx=fov, fovy=fovy, height=H, width=W, device="cpu"),
            splat.camera(R, T, fov, fovy, H, W, "cpu"))


def _ref_leaves(c: dict) -> dict:
    p = dict(c)
    p["alive"] = torch.ones(c["xyz"].shape[0], dtype=torch.bool)
    return p


@pytest.fixture(scope="module", params=[11, 12])
def frames(request):
    c = _cloud(request.param)
    cam, rcam = _view()
    st = _state(c, CAP)
    with torch.no_grad():
        out = render(st, cam, CFG, torch.zeros(3))
    _, info = ref_vol.frame(_ref_leaves(c), rcam, torch.zeros(3), splat.Precision())
    return st, out, info


def test_the_state_picks_the_family_by_its_scale_columns(frames):
    st, out, info = frames
    assert st.volumetric and st.scaling.shape == (CAP, 3)
    surfel = dataclasses.replace(st, scaling=st.scaling[:, :2])
    assert not surfel.volumetric
    assert int(out.num_instances) == info["instances"] > N


@pytest.mark.parametrize("name,atol", [("render", 2e-5), ("alpha", 2e-5), ("normal", 2e-4),
                                       ("depth", 5e-4), ("surf_normal", 5e-4)])
def test_render_matches_the_reference(frames, name, atol):
    _, out, info = frames
    maps, ro = info["maps"], info["out"]
    alpha = 1.0 - maps[..., 3:4]
    want = dict(render=ro["render"], alpha=alpha, normal=ro["normal"],
                depth=maps[..., 4:5] / torch.clamp(alpha, min=1e-3),
                surf_normal=ro["surf_normal"])[name]
    got = dict(render=out.render, alpha=out.alpha, normal=out.normal, depth=out.surf_depth,
               surf_normal=out.surf_normal)[name]
    assert float(want.abs().max()) > 0.5
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


def test_render_fast_serves_the_same_frame(frames):
    st, out, _ = frames
    cam, _ = _view()
    fast = render_fast(st, cam, CFG, torch.zeros(3))
    torch.testing.assert_close(fast.render, out.render, atol=0, rtol=0)
    torch.testing.assert_close(fast.normal, out.normal, atol=0, rtol=0)


@pytest.fixture(scope="module")
def step_grads():
    """The first training step's gradients, the port's and the reference's,
    on one view at full float32 (full-channel rows, no bf16)."""
    c = _cloud(11)
    cam, rcam = _view(1.3)
    st = _state(c, CAP)
    opt = OptimizationParams()
    ts = TrainState.create(st, opt, num_frames=2)
    ts.step = 20500
    isp_cfg = ISPConfig(controller_activation_ratio=(opt.iterations - 5000) / opt.iterations)
    step = make_train_step(opt, CFG, spatial_lr_scale=6.6, isp_cfg=isp_cfg)
    gt = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(3))
    _, grads, (loss, *_) = step.value_and_grads(ts, cam, gt, torch.zeros(3), None, False, 1,
                                                None)
    p = _ref_leaves(c)
    p.update(ref_train.isp_init(2, "cpu"))
    ref_loss, ref_grads = ref_vol.loss_and_grads(p, rcam, gt, torch.zeros(3), 1, TRAINING,
                                                 splat.Precision())
    return float(loss), grads, ref_loss, ref_grads


def test_the_step_loss_matches_the_reference(step_grads):
    loss, _, ref_loss, _ = step_grads
    assert abs(loss - ref_loss) <= 1e-6 * ref_loss


@pytest.mark.parametrize("leaf", [k for k in ref_train.LEAVES if not k.startswith("isp_ctrl")
                                  and k not in ("env_fail", "isp_vig_center")])
def test_the_step_gradients_match_the_reference(step_grads, leaf):
    _, grads, _, ref_grads = step_grads
    got, want = grads[leaf], ref_grads[leaf]
    if got.shape[0] == CAP and want.shape[0] == N:
        assert float(got[N:].abs().max()) == 0.0  # dead rows
        got = got[:N]
    scale = float(torch.linalg.vector_norm(want))
    assert scale > 0.0
    assert float(torch.linalg.vector_norm(got - want)) <= 1e-4 * scale


def test_the_screen_offset_probe_is_the_gradient_at_the_projected_centre(step_grads):
    """3DGS's means2D gradient, in NDC units: (W/2, H/2) times the
    reference's gradient at its projected centre, in pixels."""
    _, grads, _, ref_grads = step_grads
    want = ref_grads["means2D"] * (0.5 * torch.tensor([float(W), float(H)]))
    got = grads["screen_offset"][:N]
    assert float(torch.linalg.vector_norm(want)) > 0.0
    assert float(torch.linalg.vector_norm(got - want)) <= 1e-4 * float(
        torch.linalg.vector_norm(want))


def test_the_probe_moves_the_blended_centre_after_the_rect():
    c = _cloud(5, 200)
    cam, _ = _view()
    s = torch.exp(c["scaling"])
    args = (c["xyz"], s, c["rotation"], torch.zeros_like(c["xyz"]), cam.world_view,
            cam.full_proj, cam.camera_center, H, W, cam.tanfovx, cam.tanfovy)
    kw = dict(colors=torch.zeros_like(c["xyz"]))
    plain, _ = preprocess_volumetric(*args, **kw)
    off = 0.01 * torch.randn(200, 2, generator=torch.Generator().manual_seed(1))
    moved, _ = preprocess_volumetric(*args, screen_offset=off, **kw)
    for f in ("rect_min", "rect_max", "radius", "valid", "depth"):
        assert torch.equal(getattr(moved, f), getattr(plain, f)), f
    z = plain.hom[:, 2, 2]
    shift = 0.5 * torch.tensor([float(W), float(H)]) * off * z[:, None]
    torch.testing.assert_close(moved.hom[:, :2, 2], plain.hom[:, :2, 2] + shift, atol=1e-4,
                               rtol=1e-6)
    zero, _ = preprocess_volumetric(*args, screen_offset=torch.zeros(200, 2), **kw)
    assert torch.equal(zero.hom, plain.hom)


# -- the shortest-axis normal ------------------------------------------------------

def test_the_normal_is_the_shortest_axis_turned_toward_the_camera():
    g = torch.Generator().manual_seed(2)
    n = 64
    xyz = torch.randn(n, 3, generator=g)
    rot = torch.randn(n, 4, generator=g)
    scales = torch.rand(n, 3, generator=g) + 0.1
    cc = torch.tensor([0.5, -4.0, 2.0])
    got = shortest_axis_normals(xyz, scales, rot, cc)
    R = quat_to_rotmat(rot)
    k = torch.argmin(scales, -1)
    assert len(set(k.tolist())) == 3  # each axis is the shortest somewhere
    col = R[torch.arange(n), :, k]
    toward = torch.sum(col * (cc - xyz), -1) >= 0
    assert 0 < int(toward.sum()) < n  # both signs occur
    want = torch.where(toward[:, None], col, -col)
    assert torch.equal(got, want)


def test_the_normal_gradient_reaches_the_rotation_only():
    g = torch.Generator().manual_seed(3)
    xyz = torch.randn(16, 3, generator=g).requires_grad_()
    rot = torch.randn(16, 4, generator=g).requires_grad_()
    scales = (torch.rand(16, 3, generator=g) + 0.1).requires_grad_()
    cc = torch.zeros(3, requires_grad=True)
    n = shortest_axis_normals(xyz, scales, rot, cc)
    gx, gr, gs, gc = torch.autograd.grad((n * torch.randn(16, 3, generator=g)).sum(),
                                         [xyz, rot, scales, cc], allow_unused=True)
    assert gx is None and gs is None and gc is None
    assert float(gr.abs().max()) > 0.0


def test_the_normal_axis_is_a_span_of_the_renderer():
    from tpu_splat_torch.core.device import record_stages

    st = _state(_cloud(4, 300), 512)
    cam, _ = _view()
    with record_stages("cpu") as ms:
        with torch.no_grad():
            render_fast(st, cam, CFG, torch.zeros(3))
    assert "normal_axis" in ms and "preprocess" in ms
    surfel = dataclasses.replace(st, scaling=st.scaling[:, :2])
    with record_stages("cpu") as ms:
        with torch.no_grad():
            render_fast(surfel, cam, CFG, torch.zeros(3))
    assert "normal_axis" not in ms


def test_a_longest_axis_normal_is_another_frame(frames, monkeypatch):
    """The planted fault of the benchmark's tests, seen here: normals from
    the longest axis move the normal map far past its tolerance."""
    st, out, _ = frames

    def longest(xyz, scales, rotation, cc):
        return shortest_axis_normals(xyz, -scales, rotation, cc)

    # the package re-exports the function `render` under the module's name
    monkeypatch.setattr(importlib.import_module("tpu_splat_torch.renderer.render"),
                        "shortest_axis_normals", longest)
    cam, _ = _view()
    with torch.no_grad():
        bad = render(st, cam, CFG, torch.zeros(3))
    assert float((bad.normal - out.normal).abs().max()) > 0.5


# -- densify, the PLY, tight culling, the CLIs ---------------------------------------

def test_split_children_sit_on_all_three_axes():
    c = _cloud(6, 8)
    st = _state(c, 32)
    hot = torch.zeros(32)
    hot[:8] = 1.0
    stats = DensifyStats.zeros(32)._replace(grad_accum=hot, denom=hot.clone(),
                                            accum_w=hot.clone(), denom_w=hot.clone())
    eps = torch.randn(2, 32, 3, generator=torch.Generator().manual_seed(0))
    opt = adam_init(st.param_pytree())
    res = densify_and_prune(st, opt, stats, eps, grad_threshold=0.5, percent_dense=0.0,
                            extent=100.0, cameras_mean=torch.zeros(3), size_prune=False)
    assert int(res.n_split) == 8 and int(res.n_cloned) == 0
    g = res.state
    assert int(g.alive.sum()) == 16  # two children of each in the freed rows
    R = quat_to_rotmat(st.rotation[:8])
    s = torch.exp(st.scaling[:8])
    rows = torch.nonzero(g.alive).flatten()
    kids = g.xyz[rows].reshape(2, 8, 3)
    want = st.xyz[None, :8] + torch.einsum("pij,npj->npi", R, eps[:, :8] * s[None])
    torch.testing.assert_close(kids, want, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(g.scaling[rows].reshape(2, 8, 3),
                               torch.log(s / 1.6)[None].expand(2, 8, 3), atol=1e-6, rtol=1e-6)


def test_loop_draws_split_noise_per_scale_axis():
    from tpu_splat_torch.train.loop import run_scheduled_events

    opt = OptimizationParams()
    st = _state(_cloud(7, 40), 64)
    ts = TrainState.create(st, opt)
    shapes = []

    def draws(name, shape):
        shapes.append((name, shape))
        return torch.zeros(shape)

    # past densify_from_iter, on both densification intervals
    it = 2 * math.lcm(opt.densification_interval, opt.densification_interval_when_prop)
    assert opt.densify_from_iter < it < opt.densify_until_iter
    run_scheduled_events(ts, it, opt, cameras_extent=4.0, cameras_mean=np.zeros(3),
                         draws=draws)
    assert ("densify_eps", (2, 64, 3)) in shapes


def test_the_ply_round_trips_with_scale_2(tmp_path):
    st = _state(_cloud(8, 100), 128)
    path = str(tmp_path / "point_cloud.ply")
    tio.save_ply(st, path)
    with open(path, "rb") as f:
        head = f.read(4096).split(b"end_header")[0].decode()
    assert "property float scale_2\nproperty float rot_0" in head
    back = tio.load_ply(path, device="cpu")
    assert back.volumetric
    for k in ("xyz", "scaling", "rotation", "opacity", "refl", "features_dc"):
        assert torch.equal(getattr(back, k)[:100], getattr(st, k)[:100]), k
    surfel = dataclasses.replace(st, scaling=st.scaling[:, :2])
    tio.save_ply(surfel, path)
    assert not tio.load_ply(path, device="cpu").volumetric


def test_volumetric_with_tight_culling_raises():
    st = _state(_cloud(9, 50), 64)
    cam, _ = _view()
    with pytest.raises(ValueError, match="tight culling"):
        rasterize(st.xyz, st.get_scaling(), st.rotation, st.get_opacity(), st.get_refl(),
                  cam, torch.zeros(3), dataclasses.replace(CFG, tight_culling=True),
                  colors=torch.zeros(64, 3), mode="volumetric")
    with pytest.raises(ValueError, match="hom_precomp"):
        rasterize(st.xyz, st.get_scaling(), st.rotation, st.get_opacity(), st.get_refl(),
                  cam, torch.zeros(3), CFG, colors=torch.zeros(64, 3), mode="volumetric",
                  hom_precomp=torch.zeros(64, 3, 3))


CLI_CAPS = ["--eval", "-q", "--disable_viewer", "--iterations_override", "10",
            "--num_points", "300", "--cubemap_resol", "8", "--max_tiles_per_gaussian", "8",
            "--max_instances", "8192", "--tile_depth", "256"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from tests.test_scripts import _make_scene
    from tpu_splat_torch.scripts import train as tcli

    root = tmp_path_factory.mktemp("vol_cli")
    src, out = str(root / "scene"), str(root / "model")
    _make_scene(src)
    ts = tcli.main(["-s", src, "-m", out, "--volumetric"] + CLI_CAPS, device="cpu")
    return src, out, ts


def test_the_train_cli_trains_volumetric_gaussians(trained, tmp_path):
    from tpu_splat_torch.scripts import train as tcli

    src, out, ts = trained
    assert ts.gaussians.volumetric and ts.step == 10
    ply = os.path.join(out, "point_cloud", "iteration_10", "point_cloud.ply")
    assert tio.load_ply(ply, device="cpu").volumetric
    with open(os.path.join(out, "cfg_args")) as f:
        assert "volumetric=True" in f.read()
    surf = str(tmp_path / "surfel")
    tcli.main(["-s", src, "-m", surf, "--iterations_override", "1"] + CLI_CAPS[3:] + CLI_CAPS[:3],
              device="cpu")
    with open(os.path.join(surf, "cfg_args")) as f:
        assert "volumetric" not in f.read()
    with pytest.raises(SystemExit, match="tight_culling"):
        tcli.main(["-s", src, "-m", str(tmp_path / "t"), "--volumetric", "--tight_culling"]
                  + CLI_CAPS, device="cpu")


def test_view_serves_a_volumetric_ply(trained, monkeypatch):
    from tpu_splat_torch.scripts import view
    from tpu_splat_torch.viewer import network_gui

    _, out, _ = trained
    served = {}

    class Quiet:
        def __init__(self, ip, port):
            self.listener = type("L", (), {"getsockname": lambda self: (ip, port)})()

    def serve(gui, state, cfg, bg, source, metrics):
        cam, _ = _view()
        served.update(state=state, frame=render_fast(state, cam, cfg, bg))

    monkeypatch.setattr(network_gui, "NetworkGUI", Quiet)
    monkeypatch.setattr(network_gui, "serve", serve)
    assert view.main(["-m", out, "--port", "0"], device="cpu") == 0
    assert served["state"].volumetric
    assert bool(torch.isfinite(served["frame"].render).all())
