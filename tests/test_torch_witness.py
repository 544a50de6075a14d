"""A float64 witness for the gradients of Gaussians seen nearly edge-on.

tests/test_torch_train.py and tests/test_torch_loop.py hold the rows of two
edge-on Gaussians (51 and 68 of their seed-3 scene, whose homography is near
singular: |det| / the product of its row norms is 4.5e-5 and 1.5e-5) to a
looser bound than the others, because the port's gradients of them differ
from the JAX package's. This file asks which package is nearer the exact
gradient. The two Gaussians alone, seen by the same camera, are rasterized
with fixed cotangents on colour, the auxiliary maps and the reflection map;
the gradients in xyz, scales, rotation and the screen_offset probe come
from the JAX package (float32, its Pallas kernels in interpret mode), from
the port (float32, the plain kernel versions), and in float64 from
tests/ref_oracle.py's blend backward chained through the JAX preprocess
VJP evaluated in float64 (which equals a float64 run of the JAX
formulation to 1e-9, checked here).

Both float32 results are far from the float64 one (4e-2 to 1 of the leaf's
max: float32 cannot resolve these splats), and they are 1e-4 to 1e-2 of the
leaf's max from each other; which of the two is nearer changes with the
cotangents (the two cotangent seeds here; PERF.md, section 7). So the port is held to be no farther from
the float64 gradient than the JAX package is, plus the bound the edge-on
rows keep in tests/test_torch_train.py: 1.5e-3 of the leaf's max under
exact f32, 1e-2 under the production bf16 switches.
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.ref_oracle as RO
from tpu_splat.data import orbit_camera, random_scene
from tpu_splat.raster import rasterize as j_rasterize
from tpu_splat.raster.config import RasterConfig as JRasterConfig
from tpu_splat.raster.config import production_config as j_production_config
from tpu_splat.raster.preprocess import preprocess as j_preprocess

from tpu_splat_torch.core import f32
from tpu_splat_torch.model.convert import camera_from_numpy
from tpu_splat_torch.raster import config as tcfg
from tpu_splat_torch.raster import rasterize as t_rasterize
from tpu_splat_torch.raster.preprocess import preprocess as t_preprocess

H = W = 48
KW = dict(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256, chunk=16)
EDGE_ON = np.array([51, 68])
SWITCHES = {"exact": dict(bf16_grads=False, bf16_feats=False), "production": {}}
EDGE_ON_TOL = {"exact": 1.5e-3, "production": 1e-2}
LEAVES = ("xyz", "scales", "rotation", "screen_offset")


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module", params=[7, 3], ids=["cotangents7", "cotangents3"])
def case(request):
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3)
    camd = {k: np.asarray(getattr(cam, k))
            for k in ("world_view", "proj", "full_proj", "camera_center", "K")}
    camd.update({k: getattr(cam, k) for k in ("height", "width", "fovx", "fovy", "znear", "zfar")})
    raw = random_scene(120, seed=3, sh_degree=1)
    xyz, sc, rot = (raw[k][EDGE_ON] for k in ("xyz", "scaling", "rotation"))
    rng = np.random.default_rng(request.param)
    P = len(EDGE_ON)
    return dict(
        cam=cam, tcam=camera_from_numpy(camd, device="cpu"), xyz=xyz, rot=rot,
        scales=np.asarray(jnp.exp(sc)),
        opacity=np.asarray(jax.nn.sigmoid(raw["opacity"][EDGE_ON, 0])),
        refl=np.asarray(jax.nn.sigmoid(raw["refl"][EDGE_ON, 0] + 3.0)),
        colors=rng.uniform(0, 1, (P, 3)).astype(np.float32),
        bg=np.array([0.1, 0.2, 0.3], np.float32),
        ct_c=rng.normal(size=(H, W, 3)).astype(np.float32),
        ct_o=np.concatenate([rng.normal(size=(H, W, 7)), np.zeros((H, W, 1))], -1).astype(np.float32),
        ct_r=rng.normal(size=(H, W)).astype(np.float32),
    )


def _loss(out, c, lib):
    t = (lambda a: jnp.asarray(a)) if lib is jnp else torch.from_numpy
    return ((out.color * t(c["ct_c"])).sum() + (out.others * t(c["ct_o"])).sum()
            + (out.refl_map * t(c["ct_r"])).sum())


def _jax_grads(c, cfg, dtype=np.float32):
    cast = lambda a: jnp.asarray(np.asarray(a, dtype))
    cam = c["cam"].replace(**{k: cast(getattr(c["cam"], k))
                              for k in ("world_view", "proj", "full_proj", "camera_center", "K")})
    ct = {k: np.asarray(c[k], dtype) for k in ("ct_c", "ct_o", "ct_r")}

    def loss(x, s, r, so):
        out = j_rasterize(x, s, r, cast(c["opacity"]), cast(c["refl"]), cam, cast(c["bg"]), cfg,
                          colors=cast(c["colors"]), scope_mask=jnp.ones(len(EDGE_ON), bool),
                          screen_offset=so)
        return _loss(out, ct, jnp)

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        cast(c["xyz"]), cast(c["scales"]), cast(c["rot"]), jnp.zeros((len(EDGE_ON), 2), dtype))
    return [np.asarray(a, np.float64) for a in g]


@pytest.fixture(scope="module")
def reference(case):
    """The float64 gradients: the oracle's blend backward chained through the
    float64 preprocess VJP, and a float64 run of the JAX formulation."""
    c = case
    to64 = lambda a: np.asarray(a, np.float64)
    P = len(EDGE_ON)
    with RO.dtype(np.float64):
        prep = RO.ref_preprocess(to64(c["xyz"]), to64(c["scales"]), to64(c["rot"]),
                                 to64(c["cam"].world_view), to64(c["cam"].full_proj), W, H)
        fwd = RO.ref_render_forward(prep, to64(c["colors"]), to64(c["opacity"]),
                                    to64(c["refl"]), np.ones(P, bool), to64(c["bg"]), W, H)
        bwd = RO.ref_render_backward(prep, to64(c["colors"]), to64(c["opacity"]),
                                     to64(c["refl"]), to64(c["bg"]), W, H, fwd,
                                     to64(c["ct_c"]), to64(c["ct_o"]), to64(c["ct_r"]))
    with _x64():
        def pre(x, s, r, so):
            cam = c["cam"]
            p = j_preprocess(x, s, r, jnp.asarray(to64(cam.world_view)),
                             jnp.asarray(to64(cam.full_proj)), jnp.asarray(to64(cam.camera_center)),
                             H, W, colors=jnp.zeros((P, 3), jnp.float64), screen_offset=so,
                             circular_rect=True)
            return p.hom, p.xy, p.normal_view

        _, vjp = jax.vjp(pre, *(jnp.asarray(to64(a)) for a in
                                (c["xyz"], c["scales"], c["rot"], np.zeros((P, 2)))))
        oracle = [np.asarray(g) for g in vjp(tuple(jnp.asarray(bwd[k]) for k in
                                                   ("dT", "dmean2d", "dnormal")))]
        formulation = _jax_grads(c, JRasterConfig(backend="xla", grad_channels="full", **KW),
                                 np.float64)
    return oracle, formulation


def test_the_witness_gaussians_are_edge_on(case):
    c = case
    hom = t_preprocess(torch.from_numpy(c["xyz"]), torch.from_numpy(c["scales"]),
                       torch.from_numpy(c["rot"]), c["tcam"].world_view, c["tcam"].full_proj,
                       c["tcam"].camera_center, H, W,
                       colors=torch.zeros((len(EDGE_ON), 3))).hom.double().numpy()
    ratio = np.abs(np.linalg.det(hom)) / np.prod(np.linalg.norm(hom, axis=-1), axis=-1)
    assert (ratio < 2.0**-24 / 1e-3).all(), ratio


def test_float64_oracle_equals_the_float64_formulation(reference):
    oracle, formulation = reference
    for k, a, b in zip(LEAVES, oracle, formulation):
        scale = np.abs(b).max()
        assert scale > 0, k
        assert np.abs(a - b).max() <= 1e-9 * scale, k


@pytest.mark.parametrize("name", list(SWITCHES))
def test_port_is_no_farther_from_float64_than_jax(case, reference, name):
    c = case
    jg = _jax_grads(c, j_production_config(backend="pallas", **SWITCHES[name], **KW))
    args = [torch.tensor(a, requires_grad=True) for a in
            (c["xyz"], c["scales"], c["rot"], np.zeros((len(EDGE_ON), 2), np.float32))]
    out = t_rasterize(*args[:3], torch.from_numpy(c["opacity"]), torch.from_numpy(c["refl"]),
                      c["tcam"], torch.from_numpy(c["bg"]),
                      tcfg.production_config(**SWITCHES[name], **KW),
                      colors=torch.from_numpy(c["colors"]),
                      scope_mask=torch.ones(len(EDGE_ON), dtype=torch.bool), screen_offset=args[3])
    tg = [g.double().numpy() for g in torch.autograd.grad(_loss(out, c, torch), args)]
    dist = {}
    for k, j, t, r in zip(LEAVES, jg, tg, reference[0]):
        scale = np.abs(r).max()
        d_jax, d_port = np.abs(j - r).max() / scale, np.abs(t - r).max() / scale
        dist[k] = (float(f"{d_jax:.4g}"), float(f"{d_port:.4g}"),
                   float(f"{np.abs(t - j).max() / scale:.3g}"))
        assert d_port <= d_jax + EDGE_ON_TOL[name], (k, d_jax, d_port)
    print(name, "distance to float64 over the leaf's max (jax, port, jax-port):", dist,
          "port farther on", [k for k, (a, b, _) in dist.items() if b > a])


@pytest.fixture(scope="module")
def weights_case():
    """`gaussian_weights` of tests/test_torch_train.py's scene (120 Gaussians,
    5 dead) at tests/test_torch_dist.py's render camera, under the
    production switches with all channels: the JAX package's (float32, its
    Pallas kernels in interpret mode), the port's (float32, the plain kernel
    version) and tests/ref_oracle.py's forward in float64, with each
    Gaussian's homography conditioning |det| / the product of its row norms."""
    from tests.test_torch_train import BG, KW as TKW, _camera_arrays, _jax_train_state, _scene
    from tests.test_torch_train import _ts_to_numpy
    from tpu_splat_torch.model.convert import train_state_from_numpy

    d = _scene()
    jts = _jax_train_state(d)
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3)
    g = jts.gaussians
    j_gw = jax.jit(lambda s: j_rasterize(
        s.xyz, s.get_scaling(), s.rotation, s.get_opacity(), s.get_refl(), cam, jnp.asarray(BG),
        j_production_config(backend="pallas", grad_channels="full", **TKW),
        sh=s.get_features(), sh_degree=s.max_sh_degree, alive=s.alive))(g).gaussian_weights
    tg = train_state_from_numpy(_ts_to_numpy(jts), device="cpu").gaussians
    tcam = camera_from_numpy(_camera_arrays(cam), device="cpu")
    t_out = t_rasterize(tg.xyz, tg.get_scaling(), tg.rotation, tg.get_opacity(), tg.get_refl(),
                        tcam, torch.tensor(BG), tcfg.production_config(grad_channels="full", **TKW),
                        sh=tg.get_features(), sh_degree=tg.max_sh_degree, alive=tg.alive)
    to64 = lambda a: np.asarray(a, np.float64)
    opacity = 1.0 / (1.0 + np.exp(-to64(d["opacity"][:, 0])))
    opacity[~d["alive"]] = 0.0
    n = len(opacity)
    with RO.dtype(np.float64), np.errstate(all="ignore"):
        prep = RO.ref_preprocess(to64(d["xyz"]), np.exp(to64(d["scaling"])), to64(d["rotation"]),
                                 to64(cam.world_view), to64(cam.full_proj), W, H)
        f64 = RO.ref_render_forward(prep, np.zeros((n, 3)), opacity, np.zeros(n),
                                    np.ones(n, bool), to64(BG), W, H)["gw"]
    hom = t_preprocess(tg.xyz, tg.get_scaling(), tg.rotation, tcam.world_view, tcam.full_proj,
                       tcam.camera_center, H, W, colors=torch.zeros((n, 3))).hom.double().numpy()
    ratio = np.abs(np.linalg.det(hom)) / np.prod(np.linalg.norm(hom, axis=-1), axis=-1)
    return dict(jax=np.asarray(j_gw, np.float64), port=t_out.gaussian_weights.double().numpy(),
                f64=f64, ratio=ratio)


def test_gaussian_weights_gap_is_an_edge_on_splat(weights_case):
    """The port's gaussian_weights lie within 2e-5 of the float64 oracle's on
    every Gaussian. Where they part from the JAX package's by more than 2e-5
    (Gaussian 68 alone, 2.26e-5: its weight peaks at pixel (35, 23), where
    rho3d of a homography with |det| / row norms 1.5e-5 loses ~3.5e-4
    relative in float32), the Gaussian is edge-on and the port is nearer
    float64 than the JAX package (6.8e-6 against 2.9e-5): float32 cannot
    resolve that weight to 2e-5, and the JAX package misses by more."""
    c = weights_case
    d_port, d_jax = np.abs(c["port"] - c["f64"]), np.abs(c["jax"] - c["f64"])
    assert d_port.max() <= 2e-5, d_port.max()
    apart = np.abs(c["port"] - c["jax"]) > 2e-5
    assert np.flatnonzero(apart).tolist() == [68]
    assert (c["ratio"][apart] < 2.0**-24 / 1e-3).all(), c["ratio"][apart]
    assert (d_port[apart] < d_jax[apart]).all()
    assert c["f64"].max() > 0.5 and (c["port"] > 0).sum() > 50
