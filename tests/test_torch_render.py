"""tpu_splat_torch serving path vs the JAX package, on the CPU.

The same numpy-seeded scene goes through both packages; the JAX side runs
its Pallas kernels in interpret mode (backend="pallas"), the port its plain
PyTorch kernel versions. Each JAX reference is computed once per module.

Tolerances: preprocess against the jitted JAX preprocess: ints, the
homography, centre, depth and view normal exact, the SH colour 1e-5
relative (PARITY.md);
binning integers exact; render_fast render/alpha/refl_strength 2e-5 abs;
the normal 2e-5 abs on pixels with alpha > 0.02 or alpha = 0 (normalizing
divides the blended normal, whose length is at most alpha, so f32 noise in
it grows by 1/alpha; the faint pixels left out are at most 10% of the
frame); cubemap samples 1e-6; loaded PLY arrays equal.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.data import random_scene, orbit_camera
from tpu_splat.envmap.cubemap import CubemapParams, sample_cubemap
from tpu_splat.model.io import load_ply
from tpu_splat.model.state import GaussianState
from tpu_splat.raster.binning import bin_gaussians
from tpu_splat.raster.config import RasterConfig, production_config
from tpu_splat.raster.preprocess import preprocess
from tpu_splat.renderer import render_fast

import tpu_splat_torch.raster.config as tcfg
from tpu_splat_torch.envmap.cubemap import (
    CubemapParams as TCubemapParams,
    sample_cubemap as t_sample_cubemap,
)
from tpu_splat_torch.model.convert import camera_from_numpy, state_from_numpy
from tpu_splat_torch.model.io import load_ply as t_load_ply
from tpu_splat_torch.raster.binning import bin_gaussians as t_bin_gaussians
from tpu_splat_torch.raster.preprocess import preprocess as t_preprocess
from tpu_splat_torch.renderer import render_fast as t_render_fast

H = W = 64
N = 150
KW = dict(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256, chunk=16)
BG = [0.1, 0.2, 0.3]
# normals are compared where alpha > ALPHA_FLOOR: normalizing divides the
# blended normal, whose length is at most alpha, so below it f32 noise grows
ALPHA_FLOOR = 0.02
PLY = os.path.join(os.path.dirname(__file__), "..", "artifacts", "valid_scratch_state.ply")

_STATE_LEAVES = (
    "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
    "refl", "alive",
)


def _scene_arrays(seed=0):
    raw = random_scene(N, seed=seed, sh_degree=1)
    rng = np.random.default_rng(seed)
    return dict(
        xyz=raw["xyz"], features_dc=raw["sh"][:, :1], features_rest=raw["sh"][:, 1:],
        scaling=raw["scaling"], rotation=raw["rotation"], opacity=raw["opacity"],
        refl=raw["refl"],
        texture=rng.uniform(-0.5, 0.5, (6, 3, 8, 8)).astype(np.float32),
        fail_value=rng.uniform(-0.5, 0.5, 3).astype(np.float32),
        alive=np.arange(N) < N - 7,  # a few dead rows
        active_sh_degree=1, max_sh_degree=1,
    )


def _jax_state(d):
    return GaussianState(
        **{k: jnp.asarray(d[k]) for k in _STATE_LEAVES},
        env=CubemapParams(jnp.asarray(d["texture"]), jnp.asarray(d["fail_value"])),
        active_sh_degree=jnp.asarray(d["active_sh_degree"], jnp.int32),
        max_sh_degree=d["max_sh_degree"],
    )


def _camera_arrays(cam):
    d = {k: np.asarray(getattr(cam, k))
         for k in ("world_view", "proj", "full_proj", "camera_center", "K")}
    d.update({k: getattr(cam, k)
              for k in ("height", "width", "fovx", "fovy", "znear", "zfar")})
    return d


@pytest.fixture(scope="module")
def scene():
    d = _scene_arrays()
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.4, elevation=0.3)
    return dict(
        d=d, jstate=_jax_state(d), jcam=cam,
        tstate=state_from_numpy(d, device="cpu"),
        tcam=camera_from_numpy(_camera_arrays(cam), device="cpu"),
    )


CONFIGS = {
    # the shipped switch set: train-shaped kernel, bf16 content rows
    "production": (production_config(backend="pallas", **KW), tcfg.production_config(**KW)),
    # scripts/render.py's RasterConfig(): full shape, f32 content rows
    "full": (RasterConfig(backend="pallas", **KW), tcfg.RasterConfig(**KW)),
}


@pytest.fixture(scope="module")
def renders(scene):
    out = {}
    for name, (jc, tc) in CONFIGS.items():
        for cw in (False, True):
            a = render_fast(scene["jstate"], scene["jcam"], jc, jnp.asarray(BG),
                            collect_weights=cw)
            b = t_render_fast(scene["tstate"], scene["tcam"], tc, torch.tensor(BG),
                              collect_weights=cw)
            out[name, cw] = (a, b)
    return out


def _prep_args(scene):
    s, c = scene["jstate"], scene["jcam"]
    ts, tc = scene["tstate"], scene["tcam"]
    ja = (s.xyz, s.get_scaling(), s.rotation, c.world_view, c.full_proj,
          c.camera_center, H, W)
    ta = (ts.xyz, ts.get_scaling(), ts.rotation, tc.world_view, tc.full_proj,
          tc.camera_center, H, W)
    return ja, ta


def _jit_preprocess(ja, sh, opacity):
    """The JAX package's preprocess jitted with the camera as an argument,
    as its trainer and `render_fast` run it."""
    f = jax.jit(lambda x, s, r, wv, fp, cc, sh, o: preprocess(
        x, s, r, wv, fp, cc, H, W, sh=sh, sh_degree=1, opacity=o))
    return f(*ja[:6], sh, opacity)


@pytest.mark.parametrize("opacity_rect", [False, True])
def test_preprocess_matches_jax(scene, opacity_rect):
    ja, ta = _prep_args(scene)
    jo = scene["jstate"].get_opacity() if opacity_rect else None
    to = scene["tstate"].get_opacity() if opacity_rect else None
    a = _jit_preprocess(ja, scene["jstate"].get_features(), jo)
    b = t_preprocess(*ta, sh=scene["tstate"].get_features(), sh_degree=1, opacity=to)
    # what binning reads rounds as the jitted JAX code: equal bits
    for f in ("radius", "rect_min", "rect_max", "tiles_touched", "valid", "hom", "xy", "depth",
              "normal_view"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), err_msg=f)
    x, y = np.asarray(a.color), b.color.numpy()
    np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5 * np.abs(x).max(), err_msg="color")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bin_gaussians_integers_exact(scene, name):
    jc, tc = CONFIGS[name]
    ja, ta = _prep_args(scene)
    jo = scene["jstate"].get_opacity() if jc.opacity_rect else None
    to = scene["tstate"].get_opacity() if tc.opacity_rect else None
    a = _jit_preprocess(ja, scene["jstate"].get_features(), jo)
    a = a._replace(valid=a.valid & scene["jstate"].alive)
    a = a._replace(tiles_touched=jnp.where(a.valid, a.tiles_touched, 0))
    b = t_preprocess(*ta, sh=scene["tstate"].get_features(), sh_degree=1, opacity=to)
    b = b._replace(valid=b.valid & scene["tstate"].alive)
    b = b._replace(tiles_touched=torch.where(b.valid, b.tiles_touched, 0))
    ja_b = bin_gaussians(a, H, W, jc, aligned=True)
    tb_b = t_bin_gaussians(b, H, W, tc)
    for f in ("num_instances", "max_area", "tile_counts", "tile_starts",
              "aligned_gid", "aligned_valid", "aligned_starts", "aligned_rank",
              "rank_of", "seg_start", "seg_end", "pad_overflow"):
        np.testing.assert_array_equal(
            getattr(tb_b, f).numpy(), np.asarray(getattr(ja_b, f)), err_msg=f
        )


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("collect_weights", [False, True])
def test_render_fast_matches_jax(renders, name, collect_weights):
    a, b = renders[name, collect_weights]
    for f in ("render", "alpha", "refl_strength"):
        np.testing.assert_allclose(
            getattr(b, f).numpy(), np.asarray(getattr(a, f)), rtol=0, atol=2e-5, err_msg=f
        )
    alpha = np.asarray(a.alpha)[..., 0]
    faint = (alpha > 0.0) & (alpha <= ALPHA_FLOOR)
    assert faint.mean() <= 0.1, faint.mean()  # the halo of a sparse test scene
    dn = np.abs(b.normal.numpy() - np.asarray(a.normal)).max(-1)
    assert dn[~faint].max() <= 2e-5, dn[~faint].max()
    np.testing.assert_allclose(
        b.gaussian_weights.numpy(), np.asarray(a.gaussian_weights), rtol=0, atol=2e-5
    )
    for f in ("radii", "visibility", "num_instances", "max_area", "max_tile_count",
              "pad_overflow"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), err_msg=f)
    assert float(alpha.max()) > 0.5  # the frame is not empty
    if collect_weights:
        assert float(b.gaussian_weights.max()) > 0.0
    else:
        assert float(b.gaussian_weights.abs().max()) == 0.0


@pytest.mark.parametrize("interp", ["seamless", "bilinear", "nearest"])
def test_sample_cubemap_matches_jax(interp):
    rng = np.random.default_rng(7)
    L = 6
    tex = rng.uniform(-1, 1, (6, 3, L, L)).astype(np.float32)
    fail = rng.uniform(-1, 1, 3).astype(np.float32)
    # odd directions (no half-integer texel coordinates), every face and the
    # zero direction (fail value)
    dirs = rng.normal(size=(40, 37, 3)).astype(np.float32)
    dirs[0, :6] = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                            [0, 0, 1], [0, 0, -1]], np.float32) + 0.013
    dirs[1, 0] = 0.0
    a = sample_cubemap(CubemapParams(jnp.asarray(tex), jnp.asarray(fail)),
                       jnp.asarray(dirs), interp=interp)
    b = t_sample_cubemap(TCubemapParams(torch.from_numpy(tex), torch.from_numpy(fail)),
                         torch.from_numpy(dirs), interp=interp)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(b[1, 0].numpy(), fail)


def test_load_ply_matches_jax():
    a = load_ply(PLY)
    b = t_load_ply(PLY, device="cpu")
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "refl", "alive"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), err_msg=f)
    np.testing.assert_array_equal(b.env.texture.numpy(), np.asarray(a.env.texture))
    np.testing.assert_array_equal(b.env.fail_value.numpy(), np.asarray(a.env.fail_value))
    assert b.active_sh_degree == int(a.active_sh_degree)
    assert b.max_sh_degree == a.max_sh_degree
    assert b.num_alive == 12_837
