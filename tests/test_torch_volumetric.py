"""tpu_splat_torch volumetric (3DGS EWA) mode and the brute-force oracle
against the JAX package, on the CPU.

The same numpy-seeded scenes (activations computed once in numpy) go
through both packages at 48x48 (64x64 for the preprocess). The JAX side of
the tile-kernel path runs its Pallas kernels in interpret mode
(backend="pallas"), the port its plain kernel versions; the JAX side of the
scan runs backend="xla". Each JAX reference is computed once per module,
jitted.

Tolerances:
- preprocess_volumetric against `jax.jit` of the JAX one: radius, rects,
  tiles_touched and valid exact; hom, xy, depth, normal_view and
  opacity_scale bit for bit; the SH colour 1e-5 relative (as the surfel
  preprocess, tests/test_torch_render.py);
- rasterize(mode="volumetric"), antialiasing off and on: colour, T and refl
  2e-5 absolute and 1e-4 relative, the other allmap channels 5e-5 and 1e-3,
  gaussian_weights 2e-5, at most 8 n_contrib flips per 4096 pixels
  (PARITY.md D4); gradients 1e-3 of each input's max |g|;
- the analytic single splat (tests/test_raster.py:test_volumetric_mode):
  5e-3 absolute against the closed-form EWA Gaussian, depth 0.05;
- the brute-force oracle against the JAX one on the same preprocess: the
  images 2e-5 absolute and 1e-4 relative (allmap 5e-5 / 1e-3), n_contrib
  exact; the port's production path against its own oracle: the rasterize
  tolerances above.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.data import orbit_camera, random_scene
from tpu_splat.raster import rasterize as j_rasterize
from tpu_splat.raster.bruteforce import blend_bruteforce as j_bruteforce
from tpu_splat.raster.config import RasterConfig
from tpu_splat.raster.preprocess import preprocess as j_preprocess
from tpu_splat.raster.volumetric import preprocess_volumetric as j_prep_vol

import tpu_splat_torch.raster.config as tcfg
from tpu_splat_torch.model.convert import camera_from_numpy
from tpu_splat_torch.raster import rasterize as t_rasterize
from tpu_splat_torch.raster.bruteforce import blend_bruteforce as t_bruteforce
from tpu_splat_torch.raster.preprocess import Preprocessed, preprocess as t_preprocess
from tpu_splat_torch.raster.volumetric import preprocess_volumetric as t_prep_vol

from tests.test_torch_scan_blend import _assert_images, _images, _loss, _loss_weights, _sigmoid
from tests.test_torch_train import _camera_arrays

H = W = 48
N = 150
KW = dict(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256, chunk=16)
BG = np.array([0.1, 0.2, 0.3], np.float32)
GRAD_ARGS = ("means3d", "scales3", "rotations", "opacity", "refl", "sh")


def _act(n, seed):
    """A random_scene cloud with three scale axes (the two surfel scales
    and the first one again, as tests/test_raster.py does) and random unit
    normals."""
    raw = random_scene(n, seed=seed, sh_degree=1)
    rng = np.random.default_rng(seed)
    sc = np.exp(raw["scaling"].astype(np.float64)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    return dict(
        means3d=raw["xyz"], scales3=np.concatenate([sc, sc[:, :1]], 1),
        rotations=raw["rotation"], opacity=_sigmoid(raw["opacity"][:, 0]),
        refl=_sigmoid(raw["refl"][:, 0]), sh=raw["sh"],
        normals=(nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32),
    )


def _cams(h=H, w=W, az=0.4, el=0.3, radius=4.0):
    cam = orbit_camera(h, w, radius=radius, azimuth=az, elevation=el)
    return cam, camera_from_numpy(_camera_arrays(cam), device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


# -- preprocess_volumetric -------------------------------------------------------

PREP_CASES = {"aa-off": (False, 1.0), "aa-on": (True, 1.0), "aa-on-modifier": (True, 1.3)}


@pytest.mark.parametrize("case", list(PREP_CASES))
def test_preprocess_volumetric_matches_jax(case):
    aa, smod = PREP_CASES[case]
    h = w = 64
    act = _act(300, 4)
    cam, tcam = _cams(h, w, az=1.1, el=-0.2)
    args = [act[k] for k in ("means3d", "scales3", "rotations", "normals")]
    # the camera is an argument of the jitted code, as in the JAX render()
    # (folded in as a constant, XLA rounds the projection dots another way)
    want, wscale = jax.jit(lambda x, s, r, n, sh, wv, fp, cc: j_prep_vol(
        x, s, r, n, wv, fp, cc, h, w, cam.tanfovx, cam.tanfovy, sh=sh, sh_degree=1,
        scale_modifier=smod, antialiasing=aa))(
        *args, act["sh"], cam.world_view, cam.full_proj, cam.camera_center)
    got, gscale = t_prep_vol(*(_t(a) for a in args), tcam.world_view, tcam.full_proj,
                             tcam.camera_center, h, w, tcam.tanfovx, tcam.tanfovy,
                             sh=_t(act["sh"]), sh_degree=1, scale_modifier=smod,
                             antialiasing=aa)
    for f in ("hom", "xy", "depth", "normal_view", "radius", "rect_min", "rect_max",
              "tiles_touched", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(gscale.numpy(), np.asarray(wscale))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color), rtol=1e-5, atol=1e-7)
    assert int(got.valid.sum()) > 200 and int(got.tiles_touched.sum()) > 300
    assert bool((gscale < 1.0).any()) == aa


# -- rasterize(mode="volumetric") on the tile-kernel path -----------------------

@pytest.fixture(scope="module")
def volumetric():
    act = _act(N, 6)
    jcam, tcam = _cams()
    w = _loss_weights()
    out = {}
    for aa in (False, True):
        def jloss(*a, _aa=aa):
            o = j_rasterize(*a[:5], jcam, jnp.asarray(BG), RasterConfig(backend="pallas", **KW),
                            sh=a[5], sh_degree=1, mode="volumetric",
                            normals=jnp.asarray(act["normals"]), antialiasing=_aa)
            return _loss(o, {k: jnp.asarray(v) for k, v in w.items()}, jnp), o

        (_, jout), jg = jax.jit(jax.value_and_grad(
            jloss, argnums=tuple(range(6)), has_aux=True))(*(act[k] for k in GRAD_ARGS))
        targs = {k: _t(act[k]).requires_grad_() for k in GRAD_ARGS}
        tout = t_rasterize(*(targs[k] for k in GRAD_ARGS[:5]), tcam, _t(BG),
                           tcfg.RasterConfig(**KW), sh=targs["sh"], sh_degree=1,
                           mode="volumetric", normals=_t(act["normals"]), antialiasing=aa)
        tg = torch.autograd.grad(_loss(tout, {k: _t(v) for k, v in w.items()}, torch),
                                 list(targs.values()))
        out[aa] = dict(jout=jout, jg=[np.asarray(g) for g in jg], tout=tout,
                       tg=[g.numpy() for g in tg])
    return out


@pytest.mark.parametrize("aa", [False, True], ids=["aa-off", "aa-on"])
def test_volumetric_images_match_jax(volumetric, aa):
    jout, tout = volumetric[aa]["jout"], volumetric[aa]["tout"]
    _assert_images(_images(jout), _images(tout))
    for f in ("radii", "num_instances", "max_area", "tile_counts", "pad_overflow"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                      err_msg=f)
    assert float(np.asarray(jout.others[..., 1]).max()) > 0.5


@pytest.mark.parametrize("i", range(len(GRAD_ARGS)), ids=GRAD_ARGS)
@pytest.mark.parametrize("aa", [False, True], ids=["aa-off", "aa-on"])
def test_volumetric_gradients_match_jax(volumetric, aa, i):
    want, got = volumetric[aa]["jg"][i], volumetric[aa]["tg"][i]
    scale = np.abs(want).max()
    assert scale > 0.0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=0, err_msg=GRAD_ARGS[i])


def test_volumetric_scan_blend_matches_jax():
    """The volumetric frame through the scan blend (backend="xla") in both
    packages."""
    act = _act(N, 8)
    jcam, tcam = _cams(az=2.0, el=0.4)
    cfg = dict(KW, backend="xla")
    a = jax.jit(lambda *x: j_rasterize(*x[:5], jcam, jnp.asarray(BG), RasterConfig(**cfg),
                                       sh=x[5], sh_degree=1, mode="volumetric",
                                       normals=x[6], antialiasing=True))(
        *(act[k] for k in GRAD_ARGS + ("normals",)))
    with torch.no_grad():
        b = t_rasterize(*(_t(act[k]) for k in GRAD_ARGS[:5]), tcam, _t(BG),
                        tcfg.RasterConfig(**cfg), sh=_t(act["sh"]), sh_degree=1,
                        mode="volumetric", normals=_t(act["normals"]), antialiasing=True)
    _assert_images(_images(a), _images(b))
    np.testing.assert_array_equal(b.tile_counts.numpy(), np.asarray(a.tile_counts))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_volumetric_single_splat_is_analytic(backend):
    """tests/test_raster.py:test_volumetric_mode on the port: one isotropic
    Gaussian at the origin renders the closed-form EWA falloff."""
    jcam, tcam = _cams(az=0.0, el=0.0)
    cfg = tcfg.RasterConfig(**dict(KW, backend=backend))
    with torch.no_grad():
        out = t_rasterize(torch.zeros((1, 3)), torch.full((1, 3), 0.1),
                          torch.tensor([[1.0, 0, 0, 0]]), torch.tensor([0.9]),
                          torch.tensor([0.0]), tcam, torch.zeros(3), cfg,
                          colors=torch.tensor([[1.0, 0.0, 0.0]]), mode="volumetric",
                          normals=torch.tensor([[0.0, 0.0, 1.0]]))
    img = out.color.numpy()
    assert np.isfinite(img).all()
    # centre at ((0 + 1) * S - 1) / 2, variance (focal * s / z)^2 + 0.3
    focal = W / (2 * math.tan(tcam.fovx / 2))
    var = (focal * 0.1 / 4.0) ** 2 + 0.3
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    d2 = (xs - (W - 1) / 2) ** 2 + (ys - (H - 1) / 2) ** 2
    expected = 0.9 * np.exp(-0.5 * d2 / var)
    expected[expected < 1.0 / 255.0] = 0.0  # the alpha skip
    np.testing.assert_allclose(img[..., 0], expected, atol=5e-3)
    assert img[..., 1].max() < 1e-3
    depth = out.others[..., 0].numpy() / np.clip(out.others[..., 1].numpy(), 1e-6, None)
    assert abs(depth[H // 2, W // 2] - 4.0) < 0.05


def test_hom_precomp_matches_jax():
    """A given homography (the reference's transMat_precomp) in place of the
    one built from scales and rotations: the preprocess and the frame
    through the tile kernels against the JAX package's."""
    act = _act(N, 14)
    jcam, tcam = _cams(az=0.9, el=0.1)
    x, s2, r = (_t(act[k]) for k in ("means3d", "scales3", "rotations"))
    s2 = s2[:, :2]
    # the surfels' own homographies, stretched 1.5x along u: not what the
    # scales give, so a preprocess that ignored hom_precomp would differ
    hom = t_preprocess(x, s2 * torch.tensor([1.5, 1.0]), r, tcam.world_view, tcam.full_proj,
                       tcam.camera_center, H, W, colors=torch.zeros((N, 3))).hom
    want = jax.jit(lambda xx, s, rr, h, sh, wv, fp, cc: j_preprocess(
        xx, s, rr, wv, fp, cc, H, W, sh=sh, sh_degree=1, hom_precomp=h))(
        act["means3d"], act["scales3"][:, :2], act["rotations"], hom.numpy(), act["sh"],
        jcam.world_view, jcam.full_proj, jcam.camera_center)
    got = t_preprocess(x, s2, r, tcam.world_view, tcam.full_proj, tcam.camera_center, H, W,
                       sh=_t(act["sh"]), sh_degree=1, hom_precomp=hom)
    for f in ("hom", "xy", "depth", "normal_view", "radius", "rect_min", "rect_max",
              "tiles_touched", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    plain = t_preprocess(x, s2, r, tcam.world_view, tcam.full_proj, tcam.camera_center, H, W,
                         colors=torch.zeros((N, 3)))
    assert not torch.equal(plain.rect_max, got.rect_max)
    a = jax.jit(lambda *v: j_rasterize(*v[:5], jcam, jnp.asarray(BG),
                                       RasterConfig(backend="pallas", **KW), sh=v[5],
                                       sh_degree=1, hom_precomp=v[6]))(
        act["means3d"], act["scales3"][:, :2], act["rotations"], act["opacity"], act["refl"],
        act["sh"], hom.numpy())
    with torch.no_grad():
        b = t_rasterize(x, s2, r, _t(act["opacity"]), _t(act["refl"]), tcam, _t(BG),
                        tcfg.RasterConfig(**KW), sh=_t(act["sh"]), sh_degree=1,
                        hom_precomp=hom)
    _assert_images(_images(a), _images(b))
    assert float(b.others[..., 1].max()) > 0.5


# -- the brute-force oracle -------------------------------------------------------

def _preps(mode, act, jcam):
    """The JAX package's (jitted) preprocess of `act`, as both packages'
    Preprocessed, and the opacity it blends with."""
    if mode == "volumetric":
        jp, scale = jax.jit(lambda x, s, r, n, sh, wv, fp, cc: j_prep_vol(
            x, s, r, n, wv, fp, cc, H, W, jcam.tanfovx, jcam.tanfovy, sh=sh, sh_degree=1,
            antialiasing=True))(
            act["means3d"], act["scales3"], act["rotations"], act["normals"], act["sh"],
            jcam.world_view, jcam.full_proj, jcam.camera_center)
        opa = act["opacity"] * np.asarray(scale)
    else:
        jp = jax.jit(lambda x, s, r, sh: j_preprocess(
            x, s, r, jcam.world_view, jcam.full_proj, jcam.camera_center, H, W, sh=sh,
            sh_degree=1))(act["means3d"], act["scales3"][:, :2], act["rotations"], act["sh"])
        opa = act["opacity"]
    return jp, Preprocessed(*(_t(getattr(jp, f)) for f in Preprocessed._fields)), opa


@pytest.mark.parametrize("mode", ["surfel", "volumetric"])
def test_bruteforce_matches_jax(mode):
    act = _act(80, 12)
    jcam, _ = _cams(az=0.7, el=0.25)
    jp, tp, opa = _preps(mode, act, jcam)
    scope = np.ones(80, bool)
    want = jax.jit(lambda p, o, r: j_bruteforce(p, o, r, jnp.asarray(scope), jnp.asarray(BG),
                                                H, W))(jp, opa, act["refl"])
    got = t_bruteforce(tp, _t(opa), _t(act["refl"]), _t(scope), _t(BG), H, W)
    for name, a, b, tol in zip(("color", "others", "refl", "T"), want[:4], got[:4],
                               ((2e-5, 1e-4), (5e-5, 1e-3), (2e-5, 1e-4), (2e-5, 1e-4))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol[0], rtol=tol[1],
                                   err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert float(got[3].min()) < 0.5  # something is opaque


@pytest.mark.parametrize("mode", ["surfel", "volumetric"])
def test_production_path_matches_bruteforce(mode):
    """tests/test_raster.py:test_forward_matches_bruteforce on the port: the
    tile-kernel path against the port's oracle on the port's preprocess."""
    act = _act(120, 0)
    _, tcam = _cams()
    scales = act["scales3"] if mode == "volumetric" else act["scales3"][:, :2]
    with torch.no_grad():
        out = t_rasterize(_t(act["means3d"]), _t(scales), _t(act["rotations"]),
                          _t(act["opacity"]), _t(act["refl"]), tcam, _t(BG),
                          tcfg.RasterConfig(**KW), sh=_t(act["sh"]), sh_degree=1, mode=mode,
                          normals=_t(act["normals"]))
        if mode == "volumetric":
            prep, _ = t_prep_vol(_t(act["means3d"]), _t(scales), _t(act["rotations"]),
                                 _t(act["normals"]), tcam.world_view, tcam.full_proj,
                                 tcam.camera_center, H, W, tcam.tanfovx, tcam.tanfovy,
                                 sh=_t(act["sh"]), sh_degree=1)
        else:
            prep = t_preprocess(_t(act["means3d"]), _t(scales), _t(act["rotations"]),
                                tcam.world_view, tcam.full_proj, tcam.camera_center, H, W,
                                sh=_t(act["sh"]), sh_degree=1)
        bf = t_bruteforce(prep, _t(act["opacity"]), _t(act["refl"]),
                          torch.ones(120, dtype=torch.bool), _t(BG), H, W)
    want = tuple(x.numpy() for x in (bf[0], bf[3], bf[2], bf[1], bf[4]))
    _assert_images(want, _images(out)[:5])
    assert float(out.others[..., 1].max()) > 0.5
