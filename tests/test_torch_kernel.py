"""tpu_splat_torch tile-blend kernel module vs the JAX package, on the CPU.

The JAX side builds the instance slab (preprocess, aligned binning,
pack_features) and runs its Pallas `tile_blend_forward` in interpret mode;
the port's `tile_blend_forward` takes the same slab on CPU tensors, which
selects its plain PyTorch version.

Tolerances (PARITY.md): pack_features exact, bf16 pair bits and the
log(opacity) row (XLA's float32 log, `core/f32.py`) included; out_px
colour/T/normal/refl/scope/M1/M2 2e-5 abs off the pixels where n_contrib
flips at the alpha/T knife edge (PARITY.md D4, at most 8 per
4096 px); wmax 2e-5 abs. The depth rows (depth, median depth, distortion)
are held to the JAX result at 2e-5 relative to the depth the pixel
composites, except on the pixels where a composited instance's float32
depth is ill-conditioned (a near edge-on splat divides by a small p2);
those are found from a float64 evaluation of the inputs, and there may be
at most 1 in 200.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.data import random_scene, orbit_camera
from tpu_splat.kernels import tile_blend as jtb
from tpu_splat.raster.binning import bin_gaussians
from tpu_splat.raster.blend import tile_origins
from tpu_splat.raster.config import RasterConfig
from tpu_splat.raster.preprocess import preprocess

from tpu_splat_torch.kernels import tile_blend as ttb
from tpu_splat_torch.raster.config import FILTER_INV_SQUARE

H = W = 64
CFG = RasterConfig(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256,
                   chunk=16, backend="pallas")


def _slab(n, seed, opacity=None):
    raw = random_scene(n, seed=seed)
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.3, elevation=0.2)
    opa = jax.nn.sigmoid(jnp.asarray(raw["opacity"][:, 0]))
    if opacity is not None:
        opa = jnp.full_like(opa, opacity)
    p = preprocess(
        jnp.asarray(raw["xyz"]), jnp.exp(jnp.asarray(raw["scaling"])),
        jnp.asarray(raw["rotation"]), cam.world_view, cam.full_proj,
        cam.camera_center, H, W, sh=jnp.asarray(raw["sh"]), sh_degree=0,
    )
    b = bin_gaussians(p, H, W, CFG, aligned=True)
    refl = jax.nn.sigmoid(jnp.asarray(raw["refl"][:, 0]))
    scope = jnp.asarray(np.random.default_rng(seed).uniform(size=n) < 0.8)
    attrs = (p.hom, p.xy, opa, p.normal_view, p.color, refl, scope)
    group = dict(group_key=b.aligned_rank, rank_of=b.rank_of,
                 seg_start=b.seg_start, seg_end=b.seg_end)
    org = tile_origins(H, W)
    return dict(
        binned=b, attrs=attrs,
        feats={pk: jtb.pack_features(b.aligned_gid, b.aligned_valid, *attrs,
                                     bf16_grads=pk, bf16_feats=pk, **group)
               for pk in (False, True)},
        index=(b.aligned_starts, b.tile_counts, org[:, 0], org[:, 1]),
    )


@pytest.fixture(scope="module")
def slabs():
    return {"random": _slab(150, 9), "opaque": _slab(200, 3, opacity=0.99)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("packed", [False, True])
def test_pack_features_exact(slabs, packed):
    s = slabs["random"]
    b = s["binned"]
    got = ttb.pack_features(_t(b.aligned_gid), _t(b.aligned_valid),
                            *(_t(a) for a in s["attrs"]), bf16_feats=packed)
    want = np.asarray(s["feats"][packed])
    assert got.shape == want.shape
    got = got.numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_pack2_bits_exact():
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.normal(size=500), [0.0, -0.0, 1.0, -1.0, 3.3895e38,
                                              1e-40, 65504.0]]).astype(np.float32)
    b = rng.permutation(a)
    want = np.asarray(jtb._pack2_bits(jnp.asarray(a), jnp.asarray(b)))
    got = ttb._pack2_bits(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    hi, lo = ttb._unpack2_bits(torch.from_numpy(got))
    jhi, jlo = jtb._unpack2_bits(jnp.asarray(want))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


# float32 rounding of a sum whose terms are this many times larger than the
# sum itself may move it by 2e-5 relative
KAPPA_MAX = 2e-5 * 2.0**24


def _cross(a, b):
    """a x b and the summed magnitudes of the products it subtracts."""
    p = [a[1] * b[2], a[2] * b[1], a[2] * b[0], a[0] * b[2], a[0] * b[1], a[1] * b[0]]
    val = np.stack([p[0] - p[1], p[2] - p[3], p[4] - p[5]])
    mag = np.stack([abs(p[0]) + abs(p[1]), abs(p[2]) + abs(p[3]), abs(p[4]) + abs(p[5])])
    return val, mag


def _depth_ill_conditioned(feats, index):
    """[T, 256] bool, from a float64 evaluation of the kernel's inputs: the
    pixels where an instance that may be composited there (alpha >= 1/255,
    depth >= 0.2) has a depth that float32 cannot give to 2e-5. The depth is
    p.Tw / p2 with p = x (Tv x Tw) + y (Tw x Tu) + Tu x Tv at the pixel
    centre (x, y); it is ill-conditioned where p2 or p.Tw sums terms more
    than KAPPA_MAX times larger than itself, or where |p2| sits near the
    1e-4 edge-on threshold, on whose two sides the depth differs."""
    f = np.asarray(feats, np.float64)
    starts, counts, org_x, org_y = (np.asarray(v) for v in index)
    lane = np.arange(ttb.L)
    ill = np.zeros((len(starts), ttb.L), bool)
    for t in range(len(starts)):
        g = f[:ttb.F_CON, starts[t]:starts[t] + counts[t], None]  # [12, n, 1]
        x = (org_x[t] + lane % 16).astype(np.float64)
        y = (org_y[t] + lane // 16).astype(np.float64)
        tu, tv, tw = g[0:3], g[3:6], g[6:9]
        (a, am), (b, bm), (c, cm) = _cross(tv, tw), _cross(tw, tu), _cross(tu, tv)
        p, pm = a * x + b * y + c, am * abs(x) + bm * abs(y) + cm  # [3, n, L]
        dn, dnm = (p * tw).sum(0), (pm * abs(tw)).sum(0)
        ap2 = abs(p[2])
        stable = ap2 >= 1e-4
        with np.errstate(divide="ignore", invalid="ignore"):
            s3 = np.where(stable, g[ttb.F_LO] - 0.5 * (p[0]**2 + p[1]**2) / p[2]**2, -np.inf)
            depth = np.where(stable, dn / p[2], tw[2])
            bad = stable & ((pm[2] > KAPPA_MAX * ap2) | (dnm > KAPPA_MAX * abs(dn)))
        fi = FILTER_INV_SQUARE
        s2 = g[ttb.F_LO] - 0.5 * fi * ((x - g[ttb.F_AX2] / fi)**2 + (y - g[ttb.F_AY2] / fi)**2)
        alpha = np.exp(np.minimum(np.log(0.99), np.maximum(s3, s2)))
        cand = (alpha >= (1 - 1e-3) / 255) & (depth >= 0.2 * (1 - 1e-3))
        bad |= (ap2 > 0.5e-4) & (ap2 < 2e-4)
        ill[t] = (cand & bad).any(0)
    return ill


_ABS_ROWS = (0, 1, 2, ttb.O_T, ttb.O_REFL, ttb.O_NRM, ttb.O_NRM + 1,
             ttb.O_NRM + 2, ttb.O_SCOPE, ttb.O_M1, ttb.O_M2)

VARIANTS = [
    # (scene, train_shape, packed_feats, collect_wmax): each flag both ways
    ("random", False, False, True),
    ("random", True, True, False),
    ("random", False, True, True),
    ("random", True, False, False),
    ("opaque", False, False, True),  # T < 1e-4 termination and early exit
]


@pytest.mark.parametrize("scene,train_shape,packed,collect_wmax", VARIANTS)
def test_tile_blend_forward_matches_jax(slabs, scene, train_shape, packed, collect_wmax):
    s = slabs[scene]
    feats = s["feats"][packed]
    kw = dict(train_shape=train_shape, packed_feats=packed, collect_wmax=collect_wmax)
    o_j, w_j = jtb.tile_blend_forward(feats, *s["index"], **kw)
    o_t, w_t = ttb.tile_blend_forward(_t(feats), *(_t(x) for x in s["index"]), **kw)
    o_j, w_j, o_t, w_t = np.asarray(o_j), np.asarray(w_j), o_t.numpy(), w_t.numpy()

    flip = o_j[:, ttb.O_NCON] != o_t[:, ttb.O_NCON]
    assert flip.sum() <= 8 * flip.size / 4096, flip.sum()
    keep = ~flip
    for r in _ABS_ROWS:
        np.testing.assert_allclose(o_t[:, r][keep], o_j[:, r][keep], rtol=0, atol=2e-5,
                                   err_msg=f"row {r}")
    # depth rows: 2e-5 relative to the depth the pixel composites (its
    # weighted mean for the depth sum), off the ill-conditioned pixels
    ill = _depth_ill_conditioned(feats, s["index"])
    assert ill.sum() <= ill.size / 200, ill.sum()
    mean_depth = np.abs(o_j[:, ttb.O_DEPTH]) / np.maximum(1.0 - o_j[:, ttb.O_T], 1e-3)
    for r, scale in ((ttb.O_DEPTH, mean_depth), (ttb.O_MED, np.abs(o_j[:, ttb.O_MED])),
                     (ttb.O_DIST, np.abs(o_j[:, ttb.O_DIST]))):
        tol = 2e-5 * np.maximum(1.0, scale)
        err = np.abs(o_t[:, r] - o_j[:, r])
        ok = (err <= tol) | ill | flip
        assert ok.all(), (r, float((err / tol)[~ok].max()), int((~ok).sum()))
    med_flip = o_j[:, ttb.O_MEDRANK] != o_t[:, ttb.O_MEDRANK]
    assert med_flip.sum() <= 8 * flip.size / 4096, med_flip.sum()
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=2e-5)
    if not collect_wmax:
        assert float(np.abs(w_t).max()) == 0.0
    if train_shape:
        for r in (ttb.O_DIST, ttb.O_MED, ttb.O_M1, ttb.O_M2, ttb.O_MEDRANK):
            assert float(np.abs(o_t[:, r]).max()) == 0.0
    if scene == "opaque":
        assert float(o_t[:, ttb.O_T].min()) < 1e-3  # saturated somewhere
