"""tpu_splat_torch backward kernels vs the JAX package, on the CPU.

Each kernel's plain PyTorch version (what the port's wrapper runs on CPU
tensors) against the JAX function on identical inputs; the JAX side runs its
Pallas kernels in interpret mode. Every JAX reference is computed once per
module.

Tolerances:
- tile_blend_backward: each d_feats row within 1e-3 of that row's max |value|
  (the JAX kernel sums its suffix and pixel reductions as matmuls, the port
  as sequential scans and sums; packed content rows are compared unpacked);
- the slab gather's regroup gradient (sort + segment sum + un-rank): 1e-3 of
  each input's max |gradient|, exact f32 and bf16-packed;
- segment_sum_ranges: 1e-6 relative to the largest |sum|;
- cubemap_tap_accumulate: 1e-5 of the largest |d_tex|;
- sample_cubemap gradients (texture, fail value, directions): 1e-5 of each
  one's max |gradient| (directions are drawn off the half-texel kinks).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_splat.data import random_scene, orbit_camera
from tpu_splat.envmap import cubemap as jcm
from tpu_splat.kernels import cubemap_accum as jca
from tpu_splat.kernels import segment_reduce as jsr
from tpu_splat.kernels import tile_blend as jtb
from tpu_splat.raster.binning import bin_gaussians
from tpu_splat.raster.blend import tile_origins
from tpu_splat.raster.config import RasterConfig
from tpu_splat.raster.preprocess import preprocess

from tpu_splat_torch.envmap import cubemap as tcm
from tpu_splat_torch.kernels import cubemap_accum as tca
from tpu_splat_torch.kernels import segment_reduce as tsr
from tpu_splat_torch.kernels import tile_blend as ttb

H = W = 48
CFG = RasterConfig(max_tiles_per_gaussian=16, max_instances=4096, tile_depth=256,
                   chunk=16, backend="pallas")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene():
    n, seed = 120, 4
    raw = random_scene(n, seed=seed)
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.3, elevation=0.2)
    opa = jax.nn.sigmoid(jnp.asarray(raw["opacity"][:, 0]))
    p = preprocess(
        jnp.asarray(raw["xyz"]), jnp.exp(jnp.asarray(raw["scaling"])),
        jnp.asarray(raw["rotation"]), cam.world_view, cam.full_proj,
        cam.camera_center, H, W, sh=jnp.asarray(raw["sh"]), sh_degree=0,
    )
    b = bin_gaussians(p, H, W, CFG, aligned=True)
    refl = jax.nn.sigmoid(jnp.asarray(raw["refl"][:, 0]))
    rng = np.random.default_rng(seed)
    scope = jnp.asarray(rng.uniform(size=n) < 0.8)
    attrs = (p.hom, p.xy, opa, p.normal_view, p.color, refl, scope)
    group = dict(group_key=b.aligned_rank, rank_of=b.rank_of,
                 seg_start=b.seg_start, seg_end=b.seg_end)
    org = tile_origins(H, W)
    index = (b.aligned_starts, b.tile_counts, org[:, 0], org[:, 1])
    feats = {pk: jtb.pack_features(b.aligned_gid, b.aligned_valid, *attrs,
                                   bf16_grads=pk, bf16_feats=pk, **group)
             for pk in (False, True)}
    T = index[0].shape[0]
    ct = rng.normal(size=(T, 16, ttb.L)).astype(np.float32)
    return dict(binned=b, attrs=attrs, group=group, index=index, feats=feats, ct=ct,
                rng=rng)


BWD_VARIANTS = [(full, packed) for full in (True, False) for packed in (False, True)]


@pytest.fixture(scope="module")
def backward_refs(scene):
    out = {}
    for full, packed in BWD_VARIANTS:
        feats = scene["feats"][packed]
        fwd, _ = jtb.tile_blend_forward(feats, *scene["index"], train_shape=not full,
                                        packed_feats=packed)
        d = jtb.tile_blend_backward(feats, *scene["index"], fwd, jnp.asarray(scene["ct"]),
                                    full_grads=full, packed_feats=packed)
        out[full, packed] = (np.asarray(fwd), np.asarray(d))
    return out


def _rows(d, packed):
    """d_feats -> [19, N] natural gradient rows (packed content unpacked)."""
    d = torch.as_tensor(np.asarray(d))
    if not packed:
        return d[:ttb.F_GRAD].numpy()
    hi, lo = ttb._unpack2_bits(d[12:16].contiguous())
    return torch.cat([d[:12], hi, lo[:3]]).numpy()


@pytest.mark.parametrize("full,packed", BWD_VARIANTS)
def test_tile_blend_backward_matches_jax(scene, backward_refs, full, packed):
    fwd, want = backward_refs[full, packed]
    got = ttb.tile_blend_backward(
        _t(scene["feats"][packed]), *(_t(x) for x in scene["index"]), _t(fwd),
        _t(scene["ct"]), full_grads=full, packed_feats=packed,
    )
    assert got.shape == want.shape
    assert float(got[ttb.F_GRAD:ttb.F_PAD].abs().max() if not packed else 0.0) == 0.0
    g, w = _rows(got, packed), _rows(want, packed)
    for r in range(ttb.F_GRAD):
        scale = np.abs(w[r]).max()
        assert scale > 0.0, r
        err = np.abs(g[r] - w[r]).max()
        assert err <= 1e-3 * scale, (r, err, scale)


def _runs(rng, P_, N):
    """Ascending runs with gaps and empty runs, inside [0, N)."""
    lens = rng.integers(0, 9, P_)
    lens[rng.uniform(size=P_) < 0.2] = 0
    gaps = rng.integers(0, 4, P_)
    starts = np.cumsum(gaps + np.concatenate([[0], lens[:-1]]))
    ends = starts + lens
    assert ends[-1] <= N
    return starts.astype(np.int32), ends.astype(np.int32)


def test_segment_sum_ranges_matches_jax():
    rng = np.random.default_rng(11)
    F, N, P_ = 19, 4096, 500
    rows = rng.normal(size=(F, N)).astype(np.float32)
    starts, ends = _runs(rng, P_, N)
    want = np.asarray(jsr.segment_sum_ranges(jnp.asarray(rows), jnp.asarray(starts),
                                             jnp.asarray(ends)))
    got = tsr.segment_sum_ranges(_t(rows), _t(starts), _t(ends)).numpy()
    assert got.shape == (F, P_)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert (got[:, starts == ends] == 0.0).all()


@pytest.fixture(scope="module")
def cubemap():
    """One JAX sample_cubemap backward at L = 8 (padded 10), with the tap
    data it hands its kernel captured: pixels of a smooth reflection map,
    whose blocks keep the separable path, then random directions, whose
    blocks span more rows than the window and demote to the generic path.
    Returns the inputs, the captured (args, kw, d_tex) and the gradients of
    <sample, g> in texture, fail value and directions."""
    rng = np.random.default_rng(5)
    L = 8
    tex = rng.uniform(-1, 1, (6, 3, L, L)).astype(np.float32)
    fail = rng.uniform(-1, 1, 3).astype(np.float32)
    smooth = np.stack(np.meshgrid(np.linspace(-0.3, 0.31, 32), np.linspace(-0.2, 0.23, 32)),
                      -1).reshape(-1, 2)
    dirs = np.concatenate([
        np.concatenate([smooth, np.full((1024, 1), 0.9)], 1),
        rng.normal(size=(1024, 3)),
    ]).astype(np.float32).reshape(64, 32, 3)
    dirs[40, 0] = 0.0  # the fail value's pixel
    g = rng.normal(size=(64, 32, 3)).astype(np.float32)
    seen = []
    kernel = jca.cubemap_tap_accumulate

    def keep(*args, **kw):
        out = kernel(*args, **kw)
        seen.append(([np.asarray(a) for a in args], kw, np.asarray(out)))
        return out

    def jf(tx, fv, d):
        return jnp.sum(jcm.sample_cubemap(jcm.CubemapParams(tx, fv), d) * g)

    jca.cubemap_tap_accumulate = keep
    try:
        grads = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(tex), jnp.asarray(fail),
                                                jnp.asarray(dirs))
    finally:
        jca.cubemap_tap_accumulate = kernel
    (taps,) = seen
    return dict(tex=tex, fail=fail, dirs=dirs, g=g, taps=taps,
                grads=[np.asarray(x) for x in grads])


def test_cubemap_tap_accumulate_matches_jax(cubemap):
    args, kw, want = cubemap["taps"]
    L, C = kw["L"], kw["C"]
    assert L == 10  # the padded texture
    # the random half spans every face: its blocks demote to the generic path
    rows = args[4].reshape(-1, 512)
    assert (rows.max(1) - rows.min(1)).max() > 6 * L - 8
    got = tca.cubemap_tap_accumulate(*(_t(a) for a in args), L=L, C=C).numpy()
    assert got.shape == (6 * L * L, C)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_sample_cubemap_gradients_match_jax(cubemap):
    tt, tf, td = (torch.tensor(cubemap[k], requires_grad=True) for k in ("tex", "fail", "dirs"))
    out = tcm.sample_cubemap(tcm.CubemapParams(tt, tf), td)
    got = torch.autograd.grad((out * torch.from_numpy(cubemap["g"])).sum(), (tt, tf, td))
    for name, a, b in zip(("texture", "fail", "dirs"), got, cubemap["grads"]):
        assert np.abs(b).max() > 0.0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("packed", [False, True])
def test_pack_features_regroup_gradient_matches_jax(scene, packed):
    b = scene["binned"]
    attrs = scene["attrs"]
    n_rows = ttb.F_IN_PACKED if packed else ttb.F_PAD
    R = np.random.default_rng(2).normal(size=(n_rows, b.aligned_gid.shape[0])).astype(np.float32)
    if packed:
        # the content rows of a packed slab carry bf16-pair words: weight
        # them by 0 so the sum stays a function of the geometry rows, and
        # give their gradient words directly below
        R[12:] = 0.0

    def jf(hom, xy, opa, nrm, col, refl):
        feats = jtb.pack_features(b.aligned_gid, b.aligned_valid, hom, xy, opa, nrm, col,
                                  refl, attrs[6], bf16_grads=packed, bf16_feats=packed,
                                  **scene["group"])
        return jnp.sum(feats * R)

    want = jax.grad(jf, argnums=tuple(range(6)))(*attrs[:6])
    leaves = [torch.tensor(np.array(a), requires_grad=True) for a in attrs[:6]]
    feats = ttb.pack_features(_t(b.aligned_gid), _t(b.aligned_valid), *leaves,
                              _t(attrs[6]), bf16_grads=packed, bf16_feats=packed,
                              **{k: _t(v) for k, v in scene["group"].items()})
    got = torch.autograd.grad((feats * torch.from_numpy(R)).sum(), leaves)
    for k, (a, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-3 * scale, err_msg=str(k))
