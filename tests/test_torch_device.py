"""tpu_splat_torch on its own: import isolation, device selection, input
checks, and each CUDA kernel against its plain version on the card.

This file imports neither JAX nor the JAX package, so on a machine with a
CUDA card and no JAX the card tests run with

    python -m pytest --noconftest -m gpu tests/test_torch_device.py

The `gpu` tests skip inside the test body when no card is present.
Tolerances of the kernel against its plain version: colour, T, normal,
refl, scope, M1, M2 and wmax 2e-5 abs; depth rows 2e-5 relative to the
depth the pixel composites (the weighted mean for the depth sum), as
tests/test_torch_kernel.py holds them; n_contrib and the median rank exact
except at the T < 1e-4 knife edge (at most 8 per 4096 px); on a tile built
to put pairs at alpha = 1/255 a wmax slot may differ once for each pixel
whose n_contrib flipped there (PARITY.md D4). Both versions
derive the per-instance coefficients in double and round the edge-on
sensitive fields (p2, the depth numerator) alike (csrc/tile_blend_fwd.cu);
elsewhere the kernel may fuse multiply-adds. tile_blend_backward: each
d_feats row within 1e-3 of the row's max |value| (the kernel sums its
suffixes and pixel reductions in another order; packed content compared
unpacked). segment_sum_ranges: 1e-6 of the largest |sum| (both sum each
run in order). cubemap_tap_accumulate: 1e-5 of the largest |d_tex| (float
atomics add in run-dependent order); under contention each texel within
(n_t - 1) * 2^-24 * S_t, recursive summation's bound for its n_t terms of
absolute sum S_t. run_expand: rows and j bit-exact (a
copy). segment_sum_rows: 1e-6 of each column's max |sum| (both sum each run
in order). Tight binning on the card against the CPU: every field exact.
The training step on the card against the CPU run: losses 1e-5 relative, every gradient 1e-2 of its leaf's max
(the production bf16 regroup; tests/test_torch_train.py). Preprocess on
the card against the CPU: what binning reads, bit for bit. Mesh
extraction on the card against the CPU on the same maps: the tsdf within
1e-6, weights, vertices and faces exact (both fuse with the same float64
steps, written out without fused multiply-adds); the viewer's frame maps
and uint8 encoder: the CPU's bits. The volumetric preprocess on the card
against the CPU: bit for bit (core/f32.py); the volumetric frame's kernels
against their plain versions: the kernel tolerances above. The scan blend
(backend="xla") on the card against the CPU: the images 2e-5 abs except at
most 8 pixels per 4096, gradients 1e-3 of each input's max. Binning with
expand_mode="scan" on the card: every field equal to the CPU's and to
"gather"'s. The tile-sharded step over two gloo ranks on one card against
the unsharded step: the loss 1e-5 relative, the image 2e-5, every gradient
1e-3 of its leaf's max, the ranks' parameters bit-identical.
"""
import importlib
import itertools
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_splat_torch.data.synthetic import orbit_camera, random_scene
from tpu_splat_torch.config import OptimizationParams
from tpu_splat_torch.isp.ppisp import ISPConfig
from tpu_splat_torch.kernels import LAUNCHES, build
from tpu_splat_torch.kernels import cubemap_accum as ca
from tpu_splat_torch.kernels import run_expand as re_
from tpu_splat_torch.kernels import segment_reduce as sr
from tpu_splat_torch.kernels import tile_blend as tb
from tpu_splat_torch.model.convert import camera_from_numpy, state_from_numpy
from tpu_splat_torch.raster.binning import bin_gaussians
from tpu_splat_torch.raster.blend import tile_origins
from tpu_splat_torch.raster.config import RasterConfig, production_config
from tpu_splat_torch.raster.preprocess import preprocess
from tpu_splat_torch.renderer import render_fast
from tpu_splat_torch.train.step import TrainState, make_train_step

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
H, W = 64, 96
KW = dict(max_tiles_per_gaussian=16, max_instances=8192, tile_depth=256, chunk=16)
TOL = 2e-5


def _scene(n, seed, opacity=None):
    raw = random_scene(n, seed=seed, sh_degree=1)
    rng = np.random.default_rng(seed)
    opa = raw["opacity"] if opacity is None else np.full_like(raw["opacity"], opacity)
    return dict(
        xyz=raw["xyz"], features_dc=raw["sh"][:, :1], features_rest=raw["sh"][:, 1:],
        scaling=raw["scaling"], rotation=raw["rotation"], opacity=opa, refl=raw["refl"],
        texture=rng.uniform(-0.5, 0.5, (6, 3, 8, 8)).astype(np.float32),
        fail_value=np.zeros(3, np.float32), alive=np.ones(n, bool),
        active_sh_degree=1, max_sh_degree=1,
    )


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_splat_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpu_splat_torch.__path__, 'tpu_splat_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpu_splat'))\n"
        "new = {'tpu_splat_torch.scripts.validate_e2e', 'tpu_splat_torch.eval.parity',\n"
        "       'tpu_splat_torch.tools', 'tpu_splat_torch.tools.parity',\n"
        "       'tpu_splat_torch.tools.scaling_table', 'tpu_splat_torch.scripts.bench',\n"
        "       'tpu_splat_torch.tools.profile'}\n"
        "print(len(mods), bad, sorted(new - set(mods)))\n"
        "sys.exit(1 if bad or new - set(mods) or len(mods) < 89 else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("entry", ["state", "camera", "orbit_camera", "extract_mesh", "view",
                                   "test_rasterizer", "validate_e2e", "parity", "bench",
                                   "profile"])
def test_cuda_request_without_cuda_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _scene(8, 0)
    cam = {k: np.eye(4, dtype=np.float32) for k in ("world_view", "proj", "full_proj")}
    cam.update(camera_center=np.zeros(3, np.float32), K=np.eye(3, dtype=np.float32),
               height=16, width=16, fovx=0.8, fovy=0.8, znear=0.01, zfar=100.0)
    call = {
        "state": lambda: state_from_numpy(d),
        "camera": lambda: camera_from_numpy(cam),
        "orbit_camera": lambda: orbit_camera(16, 16),
        # the slice-8 CLIs run on "cuda" unless their caller passes "cpu"
        "extract_mesh": lambda: _script("extract_mesh").main(["-m", "no_such_model"]),
        "view": lambda: _script("view").main(["-m", "no_such_model"]),
        "test_rasterizer": lambda: _script("test_rasterizer").main(["--headless"]),
        # the convergence certificate and the parity CLI: the card unless --device cpu
        "validate_e2e": lambda: _script("validate_e2e").main(["--task", "recover"]),
        "parity": lambda: importlib.import_module("tpu_splat_torch.tools.parity").main([]),
        # the measurement scripts: the card unless --device cpu
        "bench": lambda: _script("bench").main([]),
        "profile": lambda: importlib.import_module("tpu_splat_torch.tools.profile").main([]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def _script(name):
    import importlib

    return importlib.import_module(f"tpu_splat_torch.scripts.{name}")


def test_tile_blend_forward_checks_its_inputs():
    feats = torch.zeros((tb.F_PAD, 256))
    idx = [torch.zeros(2, dtype=torch.int32) for _ in range(4)]
    with pytest.raises(ValueError, match="feats"):
        tb.tile_blend_forward(feats, *idx, packed_feats=True)
    with pytest.raises(ValueError, match="starts"):
        tb.tile_blend_forward(feats, idx[0].long(), *idx[1:])
    out, wmax = tb.tile_blend_forward(feats, *idx)
    assert out.shape == (2, 16, tb.L) and wmax.shape == (256,)
    assert float(out[:, tb.O_T].min()) == 1.0  # empty tiles stay transparent


def _kernel_inputs(d, device, **over):
    st = state_from_numpy(d, device=device)
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.3, elevation=0.2, device=device)
    cfg = RasterConfig(**dict(KW, **over))
    p = preprocess(st.xyz, st.get_scaling(), st.rotation, cam.world_view, cam.full_proj,
                   cam.camera_center, H, W, sh=st.get_features(), sh_degree=1)
    b = bin_gaussians(p, H, W, cfg)
    scope = torch.ones_like(st.alive)
    feats = {pk: tb.pack_features(b.aligned_gid, b.aligned_valid, p.hom, p.xy,
                                  st.get_opacity(), p.normal_view, p.color, st.get_refl(),
                                  scope, bf16_feats=pk)
             for pk in (False, True)}
    org = tile_origins(H, W, device=device)
    return feats, (b.aligned_starts, b.tile_counts, org[:, 0].contiguous(),
                   org[:, 1].contiguous())


def _assert_forward_matches_plain(feats, index, knife_edge=False):
    """Every static variant of the forward kernel against the plain version
    on the same inputs (feats maps packed_feats to its slab); returns the
    kernel's outputs by variant. knife_edge: inputs built to put pairs at
    alpha = 1/255, where the two versions' roundings may flip an accept
    (PARITY.md D4); a wmax slot may then differ once for each pixel whose
    n_contrib flipped."""
    abs_rows = [0, 1, 2, tb.O_T, tb.O_REFL, tb.O_NRM, tb.O_NRM + 1, tb.O_NRM + 2,
                tb.O_SCOPE, tb.O_M1, tb.O_M2]
    outs = {}
    for train, packed, wm in itertools.product((False, True), repeat=3):
        kw = dict(train_shape=train, packed_feats=packed, collect_wmax=wm)
        before = LAUNCHES["tile_blend_forward"]
        o_k, w_k = tb.tile_blend_forward(feats[packed], *index, **kw)
        assert LAUNCHES["tile_blend_forward"] == before + 1
        o_p, w_p = tb.tile_blend_forward_plain(feats[packed], *index, **kw)
        o_k, o_p = o_k.cpu().numpy(), o_p.cpu().numpy()
        flip = o_k[:, tb.O_NCON] != o_p[:, tb.O_NCON]
        assert flip.sum() <= 8 * flip.size / 4096, (kw, flip.sum())
        keep = ~flip
        for r in abs_rows:
            np.testing.assert_allclose(o_k[:, r][keep], o_p[:, r][keep], rtol=0, atol=TOL,
                                       err_msg=f"{kw} row {r}")
        mean_depth = np.abs(o_p[:, tb.O_DEPTH]) / np.maximum(1.0 - o_p[:, tb.O_T], 1e-3)
        for r, scale in ((tb.O_DEPTH, mean_depth), (tb.O_MED, np.abs(o_p[:, tb.O_MED])),
                         (tb.O_DIST, np.abs(o_p[:, tb.O_DIST]))):
            d = np.abs(o_k[:, r] - o_p[:, r])[keep]
            assert (d <= TOL * np.maximum(1.0, scale[keep])).all(), (kw, r)
        if knife_edge:
            n_off = int(((w_k - w_p).abs() > TOL).sum())
            assert n_off <= int(flip.sum()), (kw, n_off, int(flip.sum()))
        else:
            np.testing.assert_allclose(w_k.cpu().numpy(), w_p.cpu().numpy(), rtol=0, atol=TOL)
        outs[(train, packed, wm)] = o_k
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("opacity", [None, 4.6], ids=["random", "opaque"])
def test_tile_blend_kernel_matches_plain_on_card(opacity):
    _need_card()
    feats, index = _kernel_inputs(_scene(300, 5, opacity), "cuda")
    _assert_forward_matches_plain(feats, index)


def _retile(feats, tiles):
    """A slab and index of synthetic tiles: tiles is a list of (slab
    columns, org_x, org_y); each tile's columns go to a 128-aligned range of
    a new slab (of both layouts in feats), in the given order."""
    starts, cols, at = [], [], 0
    for c, _, _ in tiles:
        starts.append(at)
        cols.append(c)
        pad = -c.numel() % tb.CI
        cols.append(torch.full((pad,), -1, dtype=torch.long, device=c.device))
        at += c.numel() + pad
    cols = torch.cat(cols)
    out = {pk: torch.where(cols >= 0, f[:, cols.clamp(min=0)], 0.0) for pk, f in feats.items()}
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=cols.device)
    return out, (i32(starts), i32([c.numel() for c, _, _ in tiles]),
                 i32([x for _, x, _ in tiles]), i32([y for _, _, y in tiles]))


def _exponents(fb, ox, oy):
    """(s3, s2) of a tile's instances at its 256 pixels in float64, each
    [count, 256]: the kernel's alpha is exp(min(log 0.99, max(s3, s2)))."""
    g = fb.double()
    c = lambda v: torch.tensor([[v + 7.0]], dtype=torch.float64, device=g.device)
    A, B, cp, _, _, _, sx, sy, s0, lo = tb._instance_coeffs(g, c(ox), c(oy))
    px, py, r2 = tb._pixel_basis(g.device, torch.float64)
    field = lambda a, b, c: a[..., None] * px + b[..., None] * py + c[..., None]
    p0, p1, p2 = (field(A[k], B[k], cp[k]) for k in range(3))
    s2 = field(sx, sy, s0) - 0.5 * tb.FILTER_INV_SQUARE * r2
    s3 = torch.where(p2.abs() < 1e-4, -1e8, lo[..., None] - 0.5 * (p0 ** 2 + p1 ** 2) / p2 ** 2)
    return s3[0], s2[0]


@pytest.mark.gpu
def test_tile_blend_forward_edge_tiles_on_card():
    """Synthetic tiles built from a semi-transparent scene's heaviest tile:
    no instances; its own ragged count; repeated out to the production
    tile_depth (16 chunks); moved far from its instances (no pair passes the
    alpha test); and with each log-opacity set so that the instance's
    strongest pixel sits within 2e-3 of log(1/255), across the kernel's
    reject margin. All eight variants against the plain version."""
    _need_card()
    feats, index = _kernel_inputs(_scene(900, 11, opacity=-1.5), "cuda")
    starts, counts, ox, oy = (x.cpu() for x in index)
    h = int(torch.argmax(counts))
    n = int(counts[h])
    assert n > tb.CI and n % tb.CI != 0
    own = torch.arange(int(starts[h]), int(starts[h]) + n, device="cuda")
    depth = own[torch.arange(2048) % n]
    org = (int(ox[h]), int(oy[h]))
    # the margin tile reads its own copy of the columns, each log-opacity
    # set so that the exponent at the instance's strongest pixel lands
    # within [-2e-3, 1e-3] of log(1/255)
    rng = np.random.default_rng(4)
    at = feats[False].shape[1]
    s3, _ = _exponents(feats[False][:, own], *org)
    r3h_min = (feats[False][tb.F_LO, own].double()[:, None] - s3).amin(1)
    target = torch.tensor(math.log(1 / 255) + rng.uniform(-2e-3, 1e-3, n), device="cuda")
    lo = (target + torch.where(r3h_min < 3.0, r3h_min, 0.0)).float()
    marg = {}
    for pk, f in feats.items():
        m = f[:, own].clone()
        m[tb.F_LO] = lo
        marg[pk] = torch.cat([f, m], dim=1)
    margin_cols = torch.arange(at, at + n, device="cuda")
    e = torch.maximum(*_exponents(marg[False][:, margin_cols], *org))
    band = ((e >= math.log(1 / 255) - 2.0 ** -10) & (e < math.log(1 / 255) + 1e-3)).sum()
    assert int(band) >= 100, int(band)
    slab, idx = _retile(marg, [(own[:0], *org), (own, *org), (depth, *org),
                               (own, org[0] + 4096, org[1] + 4096), (margin_cols, *org)])
    assert idx[1].tolist() == [0, n, 2048, n, n]
    outs = _assert_forward_matches_plain(slab, idx, knife_edge=True)
    for o in outs.values():
        assert (o[0, tb.O_T] == 1.0).all() and (o[0, tb.O_NCON] == 0).all()  # empty
        assert (o[3, tb.O_T] == 1.0).all() and (o[3, tb.O_NCON] == 0).all()  # none pass
        assert (o[4, tb.O_NCON] > 0).any()  # pairs at the margin contribute


@pytest.mark.gpu
def test_tile_blend_forward_opaque_front_on_card():
    """Three large opaque surfels facing the camera in front of the scene:
    every pixel is done after its tile's first chunk, and the kernel skips
    the later chunks (all eight variants against the plain version)."""
    _need_card()
    d = _scene(900, 11, opacity=-1.5)
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.3, elevation=0.2, device="cpu")
    c = cam.camera_center.numpy().astype(np.float64)
    v = c / np.linalg.norm(c)
    q = np.array([1.0 + v[2], -v[1], v[0], 0.0])  # turns the surfel normal (z) onto v
    front = dict(xyz=np.stack([c * f for f in (0.55, 0.5, 0.45)]).astype(np.float32),
                 scaling=np.full((3, 2), 1.5, np.float32),
                 rotation=np.tile(q / np.linalg.norm(q), (3, 1)).astype(np.float32),
                 opacity=np.full((3, 1), 8.0, np.float32))
    for k in ("features_dc", "features_rest", "refl"):
        front[k] = d[k][:3]
    for k, x in front.items():
        d[k] = np.concatenate([x, d[k]])
    d["alive"] = np.ones(d["xyz"].shape[0], bool)
    feats, index = _kernel_inputs(d, "cuda", max_tiles_per_gaussian=64)
    assert int(index[1].max()) > tb.CI
    outs = _assert_forward_matches_plain(feats, index)
    for o in outs.values():
        # the front layers cover every pixel (alpha 0.99 each), and nothing
        # behind them counts
        assert (o[:, tb.O_T] <= 0.0101).all() and (o[:, tb.O_NCON] <= 3).all()


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 19, 32])
def test_segment_sum_rows_edge_runs_on_card(F):
    """Empty runs, gaps between runs, a run longer than the kernel's row
    buffer (8192 floats) and rows whose base is not 16-byte aligned."""
    _need_card()
    rng = np.random.default_rng(F)
    P_ = 3000
    lens = rng.integers(0, 9, P_)
    lens[rng.uniform(size=P_) < 0.25] = 0
    lens[1234] = 20_000
    gaps = rng.integers(0, 3, P_) * (rng.uniform(size=P_) < 0.3)
    starts = np.cumsum(gaps + np.concatenate([[0], lens[:-1]]))
    ends = starts + lens
    N = int(ends[-1]) + 7
    s, e = (torch.tensor(x.astype(np.int32), device="cuda") for x in (starts, ends))
    big = torch.tensor(rng.normal(size=(N + 1, F)).astype(np.float32), device="cuda")
    for rows in (big[:N], big[1:]):
        got = sr.segment_sum_rows(rows, s, e)
        want = sr.segment_sum_rows_plain(rows.cpu(), s.cpu(), e.cpu())
        scale = want.abs().amax(0)
        assert bool(((got.cpu() - want).abs() <= 1e-6 * scale).all()), F
        assert bool((got.cpu()[torch.from_numpy(lens == 0)] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["production", "full"])
def test_render_fast_on_card_matches_cpu(name):
    _need_card()
    cfg = production_config(**KW) if name == "production" else RasterConfig(**KW)
    d = _scene(300, 6)
    out = {}
    for dev in ("cpu", "cuda"):
        st = state_from_numpy(d, device=dev)
        cam = orbit_camera(H, W, radius=4.0, azimuth=0.5, elevation=0.2, device=dev)
        out[dev] = render_fast(st, cam, cfg, torch.tensor([0.1, 0.2, 0.3], device=dev),
                               collect_weights=False)
    a, b = out["cpu"], out["cuda"]
    assert int(a.num_instances) == int(b.num_instances)
    for f in ("render", "alpha", "refl_strength"):
        diff = (getattr(b, f).cpu() - getattr(a, f)).abs().amax(-1)
        # the card's matmuls round the homography apart from the CPU's; the
        # T < 1e-4 knife edge may then flip a few pixels (PARITY.md D4)
        assert int((diff > TOL).sum()) <= 8 * diff.numel() / 4096, (f, float(diff.max()))


def test_new_wrappers_check_their_inputs():
    f32, i32 = torch.float32, torch.int32
    rows = torch.zeros((19, 64))
    se = torch.zeros(4, dtype=i32)
    with pytest.raises(ValueError, match="rows_T"):
        sr.segment_sum_ranges(rows.double(), se, se)
    with pytest.raises(ValueError, match="starts"):
        sr.segment_sum_ranges(rows, se.long(), se)
    with pytest.raises(ValueError, match="ends"):
        sr.segment_sum_ranges(rows, se, torch.zeros(3, dtype=i32))
    assert sr.segment_sum_ranges(rows, se, se).shape == (19, 4)

    feats = torch.zeros((tb.F_PAD, 256))
    idx = [torch.zeros(2, dtype=i32) for _ in range(4)]
    px = torch.zeros((2, 16, tb.L))
    with pytest.raises(ValueError, match="feats"):
        tb.tile_blend_backward(feats, *idx, px, px, packed_feats=True)
    with pytest.raises(ValueError, match="fwd_px"):
        tb.tile_blend_backward(feats, *idx, px[:1], px)
    with pytest.raises(ValueError, match="ct_px"):
        tb.tile_blend_backward(feats, *idx, px, px.double())
    assert float(tb.tile_blend_backward(feats, *idx, px, px).abs().max()) == 0.0

    n, L, C = 8, 4, 3
    g = torch.zeros((n, C))
    ints = [torch.zeros((4, n), dtype=i32)] * 2
    tw = torch.zeros((4, n))
    sep_i = [torch.zeros(n, dtype=i32)] * 4
    sep_f = [torch.zeros(n)] * 3
    with pytest.raises(ValueError, match="g must"):
        ca.cubemap_tap_accumulate(g.double(), *ints, tw, *sep_i, *sep_f, L=L, C=C)
    with pytest.raises(ValueError, match="C must"):
        ca.cubemap_tap_accumulate(torch.zeros((n, 9)), *ints, tw, *sep_i, *sep_f, L=L, C=9)
    with pytest.raises(ValueError, match="tap_w"):
        ca.cubemap_tap_accumulate(g, *ints, tw[:, :3], *sep_i, *sep_f, L=L, C=C)
    with pytest.raises(ValueError, match="sep_r0"):
        ca.cubemap_tap_accumulate(g, *ints, tw, sep_i[0].float(), *sep_i[1:], *sep_f, L=L, C=C)
    with pytest.raises(ValueError, match="all given or all None"):
        ca.cubemap_tap_accumulate(g, None, None, tw, *sep_i, *sep_f, L=L, C=C)
    assert ca.cubemap_tap_accumulate(g, *ints, tw, *sep_i, *sep_f, L=L, C=C).shape == (6 * L * L, C)
    assert ca.cubemap_tap_accumulate(g, None, None, None, *sep_i, *sep_f,
                                     L=L, C=C).shape == (6 * L * L, C)


@pytest.mark.gpu
def test_failed_build_raises_and_does_not_fall_back(monkeypatch):
    """A CUDA tensor whose kernel cannot be built raises; the plain version
    never stands in for it."""
    _need_card()

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(build, "load", broken)
    before = dict(LAUNCHES)
    dev = "cuda"
    i32 = torch.int32
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sr.segment_sum_ranges(torch.zeros((19, 64), device=dev),
                              torch.zeros(4, dtype=i32, device=dev),
                              torch.zeros(4, dtype=i32, device=dev))
    idx = [torch.zeros(2, dtype=i32, device=dev) for _ in range(4)]
    px = torch.zeros((2, 16, tb.L), device=dev)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tb.tile_blend_forward(torch.zeros((tb.F_PAD, 256), device=dev), *idx)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tb.tile_blend_backward(torch.zeros((tb.F_PAD, 256), device=dev), *idx, px, px)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        re_.run_expand(torch.zeros((4, 5), device=dev), torch.zeros(4, dtype=i32, device=dev),
                       torch.zeros((), dtype=i32, device=dev),
                       torch.zeros(32, dtype=i32, device=dev), 4096)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sr.segment_sum_rows(torch.zeros((64, 19), device=dev),
                            torch.zeros(4, dtype=i32, device=dev),
                            torch.zeros(4, dtype=i32, device=dev))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        n = 8
        ca.cubemap_tap_accumulate(
            torch.zeros((n, 3), device=dev), *[torch.zeros((4, n), dtype=i32, device=dev)] * 2,
            torch.zeros((4, n), device=dev), *[torch.zeros(n, dtype=i32, device=dev)] * 4,
            *[torch.zeros(n, device=dev)] * 3, L=4, C=3)
    assert dict(LAUNCHES) == before


def _unpacked_rows(d, packed):
    if not packed:
        return d[:tb.F_GRAD]
    hi, lo = tb._unpack2_bits(d[12:16].contiguous())
    return torch.cat([d[:12], hi, lo[:3]])


@pytest.mark.gpu
@pytest.mark.parametrize("opacity", [None, 4.6], ids=["random", "opaque"])
def test_tile_blend_backward_kernel_matches_plain_on_card(opacity):
    _need_card()
    feats, index = _kernel_inputs(_scene(300, 5, opacity), "cuda")
    g = torch.Generator().manual_seed(0)
    for full, packed in itertools.product((True, False), repeat=2):
        fwd, _ = tb.tile_blend_forward(feats[packed], *index, train_shape=not full,
                                       packed_feats=packed)
        ct = torch.randn(fwd.shape, generator=g).to("cuda")
        before = LAUNCHES["tile_blend_backward"]
        d_k = tb.tile_blend_backward(feats[packed], *index, fwd, ct, full_grads=full,
                                     packed_feats=packed)
        assert LAUNCHES["tile_blend_backward"] == before + 1
        d_p = tb.tile_blend_backward_plain(feats[packed], *index, fwd, ct, full_grads=full,
                                           packed_feats=packed)
        a, b = _unpacked_rows(d_k, packed).cpu(), _unpacked_rows(d_p, packed).cpu()
        scale = b.abs().amax(1, keepdim=True)
        assert bool(((a - b).abs() <= 1e-3 * scale).all()), (full, packed)


@pytest.mark.gpu
def test_segment_sum_and_cubemap_kernels_match_plain_on_card():
    _need_card()
    rng = np.random.default_rng(2)
    F, N, P_ = 19, 50_000, 12_000
    lens = rng.integers(0, 9, P_)
    lens[rng.uniform(size=P_) < 0.2] = 0
    starts = np.cumsum(rng.integers(0, 3, P_) + np.concatenate([[0], lens[:-1]]))
    ends = starts + lens
    rows = torch.tensor(rng.normal(size=(F, N)).astype(np.float32), device="cuda")
    s, e = (torch.tensor(x.astype(np.int32), device="cuda") for x in (starts, ends))
    got = sr.segment_sum_ranges(rows, s, e)
    want = sr.segment_sum_ranges_plain(rows, s, e)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())

    L, C, n = 10, 3, 20_000
    r0 = rng.integers(0, 6 * L - 1, n)
    c0 = rng.integers(0, L - 1, n)
    dev = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device="cuda")
    i32, f32 = torch.int32, torch.float32
    m = (rng.uniform(size=n) < 0.9).astype(np.float32)
    tap_w = rng.uniform(size=(4, n)).astype(np.float32) * (1 - m)
    args = (dev(rng.normal(size=(n, C)), f32),
            dev(rng.integers(0, 6 * L, (4, n)), i32), dev(rng.integers(0, L, (4, n)), i32),
            dev(tap_w, f32), dev(r0, i32), dev(r0 + 1, i32), dev(c0, i32), dev(c0 + 1, i32),
            dev(rng.uniform(size=n), f32), dev(rng.uniform(size=n), f32), dev(m, f32))
    # with the generic taps, and separable only (the sampler's call)
    sep_only = (args[0], None, None, None) + args[4:10] + (torch.ones_like(args[10]),)
    for a in (args, sep_only):
        got = ca.cubemap_tap_accumulate(*a, L=L, C=C)
        want = ca.cubemap_tap_accumulate_plain(*a, L=L, C=C)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("generic", [False, True], ids=["separable", "generic"])
@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("pattern", ["one_texel", "distinct", "neighbours"])
def test_cubemap_kernel_contention_on_card(pattern, L, generic):
    """The block-table kernel against the plain version: every pixel's taps
    on one texel (the worst contention), every pixel on texels of its own
    (with the generic taps, more texels a block than its table holds), and
    runs of neighbouring pixels sharing cells as a smooth reflector gives
    them; every L the step serves, with and without the generic taps."""
    _need_card()
    rng = np.random.default_rng(L + 7 * generic)
    C, n = 3, 8192 + 13  # a ragged last warp
    if pattern == "one_texel":
        r0 = np.full(n, 3 * L + 5)
        c0 = np.full(n, L // 2)
        r1, c1 = r0, c0
    elif pattern == "distinct":
        cell = rng.permutation(6 * (L // 2) * (L // 2))[:n]
        r0, c0 = 2 * (cell // (L // 2)), 2 * (cell % (L // 2))
        r1, c1 = r0 + 1, c0 + 1
    else:
        cell = np.repeat(rng.integers(0, 6 * L * (L - 1), (n + 19) // 20), 20)[:n]
        r0, c0 = cell // (L - 1), cell % (L - 1)
        r1, c1 = r0 + 1, c0 + 1
    dev = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device="cuda")
    i32, f32 = torch.int32, torch.float32
    m = (rng.uniform(size=n) < 0.8).astype(np.float32) if generic else np.ones(n, np.float32)
    if generic:
        same = pattern == "one_texel"
        taps = (dev(np.broadcast_to(r0, (4, n)) if same else rng.integers(0, 6 * L, (4, n)), i32),
                dev(np.broadcast_to(c0, (4, n)) if same else rng.integers(0, L, (4, n)), i32),
                dev(rng.uniform(size=(4, n)) * (1 - m), f32))
    else:
        taps = (None, None, None)
    args = (dev(rng.normal(size=(n, C)), f32), *taps, dev(r0, i32), dev(r1, i32),
            dev(c0, i32), dev(c1, i32), dev(rng.uniform(size=n), f32),
            dev(rng.uniform(size=n), f32), dev(m, f32))
    before = LAUNCHES["cubemap_tap_accumulate"]
    got = ca.cubemap_tap_accumulate(*args, L=L, C=C)
    assert LAUNCHES["cubemap_tap_accumulate"] == before + 1
    want = ca.cubemap_tap_accumulate_plain(*args, L=L, C=C)
    assert got.shape == (6 * L * L, C)
    # Both sum the same float32 terms (each formed alike), in another
    # order: a texel's bound is that of recursive summation, (n_t - 1) *
    # 2^-24 * S_t, with n_t its number of terms and S_t = sum |terms| (the
    # weights are non-negative, so the plain version on |g| gives S_t). A
    # texel with one term or none has no sum to reorder: exact (floor 0).
    S = ca.cubemap_tap_accumulate_plain(args[0].abs(), *args[1:], L=L, C=C)
    idx, w = ca.tap_rows(*args[1:], L=L)
    n_terms = torch.zeros(6 * L * L, dtype=torch.float64, device="cuda").index_add_(
        0, idx.reshape(-1), (w != 0.0).reshape(-1).double())
    bound = (n_terms - 1.0).clamp(min=0.0)[:, None] * 2.0**-24 * S.double()
    off = (got.double() - want.double()).abs()
    assert bool((off <= bound).all()), (float(off.max()), float(n_terms.max()))


@pytest.mark.gpu
def test_tile_blend_backward_multi_chunk_tiles_on_card():
    """All four variants on tiles that hold more than one 128-instance chunk
    with contributors in several chunks (semi-transparent splats)."""
    _need_card()
    feats, index = _kernel_inputs(_scene(900, 11, opacity=-1.5), "cuda")
    assert int(index[1].max()) > 2 * tb.CI
    g = torch.Generator().manual_seed(1)
    for full, packed in itertools.product((True, False), repeat=2):
        fwd, _ = tb.tile_blend_forward(feats[packed], *index, train_shape=not full,
                                       packed_feats=packed)
        assert int(tb._used_chunks(fwd, index[1]).max()) > 1
        ct = torch.randn(fwd.shape, generator=g).to("cuda")
        d_k = tb.tile_blend_backward(feats[packed], *index, fwd, ct, full_grads=full,
                                     packed_feats=packed)
        d_p = tb.tile_blend_backward_plain(feats[packed], *index, fwd, ct, full_grads=full,
                                           packed_feats=packed)
        a, b = _unpacked_rows(d_k, packed).cpu(), _unpacked_rows(d_p, packed).cpu()
        scale = b.abs().amax(1, keepdim=True)
        assert bool(((a - b).abs() <= 1e-3 * scale).all()), (full, packed)


def _bench_cloud(n, seed=0):
    """The bench cloud of chip_smoke.build_state's geometry, as numpy."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    log_s = (-4.8 + 0.5 * rng.normal(size=(n, 2))).astype(np.float32)
    rot = (np.stack([np.ones(n), 0.4 * np.sin(1.3 * xyz[:, 0]), 0.4 * np.cos(1.1 * xyz[:, 1]),
                     0.4 * np.sin(0.9 * xyz[:, 2])], axis=1)
           + 0.05 * rng.normal(size=(n, 4))).astype(np.float32)
    logit = rng.uniform(-1, 2, (n, 1)).astype(np.float32)
    return xyz, log_s, rot, logit


@pytest.mark.gpu
def test_preprocess_on_card_bit_identical_to_cpu():
    """What binning reads of preprocess (and the view normal), from the
    state's own activations, has the same bits on the card and the CPU on a
    seeded 10k cloud at 1088x1920, opacity-aware rects on."""
    _need_card()
    from tpu_splat_torch.core import f32

    xyz, log_s, rot, logit = _bench_cloud(10_000)
    out = {}
    for d in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(a).to(d)
        cam = orbit_camera(1088, 1920, radius=6.0, azimuth=0.4, elevation=0.3, device=d)
        p = preprocess(t(xyz), f32.exp(t(log_s)), t(rot), cam.world_view, cam.full_proj,
                       cam.camera_center, 1088, 1920, colors=torch.zeros((len(xyz), 3), device=d),
                       opacity=f32.sigmoid(t(logit)[:, 0]))
        out[d] = p
    for f in ("hom", "xy", "depth", "normal_view", "radius", "rect_min", "rect_max",
              "tiles_touched", "valid"):
        np.testing.assert_array_equal(getattr(out["cuda"], f).cpu().numpy(),
                                      getattr(out["cpu"], f).numpy(), err_msg=f)
    assert int(out["cpu"].tiles_touched.sum()) > 10_000


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu():
    _need_card()
    cfg = production_config(**KW)
    d = _scene(300, 6)
    out = {}
    for dev in ("cpu", "cuda"):
        st = state_from_numpy(d, device=dev)
        ts = TrainState.create(st, OptimizationParams(), num_frames=2)
        ts.step = 600  # the deferred-reflection stage
        cam = orbit_camera(H, W, radius=4.0, azimuth=0.5, elevation=0.2, device=dev)
        gt = torch.tensor(np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(np.float32),
                          device=dev)
        step = make_train_step(OptimizationParams(), cfg, 1.0, isp_cfg=ISPConfig())
        out[dev] = step(ts, cam, gt, torch.tensor([0.1, 0.2, 0.3], device=dev), frame_idx=1)[1]
    a, b = out["cpu"], out["cuda"]
    for f in ("loss", "l1", "ssim", "normal_loss"):
        assert abs(float(getattr(a, f)) - float(getattr(b, f))) <= 1e-5 * abs(float(getattr(a, f))), f
    for k, ga in a.grads.items():
        gb = b.grads[k].cpu()
        scale = float(ga.abs().max())
        assert float((gb - ga).abs().max()) <= 1e-2 * scale + 1e-30, k



def test_slice3_wrappers_check_their_inputs():
    i32 = torch.int32
    table = torch.zeros((40, 5))
    off = torch.zeros(40, dtype=i32)
    tot = torch.zeros((), dtype=i32)
    r0 = torch.zeros(32, dtype=i32)
    with pytest.raises(ValueError, match="table must be float32"):
        re_.run_expand(table.double(), off, tot, r0, 4096)
    with pytest.raises(ValueError, match="offsets"):
        re_.run_expand(table, off.long(), tot, r0, 4096)
    with pytest.raises(ValueError, match="total"):
        re_.run_expand(table, off, tot.reshape(1), r0, 4096)
    rows, j = re_.run_expand(table, off, tot, r0, 4096)  # total 0: nothing covered
    assert rows.shape == (5, 4096) and not rows.any()
    assert torch.equal(j, torch.arange(4096, dtype=i32))

    se = torch.zeros(4, dtype=i32)
    with pytest.raises(ValueError, match="F <= 32"):
        sr.segment_sum_rows(torch.zeros((64, 33)), se, se)
    with pytest.raises(ValueError, match="rows must"):
        sr.segment_sum_rows(torch.zeros((64, 19), dtype=torch.float64), se, se)
    with pytest.raises(ValueError, match="ends"):
        sr.segment_sum_rows(torch.zeros((64, 19)), se, se[:3])
    assert sr.segment_sum_rows(torch.zeros((64, 19)), se, se).shape == (4, 19)


def _run_table(rng, P, n_out, K):
    lens = rng.integers(1, 9, P)
    lens[P - P // 10:] = 0
    off = np.cumsum(lens) - lens
    total = min(int(lens.sum()), n_out)
    mark = np.zeros(n_out + P + 1, np.int64)
    mark[np.where((lens > 0) & (off < n_out), off, n_out + np.arange(P))] += 1
    r0 = np.maximum(np.cumsum(mark[:n_out])[::128] - 1, 0)
    table = rng.normal(size=(P, K)).astype(np.float32)
    table[:, 0] = rng.integers(0, 1 << 22, P)
    table[::5, 1] = -0.0
    dev = lambda x: torch.tensor(np.asarray(x, np.int32), device="cuda")
    return (torch.tensor(table, device="cuda"), dev(np.minimum(off, n_out)), dev(total), dev(r0))


@pytest.mark.gpu
@pytest.mark.parametrize("K,n_out,P", [(4, 8192, 3000), (5, 4096, 300), (11, 12288, 2500)])
def test_run_expand_kernel_matches_plain_on_card(K, n_out, P):
    _need_card()
    args = _run_table(np.random.default_rng(K), P, n_out, K)
    before = LAUNCHES["run_expand"]
    rows, j = re_.run_expand(*args, n_out)
    assert LAUNCHES["run_expand"] == before + 1
    want_rows, want_j = re_.run_expand_plain(*args, n_out)
    torch.cuda.synchronize()
    assert torch.equal(rows.view(torch.int32), want_rows.view(torch.int32))
    assert torch.equal(j, want_j)


@pytest.mark.gpu
def test_segment_sum_rows_kernel_matches_plain_on_card():
    _need_card()
    rng = np.random.default_rng(3)
    for F in (19, 32):
        N, P_ = 50_000, 12_000
        lens = rng.integers(0, 9, P_)
        starts = np.cumsum(rng.integers(0, 3, P_) + np.concatenate([[0], lens[:-1]]))
        s, e = (torch.tensor(x.astype(np.int32), device="cuda") for x in (starts, starts + lens))
        rows = torch.tensor(rng.normal(size=(N, F)).astype(np.float32), device="cuda")
        before = LAUNCHES["segment_sum_rows"]
        got = sr.segment_sum_rows(rows, s, e)
        assert LAUNCHES["segment_sum_rows"] == before + 1
        want = sr.segment_sum_rows_plain(rows, s, e)
        assert bool(((got - want).abs() <= 1e-6 * want.abs().amax(0)).all()), F


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["tight", "kernel"])
def test_run_decode_binning_on_card_matches_cpu(mode):
    _need_card()
    sw = dict(tight_culling=True) if mode == "tight" else dict(expand_mode="kernel")
    cfg = production_config(**KW, **sw)
    st = state_from_numpy(_scene(900, 7), device="cpu")
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.3, elevation=0.2, device="cpu")
    p = preprocess(st.xyz, st.get_scaling(), st.rotation, cam.world_view, cam.full_proj,
                   cam.camera_center, H, W, sh=st.get_features(), sh_degree=1,
                   opacity=st.get_opacity())
    # one preprocess output for both devices (exp and the SH round apart
    # between the card and the CPU): binning alone is compared
    out = {dev: bin_gaussians(type(p)(*(x.to(dev) for x in p)), H, W, cfg)
           for dev in ("cpu", "cuda")}
    for f in out["cpu"]._fields:
        assert torch.equal(getattr(out["cuda"], f).cpu(), getattr(out["cpu"], f)), f


@pytest.mark.gpu
def test_native_loader_decodes_a_full_frame_png_on_card(tmp_path):
    """The native PNG decoder, built on the card's machine, reads a
    1088x1920 RGB frame written by the numpy PNG writer (all five row
    filters) back to the array written."""
    _need_card()
    from tpu_splat_torch.data import native_loader as nl

    assert nl.decoder().startswith("native"), nl.decoder()
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (1088, 1920, 3), dtype=np.uint8)
    img[:, :960] //= 8  # smooth half: the predictors matter
    p = str(tmp_path / "frame.png")
    nl.write_png(p, img, filters=(0, 1, 2, 3, 4))
    np.testing.assert_array_equal(nl.decode_png(p), img)
    (idx, got), = list(nl.PrefetchingImageLoader([p]))
    assert idx == 0
    np.testing.assert_array_equal(got, img)


@pytest.mark.gpu
def test_checkpoint_round_trip_of_a_1m_row_state_on_card(tmp_path):
    """save_checkpoint then load_checkpoint of a TrainState with 1<<20 rows
    and the ISP on, on the card: every leaf bit equal, the generator
    state kept."""
    _need_card()
    from tpu_splat_torch.model import convert
    from tpu_splat_torch.model.io import load_checkpoint, save_checkpoint

    cap = 1 << 20
    rng = np.random.default_rng(12)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    d = dict(xyz=f(cap, 3), features_dc=f(cap, 1, 3), features_rest=f(cap, 15, 3),
             scaling=f(cap, 2), rotation=f(cap, 4), opacity=f(cap, 1), refl=f(cap, 1),
             texture=f(6, 3, 128, 128), fail_value=f(3), alive=rng.random(cap) < 0.7,
             active_sh_degree=2, max_sh_degree=3)
    ts = TrainState.create(state_from_numpy(d, device="cuda"), OptimizationParams(),
                           num_frames=8)
    opt = ts.opt._replace(
        mu={k: torch.randn_like(v) for k, v in ts.opt.mu.items()},
        nu={k: torch.rand_like(v) for k, v in ts.opt.nu.items()}, count=311)
    ts = type(ts)(**{**ts.__dict__, "opt": opt, "step": 311, "opacity_lr": 0.0125,
                     "stats": type(ts.stats)(*(torch.rand_like(v) for v in ts.stats))})
    torch.randn(5, generator=ts.generator)
    path = str(tmp_path / "chk.npz")
    save_checkpoint(path, ts, 311)
    back, it = load_checkpoint(path, ts)
    assert it == 311 and back.gaussians.device.type == "cuda"
    want, got = (convert.train_state_to_leaves(x) for x in (ts, back))
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(
            want[k].reshape(-1).view(np.uint8), got[k].reshape(-1).view(np.uint8)), k
    assert torch.equal(back.generator.get_state(), ts.generator.get_state())


def _blender_scene(root, n=4, size=64):
    """A Blender scene of `n` orbit views (a red square on black, written by
    the numpy PNG writer: no Pillow), the first one also the test view."""
    import json

    from tpu_splat_torch.data.native_loader import write_png

    os.makedirs(root)
    img = np.zeros((size, size, 3), np.uint8)
    img[size // 4: 3 * size // 4, size // 4: 3 * size // 4] = [200, 60, 60]
    frames = []
    for i in range(n):
        write_png(os.path.join(root, f"r_{i}.png"), img)
        ang = 2 * np.pi * i / n
        pos = np.array([4 * np.sin(ang), 0.0, 4 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, pos
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    for split, fr in (("train", frames), ("test", frames[:1])):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": fr}, f)


@pytest.mark.gpu
def test_render_cli_on_card_matches_cpu(tmp_path):
    """scripts/render.py on a 64x64 scene, on the card and on the CPU from
    one PLY: the same files; ground truth equal, every rendered PNG equal
    but +-1 level on at most 8 px per 4096 (the knife-edge flips of
    test_render_fast_on_card_matches_cpu, quantised)."""
    _need_card()
    from tpu_splat_torch.config import build_parser, save_cfg_args
    from tpu_splat_torch.data.native_loader import decode_png
    from tpu_splat_torch.model.io import save_ply
    from tpu_splat_torch.scripts import render

    src = str(tmp_path / "scene")
    _blender_scene(src)
    state = state_from_numpy(_scene(300, 7), device="cpu")
    files = {}
    for dev in ("cpu", "cuda"):
        out = str(tmp_path / dev)
        save_cfg_args(out, build_parser().parse_args(["-s", src, "-m", out, "--eval",
                                                      "--sh_degree", "1"]))
        save_ply(state, os.path.join(out, "point_cloud", "iteration_3", "point_cloud.ply"))
        render.main(["-m", out, "--save_normals", "--save_refl", "--max_tiles_per_gaussian", "16",
                     "--max_instances", "8192", "--tile_depth", "256"], device=dev)
        files[dev] = sorted(os.path.relpath(os.path.join(d, f), out)
                            for d, _, fs in os.walk(out) for f in fs if f.endswith(".png"))
    assert files["cpu"] == files["cuda"] and len(files["cpu"]) == 2 + 4 * 5
    for name in files["cpu"]:
        a, b = (decode_png(str(tmp_path / dev / name)).astype(np.int16) for dev in ("cpu", "cuda"))
        off = np.abs(a - b).max(-1)
        if "/gt/" in name:
            assert not off.any(), name
        else:
            assert off.max() <= 1 and int((off > 0).sum()) <= 8 * off.size / 4096, name


def _fusion_inputs(device, views=3, H=48, W=64, seed=3):
    """Seeded maps and cameras in general position (no voxel projects onto
    a pixel boundary)."""
    rng = np.random.default_rng(seed)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    w2cs = []
    for a in (0.1234, 0.4234, -0.2766)[:views]:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.0371, -0.0219, 3.0137]
        w2cs.append(m)
    t = lambda x: torch.as_tensor(x, device=device)
    return dict(
        depths=[t(rng.uniform(2.5, 3.5, (H, W)).astype(np.float32)) for _ in w2cs],
        colors=[t(rng.uniform(0, 1, (H, W, 3)).astype(np.float32)) for _ in w2cs],
        alphas=[t(rng.uniform(0, 1, (H, W)).astype(np.float32)) for _ in w2cs],
        Ks=[t(K) for _ in w2cs], w2cs=[t(m) for m in w2cs],
        bounds_min=np.array([-1.013, -0.987, -1.021]),
        bounds_max=np.array([1.017, 0.991, 1.003]))


@pytest.mark.gpu
def test_tsdf_fusion_and_marching_on_card_match_cpu():
    _need_card()
    from tpu_splat_torch.eval.mesh import extract_mesh_tsdf, tsdf_fusion

    res = {}
    for dev in ("cpu", "cuda"):
        m = _fusion_inputs(dev)
        res[dev] = (tsdf_fusion(**m, resolution=96, z_chunk=96 if dev == "cuda" else 16),
                    extract_mesh_tsdf(**m, resolution=96))
    (tc, cc, wc, _, _), mc = res["cpu"]
    (tg, cg, wg, _, _), mg = res["cuda"]
    assert tg.device.type == "cuda" and float((wc > 0).float().mean()) > 0.1
    assert float((tg.cpu() - tc).abs().max()) <= 1e-6
    assert float((cg.cpu() - cc).abs().max()) <= 1e-6
    assert torch.equal(wg.cpu(), wc)
    assert len(mc.vertices) > 1000
    for a, b in zip(mc, mg):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_viewer_frame_maps_and_encoder_on_card_match_cpu():
    _need_card()
    from tpu_splat_torch.renderer import RenderOutput
    from tpu_splat_torch.viewer import RENDER_MODES, encode_u8, render_net_image

    rng = np.random.default_rng(9)
    f = lambda c: torch.as_tensor(rng.uniform(0, 1, (96, 128, c)).astype(np.float32))
    z = torch.zeros(5)
    maps = dict(render=f(3), base_color=f(3), refl_color=f(3), refl_strength=f(1) * 1.2 - 0.1,
                alpha=f(1), normal=f(3) * 2 - 1, dist=f(1), surf_depth=f(1) * 7.0,
                surf_normal=f(3) * 2 - 1, scope_mask=(f(1) > 0.5).float(), radii=z,
                gaussian_weights=z, visibility=z > 0, num_instances=z[0], max_area=z[0],
                max_tile_count=z[0], pad_overflow=z[0])
    cpu = RenderOutput(**maps)
    card = RenderOutput(**{k: v.cuda() for k, v in maps.items()})
    for mode in RENDER_MODES:
        a, b = render_net_image(cpu, mode), render_net_image(card, mode)
        assert torch.equal(a, b.cpu()), mode
        assert torch.equal(encode_u8(a), encode_u8(b).cpu()), mode
    x = np.concatenate([rng.uniform(-0.5, 1.5, 1 << 20),
                        (np.arange(256) - 0.5) / 255.0]).astype(np.float32)
    want = (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(encode_u8(torch.as_tensor(x, device="cuda")).cpu().numpy(), want)


def _volumetric_inputs(d, device):
    """The bench-like volumetric inputs of a surfel scene: three scale axes
    (the two surfel scales and the first again) and each surfel's normal
    (its rotation's third column)."""
    from tpu_splat_torch.core.transforms import quat_to_rotmat

    st = state_from_numpy(d, device=device)
    sc = st.get_scaling()
    normals = quat_to_rotmat(st.rotation)[:, :, 2]
    return st, torch.cat([sc, sc[:, :1]], 1), normals


@pytest.mark.gpu
@pytest.mark.parametrize("aa", [False, True], ids=["aa-off", "aa-on"])
def test_volumetric_kernels_match_plain_on_card(aa):
    """The volumetric frame's homographies (constant p2, the 1e7 low-pass
    sentinel) through both tile kernels against their plain versions, and
    its preprocess against the CPU's bit for bit."""
    _need_card()
    from tpu_splat_torch.raster.volumetric import preprocess_volumetric

    d = _scene(300, 5)
    preps = {}
    for dev in ("cpu", "cuda"):
        st, sc3, nrm = _volumetric_inputs(d, dev)
        cam = orbit_camera(H, W, radius=4.0, azimuth=0.3, elevation=0.2, device=dev)
        preps[dev] = preprocess_volumetric(st.xyz, sc3, st.rotation, nrm, cam.world_view,
                                           cam.full_proj, cam.camera_center, H, W, cam.tanfovx,
                                           cam.tanfovy, sh=st.get_features(), sh_degree=1,
                                           antialiasing=aa)
    for f in ("hom", "xy", "depth", "normal_view", "radius", "rect_min", "rect_max",
              "tiles_touched", "valid"):
        assert torch.equal(getattr(preps["cuda"][0], f).cpu(), getattr(preps["cpu"][0], f)), f
    assert torch.equal(preps["cuda"][1].cpu(), preps["cpu"][1])
    p, opa_scale = preps["cuda"]
    b = bin_gaussians(p, H, W, RasterConfig(**KW))
    feats = {pk: tb.pack_features(b.aligned_gid, b.aligned_valid, p.hom, p.xy,
                                  st.get_opacity() * opa_scale, p.normal_view, p.color,
                                  st.get_refl(), torch.ones_like(st.alive), bf16_feats=pk)
             for pk in (False, True)}
    org = tile_origins(H, W, device="cuda")
    index = (b.aligned_starts, b.tile_counts, org[:, 0].contiguous(), org[:, 1].contiguous())
    outs = _assert_forward_matches_plain(feats, index)
    assert float(outs[(False, False, True)][:, tb.O_T].min()) < 0.5  # not an empty frame
    g = torch.Generator().manual_seed(0)
    for full, packed in itertools.product((True, False), repeat=2):
        fwd, _ = tb.tile_blend_forward(feats[packed], *index, train_shape=not full,
                                       packed_feats=packed)
        ct = torch.randn(fwd.shape, generator=g).to("cuda")
        d_k = tb.tile_blend_backward(feats[packed], *index, fwd, ct, full_grads=full,
                                     packed_feats=packed)
        d_p = tb.tile_blend_backward_plain(feats[packed], *index, fwd, ct, full_grads=full,
                                           packed_feats=packed)
        a, b_ = _unpacked_rows(d_k, packed).cpu(), _unpacked_rows(d_p, packed).cpu()
        scale = b_.abs().amax(1, keepdim=True)
        assert bool(((a - b_).abs() <= 1e-3 * scale).all()), (full, packed)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["surfel", "volumetric"])
def test_scan_blend_on_card_matches_cpu(mode):
    _need_card()
    from tpu_splat_torch.raster import rasterize

    d = _scene(200, 8)
    cfg = RasterConfig(**dict(KW, backend="xla"))
    out, grads = {}, {}
    for dev in ("cpu", "cuda"):
        st, sc3, nrm = _volumetric_inputs(d, dev)
        cam = orbit_camera(H, W, radius=4.0, azimuth=0.5, elevation=0.2, device=dev)
        leaves = [st.xyz.clone().requires_grad_(), st.get_opacity().detach().requires_grad_(),
                  st.get_features().detach().requires_grad_()]
        sc = sc3 if mode == "volumetric" else st.get_scaling()
        o = rasterize(leaves[0], sc, st.rotation, leaves[1], st.get_refl(), cam,
                      torch.tensor([0.1, 0.2, 0.3], device=dev), cfg, sh=leaves[2],
                      sh_degree=1, mode=mode, normals=nrm)
        w = torch.linspace(-1, 1, o.color.numel(), device=dev).reshape(o.color.shape)
        grads[dev] = torch.autograd.grad((o.color * w).sum() + o.others.sum(), leaves)
        out[dev] = o
    a, b = out["cpu"], out["cuda"]
    assert torch.equal(a.tile_counts, b.tile_counts.cpu())
    for f in ("color", "final_T", "refl_map", "others"):
        diff = (getattr(b, f).detach().cpu() - getattr(a, f).detach()).abs()
        diff = diff.amax(-1) if diff.dim() == 3 else diff
        assert int((diff > TOL).sum()) <= 8 * diff.numel() / 4096, (f, float(diff.max()))
    assert float(a.others[..., 1].detach().max()) > 0.5
    for ga, gb in zip(grads["cpu"], grads["cuda"]):
        scale = float(ga.abs().max())
        assert scale > 0 and float((gb.cpu() - ga).abs().max()) <= 1e-3 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "dense"])
def test_scan_expansion_on_card_matches_cpu(aligned):
    _need_card()
    cfg = dict(KW, max_instances=2048)
    st = state_from_numpy(_scene(900, 3), device="cpu")
    cam = orbit_camera(H, W, radius=4.0, azimuth=0.3, elevation=0.2, device="cpu")
    p = preprocess(st.xyz, st.get_scaling(), st.rotation, cam.world_view, cam.full_proj,
                   cam.camera_center, H, W, sh=st.get_features(), sh_degree=1)
    out = {}
    for dev in ("cpu", "cuda"):
        pd = type(p)(*(x.to(dev) for x in p))
        out[dev] = bin_gaussians(pd, H, W, RasterConfig(**cfg, expand_mode="scan"),
                                 aligned=aligned)
        out[dev, "gather"] = bin_gaussians(pd, H, W, RasterConfig(**cfg), aligned=aligned)
    assert int(out["cpu"].num_instances) > cfg["max_instances"]  # the truncated tail too
    for f in out["cpu"]._fields:
        got = getattr(out["cuda"], f).cpu()
        assert torch.equal(got, getattr(out["cpu"], f)), f
        assert torch.equal(got, getattr(out["cuda", "gather"], f).cpu()), f


@pytest.mark.gpu
def test_two_ranks_tile_sharded_step_on_the_card():
    """Two ranks over gloo share the card (NCCL takes one rank a card): each
    runs the four kernels of the step on its slab."""
    _need_card()
    import torch_dist_worker  # beside this file (an installed `tests` package may shadow it)

    from tpu_splat_torch.dist import launch

    build.build_all()  # once here: the ranks load the libraries
    results = launch(torch_dist_worker.card_sharded_step, 2, args=(2,), backend="gloo")
    for res in results:
        a, b = res["loss"]
        assert abs(a - b) <= 1e-5 * abs(a), res["loss"]
        assert res["render_err"] <= 2e-5, res["render_err"]
        bad = {k: e for k, e in res["grad_err"].items() if e > 1e-3}
        assert not bad, bad
        for k in ("tile_blend_forward", "tile_blend_backward", "segment_sum_ranges",
                  "cubemap_tap_accumulate"):
            assert res["launches"].get(k, 0) >= 1, (k, res["launches"])
    assert results[0]["params_hash"] == results[1]["params_hash"]
