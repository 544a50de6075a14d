"""The port's evaluation helpers (`tpu_splat_torch/eval/`) against the JAX
package's on the CPU, and the evaluation CLIs' device rule.

Tolerances: the numpy image maps, the PNG pixels and GMSD exact (the same
numpy arithmetic); the LPIPS module within 1e-4 absolute of the JAX
`_LpipsVgg` on synthetic weights in both lin-head spellings (float32 convs
summed in another order), and lpips(a, a) = 0 within 1e-6; trajectory
poses within 1e-9 and the path cameras' world_view within 1e-6 (the
cameras' float32 matrices).
"""
import types

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_splat_torch.eval import image_utils as timg

RNG = np.random.default_rng(21)
IMG_A = RNG.uniform(0, 1, (24, 40, 3)).astype(np.float32)
IMG_B = np.clip(IMG_A + RNG.normal(0, 0.05, IMG_A.shape), 0, 1).astype(np.float32)
FACES = RNG.uniform(0, 1, (6, 8, 8, 3)).astype(np.float32)

MAPS = {
    "mse_map": lambda m: m.mse_map(IMG_A, IMG_B),
    "psnr_map": lambda m: m.psnr_map(IMG_A, np.where(IMG_A > 0.5, IMG_A, IMG_B)),
    "normalized_psnr_map": lambda m: m.normalized_psnr_map(IMG_A, IMG_B),
    "gradient_map": lambda m: m.gradient_map(IMG_A),
    "to_3ch": lambda m: m.to_3ch(IMG_A[..., :1]),
    "make_grid": lambda m: m.make_grid([IMG_A, IMG_B, IMG_A], nrow=2),
    "plot_cubemap": lambda m: m.plot_cubemap(FACES),
}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_image_maps_equal_jax(name):
    from tpu_splat.eval import image_utils as jimg

    got, want = MAPS[name](timg), MAPS[name](jimg)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_save_image_u8_pixels_equal_pil(tmp_path):
    """The numpy PNG writer holds the JAX package's pixels (PIL there): the
    same half-up rounding, clipping and channel layouts."""
    from tpu_splat.eval import image_utils as jimg

    imgs = {"rgb": np.concatenate([IMG_A * 1.2 - 0.1, IMG_B], 0),
            "gray": IMG_A[..., 0], "gray1": IMG_A[..., :1], "f64": IMG_B.astype(np.float64)}
    for k, img in imgs.items():
        timg.save_image_u8(str(tmp_path / "t" / f"{k}.png"), img)
        jimg.save_image_u8(str(tmp_path / "j" / f"{k}.png"), img if k != "gray1" else img[..., 0])
        got = np.asarray(Image.open(tmp_path / "t" / f"{k}.png"))
        want = np.asarray(Image.open(tmp_path / "j" / f"{k}.png"))
        np.testing.assert_array_equal(got.reshape(want.shape), want, k)


def test_read_images_rgb_equals_pil_convert(tmp_path):
    """PNGs of every channel count decode as Pillow's convert("RGB")."""
    u8 = (IMG_A * 255).astype(np.uint8)
    arrays = {"L": u8[..., 0], "LA": u8[..., :2], "RGB": u8,
              "RGBA": np.concatenate([u8, u8[..., :1]], -1)}
    paths = []
    for mode, arr in arrays.items():
        paths.append(str(tmp_path / f"{mode}.png"))
        Image.fromarray(arr, mode=mode).save(paths[-1])
    for p, got in zip(paths, timg.read_images_rgb(paths)):
        np.testing.assert_array_equal(got, np.asarray(Image.open(p).convert("RGB")), p)


def test_gmsd_equals_jax():
    from tpu_splat.eval.lpips import gmsd as j_gmsd

    from tpu_splat_torch.eval.lpips import gmsd

    a64, b64 = IMG_A.astype(np.float64), IMG_B.astype(np.float64)
    assert gmsd(IMG_A, IMG_B) == j_gmsd(IMG_A, IMG_B)
    assert gmsd(a64, b64) == j_gmsd(a64, b64)
    assert gmsd(IMG_A, IMG_A) == 0.0


def test_gmsd_takes_tensors():
    """[H, W, 3] tensors, as validate_e2e's evaluation passes them (on the
    card there), score as their numpy arrays do; a tensor that needs a
    gradient is read detached."""
    import torch

    from tpu_splat_torch.eval.lpips import gmsd

    a, b = torch.tensor(IMG_A, requires_grad=True), torch.tensor(IMG_B)
    assert gmsd(a, b) == gmsd(IMG_A, IMG_B) == gmsd(IMG_A, b)


def _vgg_state_dict(rng):
    """Random VGG16-features weights in torchvision's key layout."""
    from tpu_splat_torch.eval.lpips import _VGG16_PLAN

    sd, idx, cin = {}, 0, 3
    for spec in _VGG16_PLAN:
        if spec == "M":
            idx += 1
            continue
        # small weights keep the activations finite through 13 convs
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(0, 0.08, (spec, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0, 0.01, (spec,)).astype(np.float32))
        idx += 2
        cin = spec
    return sd


def _lin_state_dict(rng, spelling):
    """LPIPS lin heads, richzhang's raw keys or the reference's renamed ones."""
    key = {"raw": "lin{}.model.1.weight", "renamed": "{}.1.weight"}[spelling]
    return {key.format(i): torch.from_numpy(rng.uniform(0, 0.3, (1, c, 1, 1)).astype(np.float32))
            for i, c in enumerate([64, 128, 256, 512, 512])}


@pytest.mark.parametrize("spelling", ["raw", "renamed"])
def test_lpips_module_matches_jax(tmp_path, spelling):
    from tpu_splat.eval.lpips import _LpipsVgg, _load_torch_state_dict as j_load

    from tpu_splat_torch.eval.lpips import LpipsVgg, _load_torch_state_dict

    rng = np.random.default_rng(0)
    paths = tmp_path / "vgg16-synthetic.pth", tmp_path / "lpips_vgg_synthetic.pth"
    torch.save(_vgg_state_dict(rng), str(paths[0]))
    torch.save(_lin_state_dict(rng, spelling), str(paths[1]))
    want_fn = _LpipsVgg(*(j_load(str(p)) for p in paths))
    got_fn = LpipsVgg(*(_load_torch_state_dict(str(p)) for p in paths), device="cpu")
    a = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = float(got_fn(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(want_fn(a, b), abs=1e-4)
    assert float(got_fn(a, b)) == got  # arrays as tensors
    assert abs(float(got_fn(a, a))) <= 1e-6


def test_lpips_weights_found_on_local_disk_only(tmp_path, monkeypatch):
    """lpips_fn_or_none finds the backbone under TORCH_HOME and the lin
    heads there or at LPIPS_WEIGHTS, and is None while either is missing."""
    from tpu_splat_torch.eval.lpips import LpipsVgg, lpips_fn_or_none

    rng = np.random.default_rng(1)
    hub = tmp_path / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    assert lpips_fn_or_none(device="cpu") is None
    torch.save(_vgg_state_dict(rng), str(hub / "vgg16-397923af.pth"))
    assert lpips_fn_or_none(device="cpu") is None  # a backbone alone is not LPIPS
    lin = tmp_path / "elsewhere.pth"
    torch.save(_lin_state_dict(rng, "raw"), str(lin))
    monkeypatch.setenv("LPIPS_WEIGHTS", str(lin))
    assert isinstance(lpips_fn_or_none(device="cpu"), LpipsVgg)
    monkeypatch.delenv("LPIPS_WEIGHTS")
    assert lpips_fn_or_none(device="cpu") is None
    torch.save(_lin_state_dict(rng, "renamed"), str(hub / "lpips_vgg_v01.pth"))
    fn = lpips_fn_or_none(device="cpu")
    a = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    assert np.isfinite(float(fn(a, np.clip(a + 0.1, 0, 1))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lpips_fn_or_none()


def _orbit_views(n=7, seed=3):
    """(R c2w, T w2v) of cameras on a noisy orbit looking at the origin."""
    rng = np.random.default_rng(seed)
    views = []
    for k in range(n):
        a = 2 * np.pi * k / n + rng.normal(0, 0.1)
        pos = np.array([4 * np.cos(a), 4 * np.sin(a), 1.0 + rng.normal(0, 0.3)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1)
        views.append((R, -R.T @ pos))
    return views


def test_trajectory_poses_and_cameras_match_jax():
    from tpu_splat.core.graphics import Camera as JCamera
    from tpu_splat.eval import trajectories as jtraj

    from tpu_splat_torch.core.graphics import Camera
    from tpu_splat_torch.eval import trajectories as ttraj

    kw = dict(fovx=0.9, fovy=0.6, height=30, width=46)
    views = _orbit_views()
    jcams = [types.SimpleNamespace(camera=JCamera.create(R=R, T=T, **kw)) for R, T in views]
    tcams = [types.SimpleNamespace(camera=Camera.create(R=R, T=T, device="cpu", **kw))
             for R, T in views]
    pj, pt = jtraj.poses_from_cameras(jcams), ttraj.poses_from_cameras(tcams)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-9)
    (rj, tj), (rt, tt) = jtraj.transform_poses_pca(pj), ttraj.transform_poses_pca(pt)
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-9)
    for zv in (0.0, 0.3):
        np.testing.assert_allclose(
            ttraj.generate_ellipse_path(rt, 12, z_variation=zv),
            jtraj.generate_ellipse_path(rj, 12, z_variation=zv), rtol=0, atol=1e-9)
    path_j = jtraj.generate_path(jcams, n_frames=12, z_variation=0.2)
    path_t = ttraj.generate_path(tcams, n_frames=12, z_variation=0.2)
    assert len(path_t) == len(path_j) == 12
    for cj, ct in zip(path_j, path_t):
        assert ct.device.type == "cpu" and (ct.height, ct.width) == (cj.height, cj.width)
        np.testing.assert_allclose(ct.world_view.numpy(), np.asarray(cj.world_view),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(ct.K.numpy(), np.asarray(cj.K), rtol=0, atol=1e-6)


DEVICE_CLIS = ("render", "metrics", "eval_fps", "eval_mae", "visible_gaussians",
               "render_videos", "video", "view_diff_maps", "report")


@pytest.mark.parametrize("name", DEVICE_CLIS)
def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch, name):
    """Every evaluation CLI that computes on tensors runs on "cuda" unless
    its caller passes device="cpu", and raises where there is no card
    instead of falling back."""
    import importlib

    mod = importlib.import_module(f"tpu_splat_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["-m", str(tmp_path / "model")])
