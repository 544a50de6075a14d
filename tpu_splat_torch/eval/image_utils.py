"""Image diagnostics (port of tpu_splat/eval/image_utils.py; role of
reference utils/image_utils.py).

Per-pixel metric maps (psnr_map, Sobel gradient_map), channel normalizers
(to_3ch), grid tiling for qualitative sheets (make_grid — role of
torchvision.utils.make_grid in view_diff_maps.py:118), and the cubemap
cross-layout plot (plot_cubemap, reference utils/image_utils.py:86-100).
All numpy (gradient_map also on tensors), channels-last [H, W, C] in
[0, 1]. PNGs are written by the
port's numpy + zlib writer (`data/native_loader.write_png`), so no Pillow
is needed; the pixels are the JAX package's, the file bytes may differ.
"""
from __future__ import annotations

import numpy as np


def mse_map(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-pixel MSE over channels, [H,W,C] -> [H,W,1]."""
    return np.mean((a - b) ** 2, axis=-1, keepdims=True)


def psnr_map(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-pixel PSNR (reference utils/image_utils.py:26-31); inf where equal."""
    m = mse_map(a, b)
    with np.errstate(divide="ignore"):
        return 20.0 * np.log10(1.0 / np.sqrt(m))


def normalized_psnr_map(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """view_diff_maps.py:122-126: inf -> max finite, then min-max normalize."""
    p = psnr_map(a, b)
    finite = np.isfinite(p)
    if not finite.any():
        return np.zeros_like(p)
    p = np.where(finite, p, p[finite].max())
    p = (p - p.min()) / (p.max() - p.min() + 1e-8)
    return p / max(p.max(), 1e-8)


def gradient_map(img):
    """Sobel edge magnitude (reference utils/image_utils.py:33-48),
    [H,W,C] -> [H,W,1] in [0,1]. A tensor is mapped on its device with
    numpy's float32 steps in numpy's order (the channel mean summed left
    to right, each tap a product then a sum, the square root correctly
    rounded), so it gives numpy's bits."""
    import torch

    from tpu_splat_torch.core import f32

    if isinstance(img, torch.Tensor):
        gray = img[..., 0]
        for c in range(1, img.shape[-1]):
            gray = gray + img[..., c]
        gray = gray / gray.new_full((), img.shape[-1])  # a true divide on the card too
        pad = torch.nn.functional.pad(gray[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        gx, gy = torch.zeros_like(gray), torch.zeros_like(gray)
        kx = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
        for i in range(3):
            for j in range(3):
                sl = pad[i : i + gray.shape[0], j : j + gray.shape[1]]
                gx = gx + kx[i][j] * sl
                gy = gy + kx[j][i] * sl
        mag = f32.sqrt(gx**2 + gy**2)
        return (mag / torch.clamp(mag.max(), min=1e-8))[..., None]
    gray = np.mean(img, axis=-1)
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    ky = kx.T
    pad = np.pad(gray, 1, mode="edge")
    gx = np.zeros_like(gray)
    gy = np.zeros_like(gray)
    for i in range(3):
        for j in range(3):
            sl = pad[i : i + gray.shape[0], j : j + gray.shape[1]]
            gx += kx[i, j] * sl
            gy += ky[i, j] * sl
    mag = np.sqrt(gx**2 + gy**2)
    return (mag / max(mag.max(), 1e-8))[..., None]


def to_3ch(img: np.ndarray) -> np.ndarray:
    """[H,W] or [H,W,1] or [H,W,3] -> [H,W,3] (reference :103-110)."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img[..., :3]


def make_grid(tiles: list[np.ndarray], nrow: int, pad: int = 2) -> np.ndarray:
    """Tile [H,W,3] images into a grid, nrow tiles per row (torchvision
    make_grid role). Tiles must share a shape."""
    h, w, c = tiles[0].shape
    ncol = nrow
    nrows = (len(tiles) + ncol - 1) // ncol
    grid = np.ones(
        (nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.float32
    )
    for i, t in enumerate(tiles):
        r, col = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y : y + h, x : x + w] = t
    return grid


def plot_cubemap(faces: np.ndarray) -> np.ndarray:
    """[6,L,L,3] (+x,-x,+y,-y,+z,-z) -> horizontal-cross layout [3L,4L,3]
    (reference utils/image_utils.py:86-100)."""
    L = faces.shape[1]
    out = np.zeros((3 * L, 4 * L, 3), np.float32)
    # row 0: +y at col 1; row 1: -x,+z,+x,-z; row 2: -y at col 1
    out[0:L, L : 2 * L] = faces[2]
    out[L : 2 * L, 0:L] = faces[1]
    out[L : 2 * L, L : 2 * L] = faces[4]
    out[L : 2 * L, 2 * L : 3 * L] = faces[0]
    out[L : 2 * L, 3 * L : 4 * L] = faces[5]
    out[2 * L : 3 * L, L : 2 * L] = faces[3]
    return out


def save_image_u8(path: str, img: np.ndarray):
    """[H,W] or [H,W,C] in [0, 1] -> an 8-bit PNG, each value rounded half
    up on the host as the JAX package does (`clip(x*255 + 0.5)`)."""
    import os

    from tpu_splat_torch.data.native_loader import write_png

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    write_png(path, arr)


def read_images_rgb(paths: list[str]) -> list[np.ndarray]:
    """PNGs as [H,W,3] uint8 arrays, as Pillow's `Image.open(p).convert("RGB")`
    gives them (gray repeated, alpha dropped without compositing), decoded
    ahead on the native loader's threads (Pillow only where the native
    library is missing or does not decode a file)."""
    from tpu_splat_torch.data.native_loader import PrefetchingImageLoader

    out = []
    for _, arr in PrefetchingImageLoader(list(paths)):
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] in (1, 2):
            arr = np.repeat(arr[..., :1], 3, axis=-1)
        out.append(np.ascontiguousarray(arr[..., :3]))
    return out
