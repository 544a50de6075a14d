"""Qualitative diff-map sheets (port of tpu_splat/scripts/view_diff_maps.py;
role of reference view_diff_maps.py).

For every test view of a trained model dir, tiles [gt | render | SSIM map |
normalized PSNR map | L1 map] into one row of a grid image written to
<method>/diff_maps/ (reference view_diff_maps.py:85-140). The SSIM map is
the port's, on the card.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np

from tpu_splat_torch.eval.image_utils import (
    make_grid,
    normalized_psnr_map,
    read_images_rgb,
    save_image_u8,
    to_3ch,
)


def _read_images(d):
    names = sorted(os.listdir(d))
    return names, [u8.astype(np.float32) / 255.0
                   for u8 in read_images_rgb([os.path.join(d, n) for n in names])]


def diff_tiles(render: np.ndarray, gt: np.ndarray, device) -> list[np.ndarray]:
    import torch

    from tpu_splat_torch.train.losses import ssim

    tiles = [to_3ch(gt), to_3ch(render)]
    t = lambda a: torch.as_tensor(a, device=device)
    smap = ssim(t(render), t(gt), return_map=True).cpu().numpy()
    tiles.append(to_3ch(np.clip(smap.mean(-1, keepdims=True), 0, 1)))
    tiles.append(to_3ch(normalized_psnr_map(render, gt)))
    l1 = np.abs(render - gt)
    tiles.append(to_3ch(l1 / max(l1.max(), 1e-8)))
    return tiles


def process_method(method_dir: str, views_per_sheet: int = 8, device="cuda"):
    renders_dir = os.path.join(method_dir, "renders")
    gt_dir = os.path.join(method_dir, "gt")
    if not (os.path.isdir(renders_dir) and os.path.isdir(gt_dir)):
        return 0
    out_dir = os.path.join(method_dir, "diff_maps")
    os.makedirs(out_dir, exist_ok=True)
    names, renders = _read_images(renders_dir)
    gt_names, gts = _read_images(gt_dir)
    gt_by_name = dict(zip(gt_names, gts))

    tiles, n_cols, sheet = [], 5, 0
    written = 0
    for i, (name, r) in enumerate(zip(names, renders)):
        g = gt_by_name.get(name)
        if g is None or g.shape != r.shape:
            continue
        tiles += diff_tiles(r, g, device)
        if (i + 1) % views_per_sheet == 0:
            save_image_u8(
                os.path.join(out_dir, f"sheet_{sheet:03d}.png"),
                make_grid(tiles, nrow=n_cols),
            )
            tiles, sheet = [], sheet + 1
            written += 1
    if tiles:
        save_image_u8(
            os.path.join(out_dir, f"sheet_{sheet:03d}.png"),
            make_grid(tiles, nrow=n_cols),
        )
        written += 1
    return written


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags; `device` is where the SSIM maps are computed
    (the tests pass "cpu")."""
    from tpu_splat_torch.core.device import resolve_device

    parser = ArgumentParser()
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--views_per_sheet", type=int, default=8)
    args = parser.parse_args(argv)
    dev = resolve_device(device)
    for model_path in args.model_paths:
        split_dir = os.path.join(model_path, args.split)
        if not os.path.isdir(split_dir):
            print(f"[!] no {args.split} renders in {model_path}")
            continue
        for method in sorted(os.listdir(split_dir)):
            n = process_method(
                os.path.join(split_dir, method), args.views_per_sheet, dev
            )
            print(f"{model_path}/{args.split}/{method}: {n} sheets")
    return 0


if __name__ == "__main__":
    sys.exit(main())
