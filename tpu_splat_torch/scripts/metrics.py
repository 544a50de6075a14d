"""Metrics CLI (port of tpu_splat/scripts/metrics.py; role of reference
metrics.py).

Walks <model>/test/ours_N/{renders,gt}, computes PSNR/SSIM (+LPIPS when a
pretrained backbone is on disk — see tpu_splat_torch.eval.lpips) on the
card, writes results.json + per_view.json in the reference's format. PNGs
are decoded by the native loader; each pixel is divided by 255.0 in
float64 and then rounded to float32, as the JAX package's
`np.asarray(Image...) / 255.0` and `jnp.asarray(..., float32)` do.
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np


def _read_dir(d):
    from tpu_splat_torch.eval.image_utils import read_images_rgb

    names = sorted(os.listdir(d))
    imgs = read_images_rgb([os.path.join(d, n) for n in names])
    return [(n, u8 / 255.0) for n, u8 in zip(names, imgs)]


def evaluate(model_paths, split="test", device: str = "cuda"):
    import torch

    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.eval.lpips import gmsd, lpips_fn_or_none
    from tpu_splat_torch.train.losses import psnr as psnr_fn
    from tpu_splat_torch.train.losses import ssim as ssim_fn

    dev = resolve_device(device)
    lpips = lpips_fn_or_none(device=dev)

    for model_path in model_paths:
        print(f"Scene: {model_path}")
        full, per_view = {}, {}
        split_dir = os.path.join(model_path, split)
        if not os.path.isdir(split_dir):
            print(f"  no {split} renders")
            continue
        for method in sorted(os.listdir(split_dir)):
            renders_dir = os.path.join(split_dir, method, "renders")
            gt_dir = os.path.join(split_dir, method, "gt")
            if not os.path.isdir(renders_dir):
                continue
            renders = _read_dir(renders_dir)
            gts = dict(_read_dir(gt_dir))
            ssims, psnrs, lpipss, gmsds, names = [], [], [], [], []
            for name, img in renders:
                gt = gts[name]
                a, b = (torch.as_tensor(x, dtype=torch.float32, device=dev) for x in (img, gt))
                ssims.append(float(ssim_fn(a, b)))
                psnrs.append(float(psnr_fn(a, b)))
                lpipss.append(float(lpips(a, b)) if lpips else float("nan"))
                gmsds.append(gmsd(img, gt))
                names.append(name)
            full[method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                "LPIPS": float(np.mean(lpipss)),
                # which perceptual metric LPIPS actually is in this run:
                # calibrated lin-head LPIPS-vgg only when pretrained weights
                # exist locally, else NaN + the weight-free GMSD fallback
                "LPIPS_METRIC": (
                    "lpips-vgg-v0.1" if lpips is not None else "unavailable (NaN)"
                ),
                # weight-free perceptual fallback, always available (see
                # tpu_splat_torch.eval.lpips.gmsd; lower is better like LPIPS)
                "GMSD": float(np.mean(gmsds)),
            }
            per_view[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": dict(zip(names, lpipss)),
                "GMSD": dict(zip(names, gmsds)),
            }
            print(
                f"  {method}: PSNR {full[method]['PSNR']:.4f} "
                f"SSIM {full[method]['SSIM']:.4f} LPIPS {full[method]['LPIPS']:.4f} "
                f"GMSD {full[method]['GMSD']:.4f}"
            )
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)


def main(argv=None, device: str = "cuda"):
    parser = ArgumentParser()
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--split", default="test")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, args.split, device=device)


if __name__ == "__main__":
    main()
