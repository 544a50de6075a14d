"""Fit per-image mono-depth scale/offset against COLMAP sparse depth (port of
tpu_splat/scripts/make_depth_scale.py; role of reference
utils/make_depth_scale.py). Host only.

    python -m tpu_splat_torch.scripts.make_depth_scale --base_dir <scene> --depths_dir <dir>

For every registered image, projects its tracked 3D points into camera space,
samples the inverse mono-depth map at the tracked 2D keypoints (bilinear,
numpy — the reference uses cv2.remap), and fits a robust median/MAD
scale+offset between inverse COLMAP depth and inverse mono depth
(make_depth_scale.py:52-62). Writes sparse/0/depth_params.json.
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np

from tpu_splat_torch.data.colmap import (
    qvec2rotmat,
    read_model,
    read_points3d_ids_bin,
    read_points3d_ids_txt,
)


def bilinear_sample(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """img [H,W], xy [K,2] pixel coords -> [K] border-replicated bilinear."""
    H, W = img.shape
    x = np.clip(xy[:, 0], 0, W - 1)
    y = np.clip(xy[:, 1], 0, H - 1)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx, fy = x - x0, y - y0
    v = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )
    return v


def get_scale(image_meta, cam, points3d_ordered, depths_dir):
    from PIL import Image

    ids = image_meta.point3d_ids
    if ids is None:
        return None
    mask = (ids >= 0) & (ids < len(points3d_ordered))
    pts = points3d_ordered[ids[mask]]
    xys = image_meta.xys[mask]
    if len(pts) == 0:
        return None

    R = qvec2rotmat(image_meta.qvec)
    cam_pts = pts @ R.T + image_meta.tvec
    invcolmapdepth = 1.0 / np.maximum(cam_pts[..., 2], 1e-12)

    stem = os.path.splitext(image_meta.name)[0]
    depth_path = os.path.join(depths_dir, stem + ".png")
    if not os.path.exists(depth_path):
        return None
    invmono = np.asarray(Image.open(depth_path), np.float32)
    if invmono.ndim == 3:
        invmono = invmono[..., 0]
    invmono = invmono / (2**16)

    s = invmono.shape[0] / cam.height
    maps = xys * s
    valid = (
        (maps[:, 0] >= 0)
        & (maps[:, 1] >= 0)
        & (maps[:, 0] < cam.width * s)
        & (maps[:, 1] < cam.height * s)
        & (invcolmapdepth > 0)
    )
    if valid.sum() <= 10 or (
        invcolmapdepth.max() - invcolmapdepth.min()
    ) <= 1e-3:
        return {"image_name": stem, "scale": 0, "offset": 0}

    invc = invcolmapdepth[valid]
    invm = bilinear_sample(invmono, maps[valid])
    # robust median/MAD alignment (reference :53-60)
    t_c, t_m = np.median(invc), np.median(invm)
    s_c = np.mean(np.abs(invc - t_c))
    s_m = np.mean(np.abs(invm - t_m))
    scale = s_c / max(s_m, 1e-12)
    offset = t_c - t_m * scale
    return {"image_name": stem, "scale": float(scale), "offset": float(offset)}


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--base_dir", required=True)
    parser.add_argument("--depths_dir", required=True)
    args = parser.parse_args(argv)

    sparse = os.path.join(args.base_dir, "sparse", "0")
    cams, imgs, (xyz, _, _) = read_model(sparse, with_points2d=True)
    bin_path = os.path.join(sparse, "points3D.bin")
    ids = (
        read_points3d_ids_bin(bin_path)
        if os.path.exists(bin_path)
        else read_points3d_ids_txt(os.path.join(sparse, "points3D.txt"))
    )
    ordered = np.zeros((int(ids.max()) + 1, 3))
    ordered[ids] = xyz

    params = {}
    for im in imgs.values():
        rec = get_scale(im, cams[im.camera_id], ordered, args.depths_dir)
        if rec is not None:
            params[rec["image_name"]] = {
                "scale": rec["scale"],
                "offset": rec["offset"],
            }

    out = os.path.join(sparse, "depth_params.json")
    with open(out, "w") as f:
        json.dump(params, f, indent=2)
    print(f"wrote {out} ({len(params)} images)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
