"""Failure snapshot dumps (port of tpu_splat/train/debug_dump.py; role of
the reference debug path, diff_surfel_rasterization/__init__.py:91-98,
which writes every rasterizer input when the CUDA kernel fails, so the
failure can be reproduced offline).

The failure modes the training CLI watches are a non-finite loss and an
instance-capacity overflow. On the first such event it calls
dump_snapshot(), which writes ONE npz with the full rasterizer input set
(Gaussian arrays, camera matrices, image shape and config scalars, ground
truth) plus the reason: the JAX package's keys and dtypes, so either
package can replay `render()` from it.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dump_snapshot(
    model_path: str,
    gaussians,
    camera,
    gt_image,
    iteration: int,
    reason: str,
    cfg=None,
    bg=None,
) -> str:
    """Write snapshot_fw.npz into the model dir (once per run: an existing
    dump is kept, so the FIRST failure is preserved). Returns the path, or
    "" if a dump already exists."""
    path = os.path.join(model_path or ".", "snapshot_fw.npz")
    if os.path.exists(path):
        return ""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = {
        "reason": np.asarray(reason),
        "iteration": np.asarray(iteration),
        "xyz": _host(gaussians.xyz),
        "scaling": _host(gaussians.scaling),
        "rotation": _host(gaussians.rotation),
        "opacity": _host(gaussians.opacity),
        "refl": _host(gaussians.refl),
        "features_dc": _host(gaussians.features_dc),
        "features_rest": _host(gaussians.features_rest),
        "alive": _host(gaussians.alive),
        "active_sh_degree": np.asarray(gaussians.active_sh_degree, np.int32),
        "env_texture": _host(gaussians.env.texture),
        "env_fail_value": _host(gaussians.env.fail_value),
        "cam_world_view": _host(camera.world_view),
        "cam_full_proj": _host(camera.full_proj),
        "cam_center": _host(camera.camera_center),
        "cam_K": _host(camera.K),
        "cam_hw": np.asarray([camera.height, camera.width]),
    }
    if gt_image is not None:
        data["gt_image"] = _host(gt_image)
    if bg is not None:
        data["bg"] = _host(bg)
    if cfg is not None:
        data["cfg_max_instances"] = np.asarray(cfg.max_instances)
        data["cfg_max_tiles_per_gaussian"] = np.asarray(cfg.max_tiles_per_gaussian)
        data["cfg_tile_depth"] = np.asarray(cfg.tile_depth)
    np.savez_compressed(path, **data)
    return path
