"""Scene: cameras + point cloud + persistence (port of
tpu_splat/data/scene.py; reference scene/__init__.py).

Loads a dataset dir (COLMAP or Blender), applies the resolution policy,
builds the port's Camera objects and keeps each ground-truth image (and
alpha) as a float32 tensor on the data device, so a training step reads it
where it computes; computes cameras_extent (NeRF++ radius) and cameras_mean
(the reference's `translate` = -mean center, scene/__init__.py:92-93, kept
verbatim since densify pruning consumes it); and saves model snapshots
under point_cloud/iteration_N/point_cloud.ply with both cubemap sidecars.
"""
from __future__ import annotations

import json
import os
import random

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.graphics import Camera
from tpu_splat_torch.data.readers import load_scene_info, resolution_policy


class LoadedCamera:
    """A Camera plus its ground-truth image and optional alpha mask."""

    def __init__(self, camera: Camera, image: torch.Tensor, alpha, name: str, uid: int):
        self.camera = camera
        self.image = image  # [H,W,3] float32 on the data device
        self.alpha = alpha  # [H,W,1] or None
        self.image_name = name
        self.uid = uid
        # position this camera holds in the TRAINING order (the seeded
        # shuffle): the per-frame ISP index the train step used for it
        # (reference render.py:58-59 reuses frame indices at eval time).
        # Set by Scene; -1 for test cameras (controller path).
        self.frame_idx = -1


class Scene:
    def __init__(
        self,
        source_path: str,
        model_path: str = "",
        images: str = "images",
        resolution: int = -1,
        eval_split: bool = False,
        shuffle: bool = True,
        num_points: int = 100_000,
        load_limit: int | None = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        from tpu_splat_torch.data.native_loader import decoder

        self.model_path = model_path
        self.device = resolve_device(device)
        info = load_scene_info(source_path, images, eval_split, num_points)
        self.info = info
        self.cameras_extent = info.radius
        self.cameras_mean = info.translate  # sic: see the module docstring
        self.decoder = decoder()
        print(f"image decoder: {self.decoder}")

        # frame indices are positions in the SHUFFLED training order (what
        # the train step passes as frame_idx); when loading unshuffled (the
        # render/eval tools), recover each camera's training position from
        # the same seeded permutation so the per-frame ISP maps correctly
        n_train = len(info.train_cameras)
        perm = list(range(n_train))
        random.Random(seed).shuffle(perm)  # shuffled[j] = orig[perm[j]]
        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(info.train_cameras)
            rng.shuffle(info.test_cameras)
            train_frame_idx = list(range(n_train))
        else:
            inv = [0] * n_train
            for j, i in enumerate(perm):
                inv[i] = j
            train_frame_idx = inv

        self._resolution = resolution
        self.train_cameras = self._load_set(info.train_cameras[:load_limit])
        self.test_cameras = self._load_set(info.test_cameras[:load_limit])
        for lc, fi in zip(self.train_cameras, train_frame_idx):
            lc.frame_idx = fi

    def _load_set(self, cam_infos) -> list:
        """Decode ahead on the native C++ thread pool (ordered), finish
        (resize, alpha merge, Camera build, copy to the device) here."""
        from tpu_splat_torch.data.native_loader import PrefetchingImageLoader
        from tpu_splat_torch.data.readers import finish_image

        out = []
        loader = PrefetchingImageLoader([c.image_path for c in cam_infos])
        for idx, arr in loader:
            ci = cam_infos[idx]
            W, H = resolution_policy(ci.width, ci.height, self._resolution)
            img, alpha = finish_image(arr, (W, H), ci.alpha_path)
            out.append(self._make_camera(ci, img, alpha))
        return out

    def _make_camera(self, ci, img: np.ndarray, alpha) -> LoadedCamera:
        W = img.shape[1]
        K = None
        if ci.K is not None:
            K = ci.K.copy()
            K[:2] *= W / ci.width  # account for resize (+ any pre-downscaled files)
        cam = Camera.create(
            R=ci.R, T=ci.T, fovx=ci.fovx, fovy=ci.fovy,
            height=img.shape[0], width=img.shape[1], K=K, device=self.device,
        )
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)
        return LoadedCamera(cam, t(img), None if alpha is None else t(alpha),
                            ci.image_name, ci.uid)

    @property
    def point_cloud(self):
        return self.info.point_cloud

    def save(self, state, iteration: int) -> str:
        """The PLY of `state` with its `.map.npz` and `.map` sidecars."""
        from tpu_splat_torch.model.io import save_ply

        out = os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"
        )
        save_ply(state, out)
        return out

    def save_cameras_json(self):
        """reference scene/__init__.py:74-86 cameras.json persistence."""
        entries = []
        for i, lc in enumerate(self.train_cameras):
            c = lc.camera
            R = c.world_view[:3, :3].cpu().numpy().T
            pos = c.camera_center.cpu().numpy()
            K = c.K.cpu().numpy()
            entries.append(
                {
                    "id": i,
                    "img_name": lc.image_name,
                    "width": c.width,
                    "height": c.height,
                    "position": pos.tolist(),
                    "rotation": [r.tolist() for r in R],
                    "fy": float(K[1, 1]),
                    "fx": float(K[0, 0]),
                }
            )
        os.makedirs(self.model_path, exist_ok=True)
        with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
            json.dump(entries, f)
