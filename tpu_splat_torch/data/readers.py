"""Dataset readers: COLMAP scenes and Blender/NeRF-synthetic transforms
(port of tpu_splat/data/readers.py).

Role of reference scene/dataset_readers.py + utils/camera_utils.py: probe the
source dir, build CameraInfo lists (R = c2w rotation, T = w2v translation, K,
FoVs, image path), NeRF++ normalization (radius*1.1 and translate), eval
split every 8th image (llffhold), resolution policy (divisors {1,2,4,6,8},
auto-downscale to max dim 900), RGBA/sidecar alpha masks.

Images are loaded lazily as numpy [H,W,3] float in [0,1] (channels-last, as
the JAX package) + optional [H,W,1] alpha. Pillow is imported only where an
image is resized, a sidecar alpha is read or a file is not a PNG: a
full-resolution PNG scene loads without it.

Note vs reference: readCamerasFromTransforms in the fork swaps FovX/FovY for
the camera_angle_x path (dataset_readers.py:281-282) — a bug that is benign
on square Blender images; we compute them correctly (flagged in SURVEY §2.11).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from tpu_splat_torch.core.graphics import focal2fov, fov2focal
from tpu_splat_torch.data.colmap import read_model, qvec2rotmat

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # [3,3] c2w rotation
    T: np.ndarray  # [3] w2v translation
    K: np.ndarray | None  # [3,3] at original resolution
    fovx: float
    fovy: float
    width: int
    height: int
    image_path: str
    image_name: str
    alpha_path: str | None = None
    rgba: bool = False


@dataclass
class SceneInfo:
    point_cloud: tuple  # (xyz [N,3], rgb [N,3] in [0,1])
    train_cameras: list
    test_cameras: list
    translate: np.ndarray
    radius: float
    ply_path: str | None = None


def nerfpp_norm(cam_infos) -> tuple[np.ndarray, float]:
    """NeRF++ scene normalization (reference getNerfppNorm,
    dataset_readers.py:46-67): radius = 1.1 * max distance of camera centers
    from their mean; translate = -mean."""
    centers = []
    for c in cam_infos:
        centers.append(-c.R @ c.T)
    centers = np.stack(centers, axis=0)
    center = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - center, axis=-1).max()
    return -center, float(diagonal * 1.1)


def finish_image(
    arr_u8: np.ndarray,
    resolution: tuple[int, int],
    alpha_path: str | None = None,
):
    """Resize a decoded [H,W,C] uint8 array + split/merge alpha -> (rgb
    [H,W,3] float32 in [0,1], alpha [H,W,1] or None)."""
    if arr_u8.ndim == 2:
        arr_u8 = arr_u8[..., None]
    h, w = arr_u8.shape[:2]
    if (w, h) != resolution:
        from PIL import Image

        mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[arr_u8.shape[-1]]
        img = Image.fromarray(
            arr_u8[..., 0] if mode == "L" else arr_u8, mode=mode
        ).resize(resolution)
        arr_u8 = np.asarray(img)
        if arr_u8.ndim == 2:
            arr_u8 = arr_u8[..., None]
    arr = arr_u8.astype(np.float32) / 255.0
    alpha = None
    if arr.shape[-1] == 1:
        arr = arr.repeat(3, axis=-1)
    if arr.shape[-1] == 2:  # gray + alpha
        alpha = arr[..., 1:2]
        arr = arr[..., 0:1].repeat(3, axis=-1)
    if arr.shape[-1] == 4:
        alpha = arr[..., 3:4]
        arr = arr[..., :3]
    if alpha_path is not None and os.path.exists(alpha_path):
        from PIL import Image

        a = Image.open(alpha_path).resize(resolution)
        a = np.asarray(a).astype(np.float32) / 255.0
        if a.ndim == 3:
            a = a[..., 0]
        alpha = a[..., None]
    return np.clip(arr, 0.0, 1.0), alpha


def image_size(path: str) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk, else through Pillow."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == _PNG_SIGNATURE and head[12:16] == b"IHDR":
        return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def resolution_policy(orig_w: int, orig_h: int, resolution_arg: int, scale: float = 1.0):
    """Reference loadCam resolution handling (utils/camera_utils.py:19-44):
    divisors {1,2,4,6,8}, -1 => auto-downscale so max dim <= 900, other
    values = target width."""
    if resolution_arg in (1, 2, 4, 6, 8):
        s = scale * resolution_arg
        return round(orig_w / s), round(orig_h / s)
    if resolution_arg == -1:
        max_dim = max(orig_w, orig_h)
        global_down = max_dim / 900 if max_dim > 900 else 1
    else:
        global_down = orig_w / resolution_arg
    s = float(global_down) * scale
    return int(orig_w / s), int(orig_h / s)


def read_colmap_scene(
    path: str, images_dir: str = "images", eval_split: bool = False, llffhold: int = 8
) -> SceneInfo:
    """Reference readColmapSceneInfo (dataset_readers.py:170-217)."""
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams, imgs, (xyz, rgb, _err) = read_model(sparse)

    infos = []
    for img_id in sorted(imgs, key=lambda i: imgs[i].name):
        extr = imgs[img_id]
        intr = cams[extr.camera_id]
        R = qvec2rotmat(extr.qvec).T  # c2w (3DGS convention)
        T = extr.tvec
        h, w = intr.height, intr.width
        p = intr.params
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        elif intr.model in ("PINHOLE", "OPENCV"):
            fx, fy = p[0], p[1]
            cx, cy = p[2], p[3]
        else:
            raise ValueError(
                f"Colmap camera model not handled: {intr.model} (undistort first)"
            )
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)
        fovx = focal2fov(fx, w)
        fovy = focal2fov(fy, h)
        image_path = os.path.join(path, images_dir, os.path.basename(extr.name))
        # image files may be downscaled copies (images_2/ etc) — fix K scale
        # at load time like the reference (:130-131) via actual image size
        infos.append(
            CameraInfo(
                uid=img_id, R=R, T=T, K=K, fovx=fovx, fovy=fovy, width=w, height=h,
                image_path=image_path,
                image_name=os.path.basename(image_path).split(".")[0],
            )
        )

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    translate, radius = nerfpp_norm(train)
    rgbf = rgb.astype(np.float32) / 255.0
    return SceneInfo(
        point_cloud=(xyz.astype(np.float32), rgbf),
        train_cameras=train,
        test_cameras=test,
        translate=translate,
        radius=radius,
    )


def _read_transforms(path: str, transforms_file: str, extension: str = ".png"):
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = contents.get("camera_angle_x")
    glossy_real = "GlossyReal" in contents
    infos = []
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        img_path = os.path.join(path, file_path + extension)
        if not os.path.exists(img_path) and os.path.exists(
            os.path.join(path, file_path)
        ):
            img_path = os.path.join(path, file_path)
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes (dataset_readers.py:240-247)
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        w, h = image_size(img_path)  # from the file header, no decode

        if fovx is None:
            focal = frame["fl_x"] if glossy_real else contents["fl_x"]
            fx = fy = focal
        else:
            fx = fy = fov2focal(fovx, w)
        K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], dtype=np.float64)
        alpha_path = os.path.join(path, file_path + "_alpha" + extension)
        infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, K=K,
                fovx=focal2fov(fx, w), fovy=focal2fov(fy, h),
                width=w, height=h,
                image_path=img_path,
                image_name=Path(img_path).stem,
                alpha_path=alpha_path if os.path.exists(alpha_path) else None,
                rgba=True,
            )
        )
    return infos


def read_blender_scene(
    path: str, eval_split: bool = False, extension: str = ".png",
    num_points: int = 100_000, seed: int = 0
) -> SceneInfo:
    """Reference readNerfSyntheticInfo (dataset_readers.py:290-325)."""
    train = _read_transforms(path, "transforms_train.json", extension)
    test = (
        _read_transforms(path, "transforms_test.json", extension)
        if os.path.exists(os.path.join(path, "transforms_test.json"))
        else []
    )
    if not eval_split:
        train = train + test
        test = []
    translate, radius = nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        xyz, rgb = read_points_ply(ply_path)
    else:
        rng = np.random.default_rng(seed)
        xyz = (rng.random((num_points, 3)) * 2.6 - 1.3).astype(np.float32)
        rgb = (rng.random((num_points, 3)) / 255.0 * 0.28209479177387814 + 0.5).astype(
            np.float32
        )
    return SceneInfo(
        point_cloud=(xyz, rgb),
        train_cameras=train,
        test_cameras=test,
        translate=translate,
        radius=radius,
        ply_path=ply_path,
    )


def read_points_ply(path: str):
    """Minimal point-cloud PLY reader (xyz + rgb)."""
    from tpu_splat_torch.model.io import _read_ply

    cols, n = _read_ply(path)
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    if "red" in cols:
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1) / 255.0
    else:
        rgb = np.full((n, 3), 0.5, np.float32)
    return xyz, rgb.astype(np.float32)


def detect_scene_type(path: str) -> str:
    """Reference Scene.__init__ probing (scene/__init__.py:66-72)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "Blender"
    raise ValueError(f"Could not recognize scene type for {path}")


def load_scene_info(path: str, images: str = "images", eval_split: bool = False,
                    num_points: int = 100_000) -> SceneInfo:
    kind = detect_scene_type(path)
    if kind == "Colmap":
        return read_colmap_scene(path, images, eval_split)
    return read_blender_scene(path, eval_split, num_points=num_points)
