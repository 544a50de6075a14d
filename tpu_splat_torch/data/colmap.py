"""COLMAP sparse model parsing (binary + text), numpy only.

Role of reference scene/colmap_loader.py: read cameras/images/points3D in
both .bin and .txt forms per the COLMAP file-format spec. Implemented from
the format documentation (fixed little-endian records), not translated.
"""
from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # [4] (w,x,y,z) world->cam rotation
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray | None = None  # [K,2] 2D keypoints (with_points2d only)
    point3d_ids: np.ndarray | None = None  # [K] int64, -1 = no track


# model id -> (name, #params) per COLMAP's camera model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * n_params))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_bin(path: str, with_points2d: bool = False) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            img_id, qw, qx, qy, qz, tx, ty, tz, cam_id = vals
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            xys = p3d_ids = None
            if with_points2d:
                rec = np.frombuffer(f.read(24 * n_pts), dtype="<f8").reshape(
                    n_pts, 3
                )
                xys = rec[:, :2].copy()
                p3d_ids = rec[:, 2].copy().view("<i8")
            else:
                f.read(24 * n_pts)  # xys (2 doubles) + point3D ids (int64)
            out[img_id] = ColmapImage(
                img_id,
                np.array([qw, qx, qy, qz]),
                np.array([tx, ty, tz]),
                cam_id,
                name.decode("utf-8"),
                xys,
                p3d_ids,
            )
    return out


def read_points3d_bin(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n, np.float64)
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_cameras_txt(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            out[cam_id] = ColmapCamera(
                cam_id,
                parts[1],
                int(parts[2]),
                int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return out


def read_images_txt(path: str, with_points2d: bool = False) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        # two lines per image; the POINTS2D line may be blank, so only
        # comments are filtered (blank lines are kept for pairing)
        lines = [
            l.rstrip("\n") for l in f if not l.strip().startswith("#")
        ]
    while lines and not lines[-1].strip():
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        img_id = int(parts[0])
        q = np.array([float(x) for x in parts[1:5]])
        t = np.array([float(x) for x in parts[5:8]])
        xys = p3d_ids = None
        if with_points2d and i + 1 < len(lines):
            vals = lines[i + 1].split()
            rec = np.array(vals, np.float64).reshape(-1, 3) if vals else np.zeros((0, 3))
            xys = rec[:, :2].copy()
            p3d_ids = rec[:, 2].astype(np.int64)
        out[img_id] = ColmapImage(
            img_id, q, t, int(parts[8]), parts[9], xys, p3d_ids
        )
    return out


def read_points3d_txt(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(x) for x in p[1:4]])
            rgb.append([int(x) for x in p[4:7]])
            err.append(float(p[7]))
    return (
        np.array(xyz, np.float64),
        np.array(rgb, np.uint8),
        np.array(err, np.float64),
    )


def read_points3d_ids_bin(path: str) -> np.ndarray:
    """Point ids parallel to read_points3d_bin's arrays (needed to resolve
    per-image point3D_id references, e.g. make_depth_scale)."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        ids = np.empty(n, np.int64)
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            ids[i] = vals[0]
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return ids


def read_points3d_ids_txt(path: str) -> np.ndarray:
    ids = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ids.append(int(line.split()[0]))
    return np.array(ids, np.int64)


def read_model(sparse_dir: str, with_points2d: bool = False):
    """Read a COLMAP sparse model dir, preferring binary."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(
            os.path.join(sparse_dir, "images.bin"), with_points2d=with_points2d
        )
        pts = read_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(
            os.path.join(sparse_dir, "images.txt"), with_points2d=with_points2d
        )
        pts = read_points3d_txt(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, pts


# ---------------------------------------------------------------------------
# Writers (role of reference utils/read_write_model.py write_* functions):
# emit spec-conformant models that COLMAP / other 3DGS tools can open.

_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def write_cameras_bin(cams: dict[int, ColmapCamera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(
                struct.pack(
                    "<iiQQ", cam.id, _MODEL_IDS[cam.model], cam.width, cam.height
                )
            )
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_cameras_txt(cams: dict[int, ColmapCamera], path: str):
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_bin(imgs: dict[int, ColmapImage], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            q, t = im.qvec, im.tvec
            f.write(
                struct.pack(
                    "<idddddddi",
                    im.id, q[0], q[1], q[2], q[3], t[0], t[1], t[2],
                    im.camera_id,
                )
            )
            f.write(im.name.encode("utf-8") + b"\x00")
            n_pts = 0 if im.xys is None else len(im.xys)
            f.write(struct.pack("<Q", n_pts))
            if n_pts:
                rec = np.empty((n_pts, 3), "<f8")
                rec[:, :2] = im.xys
                rec[:, 2] = im.point3d_ids.astype("<i8").view("<f8")
                f.write(rec.tobytes())


def write_images_txt(imgs: dict[int, ColmapImage], path: str):
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID, QW QX QY QZ, TX TY TZ, CAMERA_ID, NAME\n")
        for im in imgs.values():
            q = " ".join(repr(float(x)) for x in im.qvec)
            t = " ".join(repr(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            if im.xys is None:
                f.write("\n")
            else:
                pts = " ".join(
                    f"{x} {y} {int(i)}"
                    for (x, y), i in zip(im.xys, im.point3d_ids)
                )
                f.write(pts + "\n")


def write_points3d_bin(xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray,
                       path: str, ids: np.ndarray | None = None):
    n = len(xyz)
    if ids is None:
        ids = np.arange(1, n + 1, dtype=np.int64)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(
                struct.pack(
                    "<QdddBBBd",
                    int(ids[i]), *xyz[i], *(int(c) for c in rgb[i]), float(err[i]),
                )
            )
            f.write(struct.pack("<Q", 0))  # empty track


def write_points3d_txt(xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray,
                       path: str, ids: np.ndarray | None = None):
    n = len(xyz)
    if ids is None:
        ids = np.arange(1, n + 1, dtype=np.int64)
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID, X Y Z, R G B, ERROR, TRACK[]\n")
        for i in range(n):
            p = " ".join(repr(float(v)) for v in xyz[i])
            c = " ".join(str(int(v)) for v in rgb[i])
            f.write(f"{int(ids[i])} {p} {c} {float(err[i])}\n")


def write_model(cams, imgs, pts, sparse_dir: str, ext: str = ".bin"):
    os.makedirs(sparse_dir, exist_ok=True)
    xyz, rgb, err = pts
    if ext == ".bin":
        write_cameras_bin(cams, os.path.join(sparse_dir, "cameras.bin"))
        write_images_bin(imgs, os.path.join(sparse_dir, "images.bin"))
        write_points3d_bin(xyz, rgb, err, os.path.join(sparse_dir, "points3D.bin"))
    else:
        write_cameras_txt(cams, os.path.join(sparse_dir, "cameras.txt"))
        write_images_txt(imgs, os.path.join(sparse_dir, "images.txt"))
        write_points3d_txt(xyz, rgb, err, os.path.join(sparse_dir, "points3D.txt"))
