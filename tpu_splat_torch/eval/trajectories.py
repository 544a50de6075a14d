"""Camera-path generation for turntable/ellipse videos (port of
tpu_splat/eval/trajectories.py; role of reference utils/render_utils.py:
transform_poses_pca, generate_ellipse_path). The poses are numpy, with the
JAX package's arithmetic and dtypes (the cameras' float32 matrices in,
float64 paths out); only the final cameras are tensors, on the views'
device. Consumed by scripts/video.py and scripts/render_videos.py."""
from __future__ import annotations

import numpy as np

from tpu_splat_torch.core.graphics import Camera


def poses_from_cameras(cams) -> np.ndarray:
    """[N,3,4] c2w poses from LoadedCamera list."""
    out = []
    for lc in cams:
        W = lc.camera.world_view.cpu().numpy()
        R_c2w = W[:3, :3].T
        c = lc.camera.camera_center.cpu().numpy()
        out.append(np.concatenate([R_c2w, c[:, None]], axis=1))
    return np.stack(out)


def _pad4(poses: np.ndarray) -> np.ndarray:
    """[N,3,4] -> [N,4,4] homogeneous."""
    bottom = np.broadcast_to(np.eye(4)[3:], (len(poses), 1, 4))
    return np.concatenate([poses, bottom], axis=1)


def transform_poses_pca(poses: np.ndarray):
    """Recenter/rotate poses so the principal axes of the camera-center
    cloud align with the coordinate axes (the MipNeRF-360 canonicalization;
    behavioral counterpart of reference render_utils.py:80-121).

    Returns (recentered [N,3,4], transform [3,4]) with
    recentered = transform @ pad4(poses)."""
    centers = poses[:, :3, 3]
    mu = centers.mean(axis=0)
    x = centers - mu
    # symmetric eigendecomposition; eigh returns ascending eigenvalues, so
    # reversing the columns gives principal-axis-major order
    _, v = np.linalg.eigh(x.T @ x)
    basis = v[:, ::-1].copy()
    if np.linalg.det(basis) < 0:
        basis[:, -1] = -basis[:, -1]  # keep the frame right-handed
    rot = basis.T
    transform = np.concatenate([rot, rot @ -mu[:, None]], axis=1)  # [3,4]
    rec = np.einsum("ij,njk->nik", transform, _pad4(poses))
    # orient so cameras look "down" in the canonical frame (average camera
    # y-axis has positive z)
    if rec.mean(axis=0)[2, 1] < 0:
        flip = np.diag([1.0, -1.0, -1.0])
        rec = np.einsum("ij,njk->nik", flip, rec)
        transform = flip @ transform
    return rec, transform


def generate_ellipse_path(
    poses: np.ndarray, n_frames: int = 120, z_variation: float = 0.0,
    z_phase: float = 0.0
) -> np.ndarray:
    """Elliptical orbit fitted to the pose cloud (reference
    render_utils.py:123-174). poses: [N,3,4] recentered c2w. -> [F,3,4]."""
    center = poses[:, :3, 3].mean(axis=0) * np.array([1, 1, 0])
    offset = center + np.array([0, 0, poses[:, 2, 3].mean()])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    theta = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    positions = np.stack(
        [
            offset[0] + sc[0] * np.cos(theta),
            offset[1] + sc[1] * np.sin(theta),
            offset[2]
            + z_variation * sc[2] * np.sin(theta + 2 * np.pi * z_phase),
        ],
        axis=-1,
    )
    look = center
    up = np.array([0.0, 0.0, 1.0])
    out = []
    for p in positions:
        fwd = look - p
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1)
        out.append(np.concatenate([R, p[:, None]], axis=1))
    return np.stack(out)


def cameras_from_path(path_c2w: np.ndarray, template: Camera) -> list[Camera]:
    """One Camera per [3,4] c2w pose, with the template's intrinsics, on
    the template's device."""
    cams = []
    for pose in path_c2w:
        R = pose[:3, :3]
        c = pose[:3, 3]
        T = -R.T @ c
        cams.append(
            Camera.create(
                R=R, T=T, fovx=template.fovx, fovy=template.fovy,
                height=template.height, width=template.width,
                K=template.K.cpu().numpy(), device=template.device,
            )
        )
    return cams


def generate_path(cams, n_frames: int = 480, z_variation: float = 0.0,
                  z_phase: float = 0.0) -> list[Camera]:
    """Smooth orbit path through the training-camera cloud: PCA-recenter,
    fit the ellipse in the canonical frame, warp back to world coordinates,
    and instantiate cameras from the first view's intrinsics (role of
    reference utils/render_utils.py:176-208 generate_path). The cameras
    live on the first view's device."""
    poses = poses_from_cameras(cams)
    rec, transform = transform_poses_pca(poses)
    path = generate_ellipse_path(
        rec, n_frames=n_frames, z_variation=z_variation, z_phase=z_phase
    )
    t4 = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    back = np.linalg.inv(t4)
    world = np.einsum("ij,njk->nik", back, _pad4(path))[:, :3]
    return cameras_from_path(world, cams[0].camera)
