"""Gaussian model state with static capacity and an `alive` mask.

Port of tpu_splat/model/state.py. Raw (pre-activation) parameters as the
reference: scaling = log(scale) [P,2] for 2DGS surfels (disks) or [P,3]
for volumetric 3DGS Gaussians (3DGS-DR; `volumetric`), opacity/refl =
logit [P,1], rotation = unnormalized quaternion (w,x,y,z) [P,4],
features_dc [P,1,3], features_rest [P,(D+1)^2-1,3]. Rows past the live
Gaussians are dead (`alive` False) and render nothing. `param_pytree` /
`with_params` give the optimizable leaves as a dict, as the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core import f32
from tpu_splat_torch.core.sh import num_sh_coeffs, rgb_to_sh
from tpu_splat_torch.envmap.cubemap import CubemapParams, init_cubemap

# band index of each SH coefficient (degree <= 3)
_BANDS = np.array([0] + [1] * 3 + [2] * 5 + [3] * 7, dtype=np.int32)


def sh_band_mask(active_degree: int, n_coeffs: int, device="cpu") -> torch.Tensor:
    """[n_coeffs] 0/1 mask of coefficients enabled at `active_degree`."""
    return torch.as_tensor(
        (_BANDS[:n_coeffs] <= int(active_degree)).astype(np.float32), device=device
    )


@dataclasses.dataclass
class GaussianState:
    xyz: torch.Tensor  # [P,3]
    features_dc: torch.Tensor  # [P,1,3]
    features_rest: torch.Tensor  # [P,M-1,3]
    scaling: torch.Tensor  # [P,2] log-scale (surfels) or [P,3] (volumetric)
    rotation: torch.Tensor  # [P,4] quat (w,x,y,z)
    opacity: torch.Tensor  # [P,1] logit
    refl: torch.Tensor  # [P,1] logit
    env: CubemapParams
    alive: torch.Tensor  # [P] bool
    active_sh_degree: int = 0
    max_sh_degree: int = 3

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def volumetric(self) -> bool:
        """Three scale axes: the volumetric 3DGS family, else surfels."""
        return self.scaling.shape[-1] == 3

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    def get_scaling(self) -> torch.Tensor:
        return f32.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        """[P] sigmoid opacity, zeroed for dead rows."""
        return f32.sigmoid(self.opacity[:, 0]) * self.alive

    def get_refl(self) -> torch.Tensor:
        return f32.sigmoid(self.refl[:, 0])

    def get_features(self) -> torch.Tensor:
        """[P,M,3] SH coefficients with inactive bands masked."""
        sh = torch.cat([self.features_dc, self.features_rest], dim=1)
        m = sh_band_mask(self.active_sh_degree, sh.shape[1], device=sh.device)
        return sh * m[None, :, None]

    def param_pytree(self) -> dict:
        """The optimizable leaves (excludes alive / active_sh_degree)."""
        return dict(
            xyz=self.xyz,
            features_dc=self.features_dc,
            features_rest=self.features_rest,
            scaling=self.scaling,
            rotation=self.rotation,
            opacity=self.opacity,
            refl=self.refl,
            env_texture=self.env.texture,
            env_fail=self.env.fail_value,
        )

    def with_params(self, p: dict) -> "GaussianState":
        return dataclasses.replace(
            self,
            xyz=p["xyz"],
            features_dc=p["features_dc"],
            features_rest=p["features_rest"],
            scaling=p["scaling"],
            rotation=p["rotation"],
            opacity=p["opacity"],
            refl=p["refl"],
            env=CubemapParams(texture=p["env_texture"], fail_value=p["env_fail"]),
        )


def _knn_mean_sq_dist(points: np.ndarray, k: int = 3, chunk: int = 1024) -> np.ndarray:
    """Mean squared distance to the k nearest neighbours (role of
    simple-knn's distCUDA2, used once at init): exact, through a KD-tree,
    with a chunked O(N^2) numpy fallback when scipy is missing."""
    n = points.shape[0]
    kk = min(k, max(1, n - 1))
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        cKDTree = None
    if cKDTree is not None and n > 2:
        tree = cKDTree(np.asarray(points, np.float64))
        d, _ = tree.query(points, k=kk + 1, workers=-1)  # the first hit is itself
        return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
    out = np.empty(n, dtype=np.float32)
    for s in range(0, n, chunk):
        blk = points[s : s + chunk]
        d2 = ((blk[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        d2[np.arange(len(blk)), np.arange(s, min(s + chunk, n))] = np.inf
        out[s : s + chunk] = np.partition(d2, kk - 1, axis=1)[:, :kk].mean(axis=1)
    return out


def init_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    max_sh_degree: int = 3,
    init_opacity: float = 0.1,
    init_refl_value: float = 1e-3,
    cubemap_resolution: int = 128,
    seed: int = 0,
    device: str | torch.device = "cuda",
    volumetric: bool = False,
) -> GaussianState:
    """Initialize from a point cloud (reference create_from_pcd,
    scene/gaussian_model.py:160-187): DC SH from RGB, log-scales from the
    3-NN mean distance, log(sqrt(dist2)) on each of 2 axes (3 with
    `volumetric`, 3DGS's own init), random quaternions, opacity 0.1, refl
    1e-3. The quaternions are numpy draws from `seed`, as the JAX package's;
    the cubemap texture is drawn by a torch.Generator seeded with `seed`
    (jax.random's bits cannot be reproduced)."""
    dev = resolve_device(device)
    n = points.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} points")
    m = num_sh_coeffs(max_sh_degree)
    rng = np.random.default_rng(seed)
    dist2 = np.clip(_knn_mean_sq_dist(points.astype(np.float32)), 1e-7, None)
    log_scale = np.log(np.sqrt(dist2))[:, None].repeat(3 if volumetric else 2, axis=1)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)

    def pad(a, fill=0.0):
        out = np.full((capacity,) + a.shape[1:], fill, dtype=np.float32)
        out[:n] = a
        return torch.as_tensor(out, device=dev)

    logit = lambda v: float(np.log(v / (1 - v)))
    rot = pad(quats)
    rot[n:, 0] = 1.0
    alive = np.zeros(capacity, bool)
    alive[:n] = True
    env = init_cubemap(torch.Generator().manual_seed(seed), 3, cubemap_resolution, device=dev)
    return GaussianState(
        xyz=pad(points.astype(np.float32)),
        features_dc=pad(rgb_to_sh(np.asarray(colors, np.float32))[:, None, :]),
        features_rest=pad(np.zeros((n, m - 1, 3), np.float32)),
        scaling=pad(log_scale, fill=-10.0),
        rotation=rot,
        opacity=pad(np.full((n, 1), logit(init_opacity), np.float32), fill=-10.0),
        refl=pad(np.full((n, 1), logit(init_refl_value), np.float32), fill=-10.0),
        env=env,
        alive=torch.as_tensor(alive, device=dev),
        active_sh_degree=0,
        max_sh_degree=max_sh_degree,
    )
