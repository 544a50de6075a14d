"""Carry a model, a camera and a whole training state across packages as
plain numpy arrays.

`state_from_numpy` takes the leaves of a JAX `GaussianState` as numpy arrays
(the cubemap as `texture` / `fail_value`) and builds the port's state;
`camera_from_numpy` does the same for a `Camera`; `train_state_from_numpy`
for a `TrainState` (parameters, Adam moments and count, densify stats, ISP,
step and opacity rate). Both packages then compute on bit-identical inputs.
The `*_to_numpy` functions go the other way, so results compare leaf by
leaf. A training state carries across whatever the scheduled events and
capacity growth change: the alive mask, rows padded to a new capacity, the
moments and statistics, the pulsed opacity rate, a cubemap of another
resolution; so the two packages can be compared after every event.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_splat_torch.core.device import resolve_device
from tpu_splat_torch.core.graphics import Camera
from tpu_splat_torch.envmap.cubemap import CubemapParams
from tpu_splat_torch.model.state import GaussianState

_FLOAT_LEAVES = (
    "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
    "refl",
)
_CAMERA_MATRICES = ("world_view", "proj", "full_proj", "camera_center", "K")
_CAMERA_SCALARS = ("height", "width", "fovx", "fovy", "znear", "zfar")


def state_from_numpy(d: dict, device: str | torch.device = "cuda") -> GaussianState:
    """d: xyz, features_dc, features_rest, scaling, rotation, opacity, refl,
    texture, fail_value, alive, active_sh_degree, max_sh_degree."""
    dev = resolve_device(device)
    f32 = lambda k: torch.tensor(np.asarray(d[k], np.float32), device=dev)
    return GaussianState(
        **{k: f32(k) for k in _FLOAT_LEAVES},
        env=CubemapParams(texture=f32("texture"), fail_value=f32("fail_value")),
        alive=torch.tensor(np.asarray(d["alive"], bool), device=dev),
        active_sh_degree=int(d["active_sh_degree"]),
        max_sh_degree=int(d["max_sh_degree"]),
    )


def camera_from_numpy(d: dict, device: str | torch.device = "cuda") -> Camera:
    """d: world_view, proj, full_proj, camera_center, K (arrays) and height,
    width, fovx, fovy, znear, zfar (scalars)."""
    dev = resolve_device(device)
    mats = {
        k: torch.tensor(np.asarray(d[k], np.float32), device=dev)
        for k in _CAMERA_MATRICES
    }
    scal = {k: d[k] for k in _CAMERA_SCALARS}
    for k in ("height", "width"):
        scal[k] = int(scal[k])
    for k in ("fovx", "fovy", "znear", "zfar"):
        scal[k] = float(scal[k])
    return Camera(**mats, **scal)


def state_to_numpy(state: GaussianState) -> dict:
    """The reverse of `state_from_numpy`."""
    d = {k: getattr(state, k).detach().cpu().numpy() for k in _FLOAT_LEAVES}
    d.update(
        texture=state.env.texture.detach().cpu().numpy(),
        fail_value=state.env.fail_value.detach().cpu().numpy(),
        alive=state.alive.cpu().numpy(),
        active_sh_degree=int(state.active_sh_degree),
        max_sh_degree=int(state.max_sh_degree),
    )
    return d


_STATS = ("grad_accum", "denom", "accum_w", "denom_w", "max_radii")


def train_state_from_numpy(d: dict, device: str | torch.device = "cuda"):
    """A whole training state as numpy arrays -> the port's `TrainState`.
    d: gaussians (as `state_from_numpy` takes it), mu / nu (parameter key ->
    Adam moment), count (Adam steps), stats (the DensifyStats fields), isp
    (the ISPParams fields, or None), step, opacity_lr and seed (of the
    state's torch.Generator)."""
    from tpu_splat_torch.isp.ppisp import ISPParams
    from tpu_splat_torch.model.densify import DensifyStats
    from tpu_splat_torch.model.optim import AdamState
    from tpu_splat_torch.train.step import TrainState

    dev = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    isp = None if d.get("isp") is None else ISPParams(
        **{k: f32(d["isp"][k]) for k in ISPParams._fields})
    return TrainState(
        gaussians=state_from_numpy(d["gaussians"], device=dev),
        opt=AdamState(mu={k: f32(v) for k, v in d["mu"].items()},
                      nu={k: f32(v) for k, v in d["nu"].items()}, count=int(d["count"])),
        stats=DensifyStats(*(f32(d["stats"][k]) for k in _STATS)),
        step=int(d["step"]),
        opacity_lr=float(np.float32(d["opacity_lr"])),
        generator=torch.Generator().manual_seed(int(d.get("seed", 0))),
        isp=isp,
    )


def train_state_to_numpy(ts) -> dict:
    """The reverse of `train_state_from_numpy` (seed excluded: a
    generator's state is not a seed)."""
    host = lambda t: t.detach().cpu().numpy()
    return dict(
        gaussians=state_to_numpy(ts.gaussians),
        mu={k: host(v) for k, v in ts.opt.mu.items()},
        nu={k: host(v) for k, v in ts.opt.nu.items()},
        count=int(ts.opt.count),
        stats={k: host(getattr(ts.stats, k)) for k in _STATS},
        isp=None if ts.isp is None else {k: host(v) for k, v in ts.isp._asdict().items()},
        step=int(ts.step),
        opacity_lr=float(ts.opacity_lr),
    )
