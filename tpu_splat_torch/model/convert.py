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


# ---------------------------------------------------------------------------
# The JAX TrainState's leaf order (checkpoint `leaf_i` arrays)

_GAUSSIAN_LEAVES = _FLOAT_LEAVES + ("env.texture", "env.fail_value", "alive", "active_sh_degree")
_ISP_FIELDS = ("gain", "bias", "log_gamma", "ctrl_gain", "ctrl_bias", "ctrl_log_gamma",
               "vig_coef", "vig_center")
_PARAM_KEYS = _FLOAT_LEAVES + ("env_texture", "env_fail")


def train_state_leaf_names(has_isp: bool) -> list[str]:
    """The leaves of the JAX package's `TrainState` in `jax.tree.flatten`
    order (tpu_splat/train/step.py:TrainState): the GaussianState's fields
    in declaration order (the cubemap's two in its NamedTuple's;
    `max_sh_degree` is static, not a leaf), the AdamState's `mu` and `nu`
    dicts with their keys sorted (the parameters, and the `isp_*` leaves
    when the ISP is on), its count, the DensifyStats, `step`, `opacity_lr`,
    the PRNG `key`, and the ISPParams when present."""
    keys = sorted(_PARAM_KEYS + tuple(f"isp_{f}" for f in _ISP_FIELDS) if has_isp
                  else _PARAM_KEYS)
    names = [f"gaussians.{k}" for k in _GAUSSIAN_LEAVES]
    names += [f"opt.{m}.{k}" for m in ("mu", "nu") for k in keys] + ["opt.count"]
    names += [f"stats.{k}" for k in _STATS] + ["step", "opacity_lr", "key"]
    if has_isp:
        names += [f"isp.{f}" for f in _ISP_FIELDS]
    return names


def prng_key_bits(seed: int) -> np.ndarray:
    """The bits of `jax.random.PRNGKey(seed)` as uint32[2], with JAX's
    default 32-bit integers: threefry2x32 keeps the seed's low word."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def train_state_to_leaves(ts) -> dict:
    """leaf name -> numpy array in the JAX leaves' dtypes (integer scalars
    int32), with `jax.random.PRNGKey(0)` (`TrainState.create`'s default
    seed) in the `key` slot: the port's draws come from its generator."""
    d = train_state_to_numpy(ts)
    g = d["gaussians"]
    out = {f"gaussians.{k}": g[k] for k in _FLOAT_LEAVES}
    out.update({
        "gaussians.env.texture": g["texture"], "gaussians.env.fail_value": g["fail_value"],
        "gaussians.alive": g["alive"],
        "gaussians.active_sh_degree": np.asarray(g["active_sh_degree"], np.int32),
        "opt.count": np.asarray(d["count"], np.int32),
        "step": np.asarray(d["step"], np.int32),
        "opacity_lr": np.asarray(d["opacity_lr"], np.float32),
        "key": prng_key_bits(0),
    })
    for m in ("mu", "nu"):
        out.update({f"opt.{m}.{k}": v for k, v in d[m].items()})
    out.update({f"stats.{k}": v for k, v in d["stats"].items()})
    if d["isp"] is not None:
        out.update({f"isp.{k}": v for k, v in d["isp"].items()})
    names = train_state_leaf_names(d["isp"] is not None)
    if set(names) != set(out):
        raise ValueError(f"train state leaves {sorted(set(out) ^ set(names))} out of place")
    return {k: out[k] for k in names}


def train_state_from_leaves(leaves: dict, max_sh_degree: int, device="cuda"):
    """The reverse of `train_state_to_leaves` (the `key` slot is not read;
    the generator is seeded 0, as `TrainState.create` seeds it)."""
    has_isp = "isp.gain" in leaves
    names = train_state_leaf_names(has_isp)
    if set(names) != set(leaves):
        raise ValueError(f"train state leaves {sorted(set(leaves) ^ set(names))} out of place")
    g = {k: leaves[f"gaussians.{k}"] for k in _FLOAT_LEAVES}
    g.update(texture=leaves["gaussians.env.texture"],
             fail_value=leaves["gaussians.env.fail_value"],
             alive=leaves["gaussians.alive"],
             active_sh_degree=int(leaves["gaussians.active_sh_degree"]),
             max_sh_degree=max_sh_degree)
    pre = lambda p: {k[len(p):]: v for k, v in leaves.items() if k.startswith(p)}
    return train_state_from_numpy(dict(
        gaussians=g, mu=pre("opt.mu."), nu=pre("opt.nu."), count=int(leaves["opt.count"]),
        stats=pre("stats."), isp=pre("isp.") if has_isp else None,
        step=int(leaves["step"]), opacity_lr=leaves["opacity_lr"],
    ), device=device)
