"""Per-group Adam with per-step learning rates, as plain functions on
explicit moment dicts (port of tpu_splat/model/optim.py).

The moments mirror the parameter dict, so densification can rewrite their
rows with the same masked ops as the parameters (`remap_rows`); there is no
optimizer object to patch. Semantics of the reference's torch Adam and of
the JAX package: betas (0.9, 0.999), eps = 1e-15 added outside the sqrt,
bias correction by one global step count, all in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_splat_torch.core.transforms import expon_lr_schedule

B1, B2 = 0.9, 0.999
EPS = 1e-15

# param dict key -> lr group name (reference training_setup group names)
PARAM_GROUP = {
    "xyz": "xyz",
    "features_dc": "f_dc",
    "features_rest": "f_rest",
    "opacity": "opacity",
    "scaling": "scaling",
    "rotation": "rotation",
    "refl": "refl",
    "env_texture": "env",
    "env_fail": "env",
}


def param_group(key: str) -> str:
    if key.startswith("isp_"):
        return "isp"
    return PARAM_GROUP[key]


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: int


def adam_init(params: dict) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
    )


@torch.no_grad()
def adam_step(params: dict, grads: dict, state: AdamState, lrs: dict) -> tuple[dict, AdamState]:
    """lrs: group name -> float learning rate. Returns new parameter and
    moment tensors (the inputs are not modified)."""
    count = state.count + 1
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(B1, dtype=torch.float32) ** c)
    bc2 = float(1.0 - torch.tensor(B2, dtype=torch.float32) ** c)
    new_params, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu = B1 * state.mu[k] + (1 - B1) * g
        nu = B2 * state.nu[k] + (1 - B2) * (g * g)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        new_params[k] = p - lrs[param_group(k)] * update
        new_mu[k] = mu
        new_nu[k] = nu
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)


def default_lrs(opt, spatial_lr_scale: float) -> dict:
    """Base learning rates (reference training_setup, gaussian_model.py:195-207)."""
    return {
        "xyz": opt.position_lr_init * spatial_lr_scale,
        "f_dc": opt.feature_lr,
        "f_rest": opt.feature_lr / 20.0,
        "opacity": opt.opacity_lr,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
        "refl": opt.refl_lr,
        "env": opt.envmap_cubemap_lr,
        "isp": 1e-3,  # learned ISP group (PPISP role)
    }


def xyz_lr_schedule(opt, spatial_lr_scale: float):
    """The exponential-decay position schedule (reference :208-211)."""
    return expon_lr_schedule(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )


def reset_moments(state: AdamState, key: str) -> AdamState:
    """Zero the Adam moments of one parameter (reference
    replace_tensor_to_optimizer, used by the opacity/refl resets)."""
    mu, nu = dict(state.mu), dict(state.nu)
    mu[key] = torch.zeros_like(mu[key])
    nu[key] = torch.zeros_like(nu[key])
    return state._replace(mu=mu, nu=nu)


def remap_rows(state: AdamState, keys: list[str], src_idx: torch.Tensor,
               keep: torch.Tensor) -> AdamState:
    """Row-remap Adam moments during densification: moments follow their
    rows; newly created rows (keep=False) get zero moments."""
    def remap(a):
        shape = (-1,) + (1,) * (a.dim() - 1)
        return a[src_idx.long()] * keep.reshape(shape).to(a.dtype)

    mu, nu = dict(state.mu), dict(state.nu)
    for k in keys:
        mu[k] = remap(mu[k])
        nu[k] = remap(nu[k])
    return state._replace(mu=mu, nu=nu)
