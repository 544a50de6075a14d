"""Scheduled parameter mutations for reflection training (port of
tpu_splat/model/ops.py; role of the reference GaussianModel ops,
scene/gaussian_model.py:213-294,374-393): opacity and refl resets, colour
sabotage, scale enlargement, env-map doubling and sharpening. Each returns a
new state and, where the reference resets Adam moments through
replace_tensor_to_optimizer, the matching moment reset. Random draws come
in as tensors (see train/loop.py), so both packages can be fed the same
noise.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_splat_torch.core import f32
from tpu_splat_torch.core.transforms import inverse_sigmoid
from tpu_splat_torch.envmap.cubemap import resize_cubemap, sharpen_cubemap
from tpu_splat_torch.model.optim import AdamState, reset_moments
from tpu_splat_torch.model.state import GaussianState


def _masked(new, old, exclusive_msk):
    """`new` except where exclusive_msk [P] holds, which keeps `old`."""
    if exclusive_msk is None:
        return new
    m = exclusive_msk.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, old, new)


@torch.no_grad()
def reset_refl(state: GaussianState, opt_state: AdamState, init_refl_value: float,
               exclusive_msk=None):
    """Floor refl at its init value (reference reset_refl :264-269)."""
    new = inverse_sigmoid(torch.clamp(f32.sigmoid(state.refl), min=init_refl_value))
    new = _masked(new, state.refl, exclusive_msk)
    return dataclasses.replace(state, refl=new), reset_moments(opt_state, "refl")


@torch.no_grad()
def reset_opacity(state: GaussianState, opt_state: AdamState, reset_value: float = 0.01,
                  exclusive_msk=None):
    """Cap opacity at reset_value (reference reset_opacity :271-276)."""
    act = torch.clamp(f32.sigmoid(state.opacity), max=reset_value)
    new = inverse_sigmoid(torch.clamp(act, 1e-7, 1 - 1e-7))
    new = _masked(new, state.opacity, exclusive_msk)
    return dataclasses.replace(state, opacity=new), reset_moments(opt_state, "opacity")


def raise_opacity(state: GaussianState, opt_state: AdamState, raise_value: float,
                  exclusive_msk=None):
    """The normal-propagation event's reset_opacity(reset_value=0.9), which
    lowers anything above; the trainer excludes already-opaque points with
    the exclusive mask (train.py:263-278)."""
    return reset_opacity(state, opt_state, raise_value, exclusive_msk)


@torch.no_grad()
def dist_color(state: GaussianState, opt_state: AdamState, noise: torch.Tensor,
               exclusive_msk=None):
    """Colour sabotage: `noise` (U(-0.4, 0.4) draws shaped like
    features_dc) added to the DC colour (reference dist_color :278-284)."""
    new = _masked(state.features_dc + noise, state.features_dc, exclusive_msk)
    return dataclasses.replace(state, features_dc=new), reset_moments(opt_state, "features_dc")


@torch.no_grad()
def reset_scale(state: GaussianState, opt_state: AdamState, enlarge_scale: float = 1.5,
                exclusive_msk=None):
    """Enlarge all but the smallest axis, the first of equal ones
    (reference reset_scale :286-294)."""
    scales = f32.exp(state.scaling)
    min_axis = torch.argmin(scales, dim=-1)
    factor = torch.full_like(scales, enlarge_scale)
    factor[torch.arange(scales.shape[0], device=scales.device), min_axis] = 1.0
    new = _masked(f32.log(scales * factor), state.scaling, exclusive_msk)
    return dataclasses.replace(state, scaling=new), reset_moments(opt_state, "scaling")


def _fresh_env_moments(opt_state: AdamState, env, keys) -> AdamState:
    mu, nu = dict(opt_state.mu), dict(opt_state.nu)
    for k, x in zip(("env_texture", "env_fail"), (env.texture, env.fail_value)):
        if k in keys:
            mu[k], nu[k] = torch.zeros_like(x), torch.zeros_like(x)
    return opt_state._replace(mu=mu, nu=nu)


@torch.no_grad()
def double_env_map(state: GaussianState, opt_state: AdamState):
    """Twice the cubemap resolution by bicubic upsampling, with the env Adam
    moments reset (reference double_env_map :375-379 + replace_env_map
    :384-393). The texture's shape changes; PyTorch needs no recompile."""
    env = resize_cubemap(state.env, state.env.resolution * 2)
    return (dataclasses.replace(state, env=env),
            _fresh_env_moments(opt_state, env, ("env_texture", "env_fail")))


@torch.no_grad()
def filter_env_map(state: GaussianState, opt_state: AdamState):
    """Sharpen the env map (reference filter_env_map :380-382)."""
    env = sharpen_cubemap(state.env)
    return dataclasses.replace(state, env=env), _fresh_env_moments(opt_state, env, ("env_texture",))
