"""The system under test: the port (`tpu_splat_torch`), reached only through
its public entry points. The benchmark hands it the inputs of `scene.py` and
reads back its outputs, spans and counters."""
from __future__ import annotations

import dataclasses

import torch


def state(cloud: dict, capacity: int):
    """A GaussianState of the cloud's leaves, padded with dead rows to
    `capacity` as the port pads (unit quaternions, log-scale and logits at
    -10), every band of SH degree 3 active."""
    from tpu_splat_torch.envmap.cubemap import CubemapParams
    from tpu_splat_torch.model.state import GaussianState

    n = cloud["xyz"].shape[0]
    dev = cloud["xyz"].device

    def pad(k, fill=0.0):
        x = cloud[k]
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill, device=dev)
        out[:n] = x
        return out

    rot = pad("rotation")
    rot[n:, 0] = 1.0
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[:n] = True
    return GaussianState(
        xyz=pad("xyz"), features_dc=pad("features_dc"), features_rest=pad("features_rest"),
        scaling=pad("scaling", -10.0), rotation=rot, opacity=pad("opacity", -10.0),
        refl=pad("refl", -10.0),
        env=CubemapParams(texture=cloud["env_texture"].clone(),
                          fail_value=cloud["env_fail"].clone()),
        alive=alive, active_sh_degree=3, max_sh_degree=3)


def camera(view, height, width, device):
    from tpu_splat_torch.core.graphics import Camera

    R, T, fovx, fovy = view
    return Camera.create(R=R, T=T, fovx=fovx, fovy=fovy, height=height, width=width,
                         device=device)


def raster_config(raster: dict, **switches):
    """The training CLI's switch set (`production_config`) at these caps."""
    from tpu_splat_torch.raster.config import production_config

    return production_config(**raster, **switches)


def view_config(caps: dict):
    from tpu_splat_torch.raster.config import RasterConfig

    return RasterConfig(**caps)


def probe_instances(st, cam, cfg) -> tuple[int, int]:
    """(instances, pads past the pad budget) the port's binning emits for
    this view with a capacity that drops nothing (the bench's probe)."""
    from tpu_splat_torch.raster.binning import bin_gaussians
    from tpu_splat_torch.raster.preprocess import preprocess

    probe = dataclasses.replace(cfg, max_instances=PROBE_MAX_INSTANCES)
    with torch.no_grad():
        p = preprocess(st.xyz, st.get_scaling(), st.rotation, cam.world_view, cam.full_proj,
                       cam.camera_center, cam.height, cam.width,
                       colors=torch.zeros((st.capacity, 3), device=st.device),
                       opacity=st.get_opacity() if cfg.opacity_rect else None)
        valid = p.valid & st.alive
        p = p._replace(valid=valid, tiles_touched=torch.where(
            valid, p.tiles_touched, torch.zeros_like(p.tiles_touched)))
        b = bin_gaussians(p, cam.height, cam.width, probe, aligned=True)
        return int(b.num_instances), int(b.pad_overflow)


# the bench's probe (tpu_splat_torch/scripts/bench.py:probe_capacity): bin at
# this capacity, then cover the count with 3% headroom in 4096-slot steps
PROBE_MAX_INSTANCES = 8_368_128
PROBE_HEADROOM = 1.03
PROBE_ALIGN = 4096


def covering_capacity(n_instances: int) -> int:
    cap = -(-int(n_instances * PROBE_HEADROOM) // PROBE_ALIGN) * PROBE_ALIGN
    if n_instances > min(cap, PROBE_MAX_INSTANCES):
        raise RuntimeError(f"{n_instances} instances exceed the probe's capacity "
                           f"{PROBE_MAX_INSTANCES}")
    return min(cap, PROBE_MAX_INSTANCES)


def leaves(st, isp=None) -> dict:
    """The optimizable leaves, named as the reference names them."""
    p = dict(st.param_pytree())
    if isp is not None:
        for k in ("gain", "bias", "log_gamma", "ctrl_gain", "ctrl_bias", "ctrl_log_gamma",
                  "vig_coef", "vig_center"):
            p[f"isp_{k}"] = getattr(isp, k)
    return p


def first_gradients(ts) -> dict:
    """The first step's gradient as Adam holds it after that step: its first
    moment over (1 - beta1), from zero moments."""
    from tpu_splat_torch.model.optim import B1

    return {k: v / (1 - B1) for k, v in ts.opt.mu.items()}


def free_cached():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
