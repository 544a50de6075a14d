"""Deferred-reflection rendering (port of tpu_splat/renderer/render.py).

render() (training, differentiable) and render_fast() (serving): rasterize
the base colour and auxiliary maps, then reflect the camera rays about the
rendered world normal, sample the learned cubemap and composite
`(1-refl)*base + refl*env` (reference gaussian_renderer/__init__.py).
render() also derives the expected depth and the depth-derived pseudo
surface normal. Maps are channels-last [H, W, C]. Given a `Mesh`, every
rank of it renders the whole frame: the rasterizer splits the tile grid
over the ranks and the reflection's env pass their pixel rows.

The state picks the rasterizer family: two scale columns are 2DGS surfels,
three are volumetric 3DGS Gaussians (3DGS-DR), whose normal is their
shortest axis turned toward the camera (`shortest_axis_normals`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_splat_torch.core.graphics import (
    Camera,
    camera_rays,
    env_rays_latlong1,
    env_rays_latlong2,
    reflect,
)
from tpu_splat_torch.core.device import stage
from tpu_splat_torch.core.transforms import quat_to_rotmat
from tpu_splat_torch.dist.collectives import axis_size, gather_rows, replicated, shard_rows
from tpu_splat_torch.envmap.cubemap import CubemapParams, sample_cubemap
from tpu_splat_torch.model.state import GaussianState
from tpu_splat_torch.raster import rasterize, RasterConfig


class RenderOutput(NamedTuple):
    render: torch.Tensor  # [H,W,3] final image
    base_color: torch.Tensor  # [H,W,3]
    refl_color: torch.Tensor  # [H,W,3] env sample (zeros in initial stage)
    refl_strength: torch.Tensor  # [H,W,1]
    alpha: torch.Tensor  # [H,W,1]
    normal: torch.Tensor  # [H,W,3] world-space, normalized
    dist: torch.Tensor  # [H,W,1] distortion map (zeros in render_fast)
    surf_depth: torch.Tensor  # [H,W,1] (zeros in render_fast)
    surf_normal: torch.Tensor  # [H,W,3] (zeros in render_fast)
    scope_mask: torch.Tensor  # [H,W,1] (zeros in render_fast)
    radii: torch.Tensor  # [P]
    gaussian_weights: torch.Tensor  # [P]
    visibility: torch.Tensor  # [P] bool (radii > 0)
    num_instances: torch.Tensor  # overflow diagnostics
    max_area: torch.Tensor
    max_tile_count: torch.Tensor
    pad_overflow: torch.Tensor


def _safe_normalize(v: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize, with zero vectors (empty pixels) staying finite and their
    gradients NaN-free. A maximum, as `jnp.maximum` (1/2 gradient at a tie),
    against a 0-d device fill: a tensor copied from the host would
    synchronize the stream."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v / (torch.sqrt(torch.maximum(n2, n2.new_full((), eps * eps))) + eps)


def depth_to_normal(camera: Camera, depth: torch.Tensor) -> torch.Tensor:
    """Pseudo surface normal from a depth map via cross products of
    image-space point derivatives (reference utils/point_utils.py:9-37).
    depth [H, W] -> [H, W, 3] world-space, with a zero border."""
    H, W = camera.height, camera.width
    dev = depth.device
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pix = torch.stack([i, j, torch.ones_like(i)], dim=-1)
    Kinv = torch.linalg.inv(camera.K)
    dirs_cam = torch.einsum("hwj,kj->hwk", pix, Kinv)  # z = 1
    R_c2w = camera.world_view[:3, :3].T
    dirs_world = torch.einsum("hwj,kj->hwk", dirs_cam, R_c2w)
    points = depth[..., None] * dirs_world + camera.camera_center
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = _safe_normalize(torch.linalg.cross(dx, dy, dim=-1), eps=1e-12)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def shortest_axis_normals(xyz: torch.Tensor, scales: torch.Tensor, rotation: torch.Tensor,
                          camera_center: torch.Tensor) -> torch.Tensor:
    """3DGS-DR's per-Gaussian normal: with R = quat_to_rotmat(rotation) and
    k = argmin over the three scales, column k of R, negated where
    dot(R[:, :, k], camera_center - xyz) < 0. The gradient reaches
    `rotation` through the chosen column; the choice of k and the sign
    carry none. [P,3] each -> [P,3] world normals."""
    R = quat_to_rotmat(rotation)
    with torch.no_grad():
        k = torch.argmin(scales, dim=-1)
    n = torch.gather(R, 2, k[:, None, None].expand(-1, 3, 1))[:, :, 0]
    with torch.no_grad():
        away = torch.sum(n * (camera_center - xyz), dim=-1) < 0
        sign = torch.where(away, -1.0, 1.0).to(n.dtype)
    return n * sign[:, None]


def _family(state: GaussianState, scales: torch.Tensor, camera: Camera) -> dict:
    """rasterize's mode and normals for the state's family."""
    if not state.volumetric:
        return dict(mode="surfel")
    with stage("normal_axis"):
        normals = shortest_axis_normals(state.xyz, scales, state.rotation, camera.camera_center)
    return dict(mode="volumetric", normals=normals)


def get_refl_color(env, camera: Camera, normal_map: torch.Tensor, mesh=None,
                   mesh_axis: str = "tiles") -> torch.Tensor:
    """Reflect the camera rays about the rendered world normal and sample the
    env cubemap through a sigmoid (reference gaussian_renderer:26-35).

    With a mesh, the cubemap pass (the 4-tap sample and, in the backward,
    the tap accumulation) runs on each rank's block of pixel rows (padded
    to a multiple of the mesh size) against the replicated texture, whose
    gradient partials are summed; the rows are gathered into the whole map
    on every rank. The reflection itself runs on the whole map, so the
    normal map's gradient sums its terms in the unsharded order."""
    dirs = reflect(camera_rays(camera), normal_map)  # [H,W,3]
    if mesh is None:
        return torch.sigmoid(sample_cubemap(env, dirs))
    H = dirs.shape[0]
    pad = (-H) % axis_size(mesh, mesh_axis)
    if pad:
        dirs = torch.cat([dirs, dirs.new_zeros((pad,) + dirs.shape[1:])])
    env_r = CubemapParams(*replicated(mesh, env.texture, env.fail_value))
    local = sample_cubemap(env_r, shard_rows(mesh, dirs))
    return gather_rows(mesh, torch.sigmoid(local))[:H]


def render_env_map(state: GaussianState, H: int = 512, W: int = 1024):
    """Two lat-long preview images of the env map (reference :37-40)."""
    dev = state.device
    e1 = torch.sigmoid(sample_cubemap(state.env, env_rays_latlong1(H, W, device=dev)))
    e2 = torch.sigmoid(sample_cubemap(state.env, env_rays_latlong2(H, W, device=dev)))
    return {"env_cood1": e1, "env_cood2": e2}


def render(
    state: GaussianState,
    camera: Camera,
    cfg: RasterConfig,
    bg: torch.Tensor,
    scaling_modifier: float = 1.0,
    initial_stage: bool = False,
    env_scope_center=None,
    env_scope_radius: float = 0.0,
    override_color: torch.Tensor | None = None,
    screen_offset: torch.Tensor | None = None,
    mesh=None,
    mesh_axis: str = "tiles",
) -> RenderOutput:
    """Differentiable training render (reference render(), :42-219): the
    rasterized base colour and auxiliary maps, the expected depth and the
    pseudo surface normal derived from it, then -- past the initial stage --
    the deferred reflection `(1-refl)*base + refl*env`.

    `initial_stage` is a Python bool. In the initial stage the env pass is
    not run: the JAX package selects the base colour there, so the env map
    and the reflection strength get zero gradients either way."""
    H, W = camera.height, camera.width
    dev = state.device
    if env_scope_radius > 0.0:
        c = torch.as_tensor(env_scope_center, dtype=torch.float32, device=dev)
        scope = torch.sum((state.xyz - c[None]) ** 2, dim=-1) < env_scope_radius**2
    else:
        scope = torch.ones((state.capacity,), dtype=torch.bool, device=dev)

    scales = state.get_scaling()
    out = rasterize(
        state.xyz,
        scales,
        state.rotation,
        state.get_opacity(),
        state.get_refl(),
        camera,
        bg,
        cfg,
        sh=None if override_color is not None else state.get_features(),
        sh_degree=state.max_sh_degree,
        colors=override_color,
        scope_mask=scope,
        scale_modifier=scaling_modifier,
        screen_offset=screen_offset,
        alive=state.alive,
        mesh=mesh,
        mesh_axis=mesh_axis,
        **_family(state, scales, camera),
    )
    with stage("surface"):
        allmap = out.others
        alpha = allmap[..., 1:2]
        R_v2w = camera.world_view[:3, :3].T
        normal_world = torch.einsum("hwj,kj->hwk", allmap[..., 2:5], R_v2w)
        depth_median = torch.nan_to_num(allmap[..., 5:6], nan=0.0)
        # a maximum, as `jnp.clip` (1/2 gradient at a tie)
        depth_expected = allmap[..., 0:1] / torch.maximum(alpha, alpha.new_full((), 1e-3))
        depth_expected = torch.nan_to_num(depth_expected, nan=0.0)
        surf_depth = depth_expected * (1 - cfg.depth_ratio) + cfg.depth_ratio * depth_median
        surf_normal = depth_to_normal(camera, surf_depth[..., 0]) * alpha.detach()
        normal_world = _safe_normalize(normal_world)

    refl_map = out.refl_map[..., None]
    if initial_stage:
        render_img = out.color
        refl_color = torch.zeros_like(out.color)
    else:
        with stage("reflection"):
            refl_color = get_refl_color(state.env, camera, normal_world, mesh=mesh,
                                        mesh_axis=mesh_axis)
            render_img = (1.0 - refl_map) * out.color + refl_map * refl_color
    return RenderOutput(
        render=render_img,
        base_color=out.color,
        refl_color=refl_color,
        refl_strength=refl_map,
        alpha=alpha,
        normal=normal_world,
        dist=allmap[..., 6:7],
        surf_depth=surf_depth,
        surf_normal=surf_normal,
        scope_mask=allmap[..., 7:8],
        radii=out.radii,
        gaussian_weights=out.gaussian_weights,
        visibility=out.radii > 0,
        num_instances=out.num_instances,
        max_area=out.max_area,
        max_tile_count=torch.max(out.tile_counts),
        pad_overflow=out.pad_overflow,
    )


@torch.no_grad()
def render_fast(
    state: GaussianState,
    camera: Camera,
    cfg: RasterConfig,
    bg: torch.Tensor,
    scaling_modifier: float = 1.0,
    initial_stage: bool = False,
    collect_weights: bool = True,
) -> RenderOutput:
    """Inference render: no surf-depth / surf-normal post-processing and no
    env scoping. collect_weights=False also drops the per-Gaussian max blend
    weight (a densify-only stat); gaussian_weights is then zeros. Runs on
    the device the state lives on."""
    scales = state.get_scaling()
    out = rasterize(
        state.xyz,
        scales,
        state.rotation,
        state.get_opacity(),
        state.get_refl(),
        camera,
        bg,
        cfg,
        sh=state.get_features(),
        sh_degree=state.max_sh_degree,
        scale_modifier=scaling_modifier,
        alive=state.alive,
        collect_weights=collect_weights,
        **_family(state, scales, camera),
    )
    alpha = out.others[..., 1:2]
    normal_view = out.others[..., 2:5]
    refl_map = out.refl_map[..., None]
    with stage("reflection"):
        R_v2w = camera.world_view[:3, :3].T
        normal_world = _safe_normalize(torch.einsum("hwj,kj->hwk", normal_view, R_v2w))
        if initial_stage:
            render_img = out.color
            refl_color = torch.zeros_like(out.color)
        else:
            refl_color = get_refl_color(state.env, camera, normal_world)
            render_img = (1.0 - refl_map) * out.color + refl_map * refl_color
    z = torch.zeros_like
    return RenderOutput(
        render=render_img,
        base_color=out.color,
        refl_color=refl_color,
        refl_strength=refl_map,
        alpha=alpha,
        normal=normal_world,
        dist=z(alpha),
        surf_depth=z(alpha),
        surf_normal=z(normal_world),
        scope_mask=z(alpha),
        radii=out.radii,
        gaussian_weights=out.gaussian_weights,
        visibility=out.radii > 0,
        num_instances=out.num_instances,
        max_area=out.max_area,
        max_tile_count=torch.max(out.tile_counts),
        pad_overflow=out.pad_overflow,
    )
