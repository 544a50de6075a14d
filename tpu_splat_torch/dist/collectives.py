"""Collectives over a `Mesh` that autograd can pass through.

The JAX package gets these from `shard_map`'s transpose. In the port each
rank holds the replicated values (the Gaussians, the full image after the
gather) in full and runs the replicated work itself, so the gradient rules
are written out here:

- `replicated(*xs)`: a replicated value entering per-rank work. Identity
  forward; backward sums the ranks' partial gradients (one all-reduce for
  all of them), so the replicated value upstream gets its whole gradient
  on every rank (shard_map's psum of an unsharded input's cotangent).
- `gather_rows(x)`: per-rank rows (dim 0) joined into the replicated whole.
  Forward all-gathers; backward hands each rank its own rows of the
  (replicated) cotangent, with no communication.
- `shard_rows(x)`: a rank's rows of a replicated value. Forward slices;
  backward all-gathers the ranks' row gradients into the replicated whole.

Replicated work after a gather thus counts once: its gradient is the same
on every rank and is never summed. Every collective is handed the mesh's
group, never the default one; a mesh without a group (one rank, no
`torch.distributed`) makes each of them the identity. A mean is a sum
divided by the mesh size, as `jax.lax.pmean` (gloo has no average).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_splat_torch.core.device import stage


def axis_size(mesh, axis: str) -> int:
    """The mesh's size along `axis` (`jax.sharding.Mesh.shape[axis]`); a
    1-D mesh has one axis, and another name raises."""
    if mesh.axis != axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    return mesh.size


def _flat(xs):
    return torch.cat([x.reshape(-1) for x in xs])


def _unflat(buf, likes):
    out, k = [], 0
    for x in likes:
        out.append(buf[k:k + x.numel()].view_as(x))
        k += x.numel()
    return out


def _all_reduce_(mesh, op, xs) -> None:
    if mesh.group is None or not xs:
        return
    by_dtype: dict = {}
    for x in xs:
        by_dtype.setdefault(x.dtype, []).append(x)
    for group in by_dtype.values():
        buf = _flat(group)
        dist.all_reduce(buf, op=op, group=mesh.group)
        for x, y in zip(group, _unflat(buf, group)):
            x.copy_(y)


def all_sum_(mesh, *xs: torch.Tensor) -> None:
    """Sum each tensor across the mesh in place, in one all-reduce per dtype."""
    _all_reduce_(mesh, dist.ReduceOp.SUM, xs)


def all_max_(mesh, *xs: torch.Tensor) -> None:
    """Elementwise max of each tensor across the mesh in place, in one
    all-reduce per dtype."""
    _all_reduce_(mesh, dist.ReduceOp.MAX, xs)


def all_mean(mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The mean of each tensor across the mesh (sum / size), as new tensors,
    through one flat all-reduce per dtype."""
    out = [x.detach().clone() for x in xs]
    all_sum_(mesh, *out)
    return [x / mesh.size for x in out] if mesh.size > 1 else out


def _all_gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bool:  # gathered as bytes
        return _all_gather_rows(mesh, x.to(torch.uint8)).bool()
    with stage("all_gather"):
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # gradients are materialised (zeros where an output went unused), so
        # every rank reduces the same buffer
        with stage("grad_allreduce"):
            gs = [g.contiguous().clone() for g in gs]
            all_sum_(ctx.mesh, *gs)
        return (None, *gs)


def replicated(mesh, *xs: torch.Tensor):
    """Identity; the backward sums each input's gradient across the mesh
    (one all-reduce). Returns a tuple."""
    if mesh.group is None:
        return xs
    return _Replicated.apply(mesh, *xs)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return _all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.rank, ctx.n
        return None, g[r * n:(r + 1) * n]


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """[n, ...] rows of each rank -> [size * n, ...] in rank order, on every
    rank; the backward gives each rank its own rows of the cotangent."""
    if mesh.group is None:
        return x
    return _GatherRows.apply(mesh, x)


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        n = x.shape[0] // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return None, _all_gather_rows(ctx.mesh, g)


def shard_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a replicated [size * n, ...] tensor; the
    backward all-gathers the ranks' row gradients."""
    if mesh.group is None:
        return x
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} ranks")
    return _ShardRows.apply(mesh, x)
