"""The rank mesh and multi-process start (port of tpu_splat/dist/mesh.py).

The JAX package shards over a `jax.sharding.Mesh` of local devices inside
one program. The port runs one process per rank over `torch.distributed`:
one rank to one card over NCCL on the GPU, one rank to one process over
gloo on the CPU. A `Mesh` is the rank's view of that: its axis name, its
size, its rank, and the process group every collective of the port is
handed explicitly (`dist/collectives.py`). A rank's tensors carry its
device, so the mesh does not.

`launch` starts N local ranks (`torch.multiprocessing`, start method
"spawn") and runs one function in each; their rendezvous goes through a
`FileStore` in a temporary directory, so concurrent launches on one host
never contend for a port.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh. `group` is None only for a one-rank
    mesh built without `torch.distributed`, whose collectives are the
    identity."""

    axis: str
    size: int
    rank: int
    group: Any


def device_count() -> int:
    """Ranks a mesh can hold: the process group's world size once
    `torch.distributed` is initialised, else the local CUDA cards (1 without
    a card)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1)


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh | None:
    """1-D mesh over all ranks, or the first n of them (as the JAX package
    takes the first n devices; at most the ranks there are). Every rank of
    the process group calls it; a rank outside the first n gets None.
    Without `torch.distributed`, a one-rank mesh whose collectives are the
    identity."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh({n_devices}): torch.distributed is not initialised; start the "
                "ranks with tpu_splat_torch.dist.launch or torchrun, or call multihost_init"
            )
        return Mesh(axis=axis, size=1, rank=0, group=None)
    world = dist.get_world_size()
    n = world if n_devices is None else min(int(n_devices), world)
    if n < 1:
        raise ValueError(f"make_mesh: n_devices must be positive, got {n_devices}")
    rank = dist.get_rank()
    # new_group is collective over the default group: every rank calls it
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(axis=axis, size=n, rank=rank, group=group)


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def multihost_init(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, backend: str | None = None):
    """Initialise `torch.distributed` for a multi-process run. An explicit
    topology (num_processes > 1) initialises against `coordinator`
    ("host:port") and lets its failure raise: a bad coordinator is a
    misconfiguration, not a single-host fallback. Without one it joins
    torchrun's group when torchrun's environment is set, and is otherwise a
    no-op. Returns (process_index, process_count)."""
    backend = backend or _default_backend()
    if num_processes is not None and num_processes > 1:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id,
        )
        return dist.get_rank(), dist.get_world_size()
    if not dist.is_initialized() and "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_camera_indices(n_cameras: int, process_index: int, process_count: int) -> np.ndarray:
    """Per-host camera partition for multi-host data-parallel training: host
    p owns cameras p, p+P, p+2P, ... (strided, so every host's subset spans
    the capture trajectory). Disjoint, exhaustive, balanced within one
    camera."""
    if not (0 <= process_index < process_count):
        raise ValueError(f"process {process_index} outside [0, {process_count})")
    return np.arange(process_index, n_cameras, process_count)


def host_epoch_permutation(n_cameras: int, epoch: int, process_index: int,
                           process_count: int) -> np.ndarray:
    """Per-epoch camera order for one host: every host draws the same global
    permutation from seed `epoch` and takes its strided slice, so the hosts
    together cover every camera once per epoch without communicating."""
    perm = np.random.default_rng(epoch).permutation(n_cameras)
    return perm[host_camera_indices(n_cameras, process_index, process_count)]


def _rank_main(rank: int, fn, n_ranks: int, args: tuple, backend: str, tmp: str,
               threads: int) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if threads:
        torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(tmp, "store"), n_ranks)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n_ranks)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"result{rank}.pt"))


def launch(fn, n_ranks: int, args: tuple = (), backend: str | None = None) -> list:
    """Run `fn(rank, *args)` in `n_ranks` new local processes (start method
    "spawn") joined in one process group, and return their results by rank.
    `fn` is a module-level function (it is pickled by import path); its
    result goes back through `torch.save`. On CUDA, rank r takes card
    r mod the card count. `backend` defaults to NCCL with CUDA, else gloo.
    Without CUDA the ranks share the CPU cores. A rank that raises makes
    `launch` raise."""
    import torch.multiprocessing as mp

    backend = backend or _default_backend()
    threads = 0 if torch.cuda.is_available() else max(1, (os.cpu_count() or 1) // n_ranks)
    with tempfile.TemporaryDirectory(prefix="tpu_splat_torch_launch_") as tmp:
        mp.start_processes(
            _rank_main, args=(fn, n_ranks, tuple(args), backend, tmp, threads),
            nprocs=n_ranks, join=True, start_method="spawn",
        )
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(n_ranks)]
