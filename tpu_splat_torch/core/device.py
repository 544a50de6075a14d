"""Device selection, matmul precision and stage timing for the port's entry
points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point builds its tensors on. Asking for CUDA on a
    machine without it raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def full_precision_matmul() -> None:
    """Keep float32 products in full float32 on the card. The geometry
    einsums (homography, view transforms, camera rays) feed the alpha
    termination knife edge; the JAX reference runs them at
    precision='highest'. TF32 would keep only ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_stage_events: list | None = None  # (name, start, end) while recording
_open_stages: dict = {}  # name -> start event of a stage marked by edges


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def stage(name: str):
    """Mark one stage of the forward or of an autograd Function's backward.
    Inside `record_stages()` it records CUDA events around the stage on the
    current stream; otherwise it does nothing."""
    if _stage_events is None:
        yield
        return
    start = _event()
    yield
    _stage_events.append((name, start, _event()))


class _BackwardEdge(torch.autograd.Function):
    """Identity whose backward records the start or end event of a stage."""

    @staticmethod
    def forward(ctx, name, edge, *xs):
        ctx.name, ctx.edge = name, edge
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if _stage_events is not None:
            if ctx.edge == "start":
                _open_stages[ctx.name] = _event()
            elif ctx.name in _open_stages:
                _stage_events.append((ctx.name, _open_stages.pop(ctx.name), _event()))
        return (None, None) + grads


def backward_edge(name: str, edge: str, *xs):
    """Mark a stage of the backward that no single Function holds, such as
    the autograd of a whole module: pass the module's differentiable outputs
    through `backward_edge(name, "start", ...)` and its inputs through
    `backward_edge(name, "end", ...)`. The stage then spans from the moment
    all output gradients are ready to the moment all input gradients are.
    Identity (and no graph node) unless `record_stages()` is on."""
    if _stage_events is None or not torch.is_grad_enabled():
        return xs
    live = [i for i, x in enumerate(xs) if isinstance(x, torch.Tensor) and x.requires_grad]
    if not live:
        return xs
    out = list(xs)
    for i, y in zip(live, _BackwardEdge.apply(name, edge, *(xs[i] for i in live))):
        out[i] = y
    return tuple(out)


@contextlib.contextmanager
def record_stages():
    """Time the stages run inside on the card: yields a dict that is filled
    on exit with each stage's milliseconds between its events, summed over
    repeats of the same name."""
    global _stage_events
    _stage_events, times = [], {}
    _open_stages.clear()
    try:
        yield times
    finally:
        events, _stage_events = _stage_events, None
    torch.cuda.synchronize()
    for name, start, end in events:
        times[name] = times.get(name, 0.0) + start.elapsed_time(end)
