"""Device selection, matmul precision and stage timing for the port's entry
points."""
from __future__ import annotations

import contextlib
import subprocess
import time

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


def device_names(dev: torch.device) -> tuple[str, str]:
    """-> (backend, device) for an artifact: "gpu" and the card's
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` line, or
    "cpu" twice."""
    if dev.type != "cuda":
        return "cpu", "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    return "gpu", out.stdout.strip().splitlines()[0]


def full_precision_matmul() -> None:
    """Keep float32 products in full float32 on the card. The geometry
    einsums (homography, view transforms, camera rays) feed the alpha
    termination knife edge; the JAX reference runs them at
    precision='highest'. TF32 would keep only ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_stage_events: list | None = None  # (name, start, end) while recording
_open_stages: dict = {}  # name -> start event of a stage marked by edges
_host_clock = False  # stages recorded on the host clock (record_stages("cpu"))


class _HostEvent:
    """The host clock's stand-in for a CUDA event, for timings of a CPU run."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


def _event(host: bool):
    if host:
        return _HostEvent()
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
    start = _event(_host_clock)
    yield
    _stage_events.append((name, start, _event(_host_clock)))


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
                _open_stages[ctx.name] = _event(_host_clock)
            elif ctx.name in _open_stages:
                _stage_events.append((ctx.name, _open_stages.pop(ctx.name),
                                      _event(_host_clock)))
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
def record_stages(device: str | torch.device = "cuda"):
    """Time the stages run inside: yields a dict that is filled on exit with
    each stage's milliseconds between its events, summed over repeats of the
    same name. On the card the events are CUDA events on the current
    stream; for device "cpu" they are host-clock readings."""
    global _stage_events, _host_clock
    _stage_events, times = [], {}
    _host_clock = torch.device(device).type == "cpu"
    _open_stages.clear()
    try:
        yield times
    finally:
        events, _stage_events = _stage_events, None
    if not _host_clock:
        torch.cuda.synchronize()
    for name, start, end in events:
        times[name] = times.get(name, 0.0) + start.elapsed_time(end)


def timed_ms(fn, device: str | torch.device, iters: int = 1) -> float:
    """Milliseconds a call of `fn` takes: `iters` calls in a row between one
    pair of events, CUDA events on the current stream on the card,
    host-clock readings for device "cpu". The caller warms `fn` up."""
    host = torch.device(device).type == "cpu"
    start = _event(host)
    for _ in range(iters):
        fn()
    end = _event(host)
    if not host:
        end.synchronize()
    return start.elapsed_time(end) / iters
