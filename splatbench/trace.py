"""What a traced run reads: the program's stage spans, the benchmark's own
host spans, host syncs, and the device's busy time from `torch.profiler`.
A `Trace` holds the readings of one traced window; each per-layer metric
(`metrics/<name>.py`) reads its number from it."""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings

import torch


@dataclasses.dataclass
class Trace:
    steps: int = 0  # steps or frames in each of the two traced windows
    stage_window_s: float = 0.0  # the spans' window, host clock, synchronised at both ends
    window_s: float = 0.0  # the profiled window, likewise
    busy_s: float | None = None  # union of device operations in the profiled window
    spans_ms: dict = dataclasses.field(default_factory=dict)  # program stage spans, summed
    host_ms: dict = dataclasses.field(default_factory=dict)  # the benchmark's host spans
    syncs: int | None = None
    counts: dict = dataclasses.field(default_factory=dict)  # counts/: ops and bytes, summed
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)


class HostSpans:
    """Host-clock spans of the benchmark's own code, summed by name."""

    def __init__(self, on: bool):
        self.on, self.ms = on, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"splatbench.{name}"):
            yield
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def count_syncs(out: dict):
    """Count the host syncs of the CUDA stream inside: the warnings of
    `torch.cuda.set_sync_debug_mode("warn")`, one per synchronising call."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["syncs"] = sum(1 for w in seen if "synchroniz" in str(w.message))


def _union(intervals):
    total, end, gaps = 0.0, None, []
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def read_profile(prof, window_name: str = "splatbench.window") -> dict:
    """Device busy seconds (union of the device operations inside the
    window's range), the ten device operations that took most time, and the
    ten longest idle gaps labelled by the host operation that was running
    when the device went idle (the CUDA runtime call in flight, with the
    benchmark's span around it where the profiler recorded one)."""
    evs = prof.events()
    win = sorted((e for e in evs if e.name == window_name),
                 key=lambda e: e.time_range.end - e.time_range.start, reverse=True)
    # the profiler runs over the window alone: without its mark, every event
    w0, w1 = ((win[0].time_range.start, win[0].time_range.end) if win
              else (float("-inf"), float("inf")))
    dev, host = [], []
    for e in evs:
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith("splatbench."):
            # the benchmark's own ranges label the gaps; they are no work
            if e.name != window_name:
                host.append((s, t, e.name))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and t > w0 and s < w1:
                dev.append((max(s, w0), min(t, w1), e.name))
        elif w0 <= s <= w1:
            host.append((s, t, e.name))
    if not dev:
        return {}
    busy_us, gaps = _union([(s, t) for s, t, _ in dev])
    by_name: dict = {}
    for s, t, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    labelled = []
    for g0, g1 in longest:
        inner = [(s, n) for s, t, n in host if s <= g0 <= t]
        mine = [n for s, n in sorted(inner) if n.startswith("splatbench.")]
        deepest = max(inner)[1] if inner else "host, no CUDA call"
        label = (mine[-1][len("splatbench."):] + "/" if mine else "") + deepest
        labelled.append([label, (g1 - g0) * 1e-6])
    return dict(busy_s=busy_us * 1e-6, device_ops=[[n, s] for n, s in ops],
                idle_gaps=labelled)


def _sync(on_card: bool):
    if on_card:
        torch.cuda.synchronize()


def traced_windows(k: int, body, spans: HostSpans, device) -> Trace:
    """Two windows of k iterations of `body(i)` each: the first under the
    program's stage spans (`record_stages`) and the benchmark's host spans,
    the second under torch.profiler (device activity only: the least host
    overhead) and the host-sync count, so that neither's overhead lands in
    the other's readings. The host spans count in the first window only."""
    from tpu_splat_torch.core.device import record_stages

    on_card = device.type == "cuda"
    spans.on = True
    _sync(on_card)
    t0 = time.perf_counter()
    with record_stages(device) as stage_ms:
        for i in range(k):
            body(i)
        _sync(on_card)
        stage_window = time.perf_counter() - t0
    t = Trace(steps=k, stage_window_s=stage_window, spans_ms=dict(stage_ms),
              host_ms=dict(spans.ms))
    if not on_card:
        spans.on = False
        t.window_s = stage_window
        return t
    sync = {}
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("splatbench.window"):
            _sync(on_card)
            t0 = time.perf_counter()
            with count_syncs(sync):
                for i in range(k, 2 * k):
                    body(i)
            _sync(on_card)
            t.window_s = time.perf_counter() - t0
    spans.on = False
    got = read_profile(prof)
    t.busy_s, t.syncs = got.get("busy_s"), sync.get("syncs")
    t.device_ops, t.idle_gaps = got.get("device_ops", []), got.get("idle_gaps", [])
    return t
