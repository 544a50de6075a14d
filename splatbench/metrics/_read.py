"""Shared arithmetic of the per-layer readers: each metric file holds one
`read(trace)` that returns its number, or None where the trace has nothing
for it."""
from __future__ import annotations

from splatbench.counts import PEAK_F32_PER_S, bound_s


def span_ms(t, *names):
    """The program's stage spans of `names`, summed, per step of the window;
    None where none of them ran."""
    got = [t.spans_ms[n] for n in names if n in t.spans_ms]
    return sum(got) / t.steps if got and t.steps else None


def host_ms(t, name):
    return t.host_ms[name] / t.steps if name in t.host_ms and t.steps else None


def roofline(t, ops_key, bytes_key, span):
    """Percent of the roofline: the least time the window's work could take
    on the card over the time its span took."""
    ms = t.spans_ms.get(span)
    if not ms or ops_key not in t.counts:
        return None
    return 100.0 * bound_s(t.counts[ops_key], t.counts[bytes_key]) / (ms * 1e-3)


def mfu(t, key):
    """Percent of the card's float32 peak: the counted operations of the
    spans' window over its seconds."""
    if key not in t.counts or not t.stage_window_s:
        return None
    return 100.0 * t.counts[key] / (t.stage_window_s * PEAK_F32_PER_S)


def idle_share(t):
    if t.busy_s is None or not t.window_s:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)


def syncs(t):
    return t.syncs / t.steps if t.syncs is not None and t.steps else None
