"""Reduction of a torch.profiler chrome trace to the numbers the per-layer
metrics read: the device's busy time over the traced window, device time
by span (kernels belong to the innermost span around their launch, matched
by the launch's correlation id), the wall of a span until the last device
operation it launched has ended, the operations that took most time, and
the idle gaps by the span the host was in."""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def gaps(intervals, lo: float, hi: float):
    """The (start, end) gaps within [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def load(path: str) -> list[dict]:
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]


def _owners(times, spans):
    """Index into ``spans`` of the innermost span holding each time, or -1.
    ``spans`` is sorted longest first, so a later (shorter) one wins."""
    owner = np.full(len(times), -1, np.int64)
    for k, (_, a, b) in enumerate(spans):
        owner[(times >= a) & (times <= b)] = k
    return owner


def summarize(events: list[dict], top: int = 10) -> dict:
    """Times in seconds. ``span_device_s`` and ``span_wall_s`` per span
    name; ``span_until_device_s``: per span name, the sum over its
    occurrences of the time from its start to the end of the last device
    operation launched inside it (or its own end, if later)."""
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device:
        return {}
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"), key=lambda s: s[1] - s[2])
    ts = np.asarray([launch_ts.get(e.get("args", {}).get("correlation"), np.nan) for e in device])
    start = np.asarray([e["ts"] for e in device], np.float64)
    dur = np.asarray([e["dur"] for e in device], np.float64)
    end = start + dur
    owner = _owners(ts, spans)
    span_wall, span_dev, until = defaultdict(float), defaultdict(float), defaultdict(float)
    for k, (name, a, b) in enumerate(spans):
        span_wall[name] += (b - a) / 1e6
        inside = (ts >= a) & (ts <= b)
        last = float(end[inside].max()) if inside.any() else b
        until[name] += (max(b, last) - a) / 1e6
    for k in np.unique(owner):
        span_dev[spans[k][0] if k >= 0 else "(no span)"] += float(dur[owner == k].sum()) / 1e6
    op_s = defaultdict(float)
    for e in device:
        op_s[e["name"]] += e["dur"] / 1e6
    busy_iv = list(zip(start, end))
    idle_iv = gaps(busy_iv, lo, hi)
    idle = defaultdict(float)
    if idle_iv:
        iv = np.asarray(idle_iv)
        for k, length in zip(_owners(iv.mean(1), spans), iv[:, 1] - iv[:, 0]):
            idle[spans[k][0] if k >= 0 else "(no span)"] += float(length) / 1e6
    return dict(
        window_s=(hi - lo) / 1e6, busy_s=union_length(busy_iv) / 1e6, device_ops=len(device),
        span_device_s=dict(span_dev), span_wall_s=dict(span_wall), span_until_device_s=dict(until),
        top_ops=sorted(op_s.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top],
    )
