"""Spans of a run: named host intervals, their table, and the device work
each one launched.

``span(name)`` is the one way the port opens a span. It always enters
``torch.profiler.record_function(name)``, so a torch.profiler trace shows
the span on the clock of the device's kernel timestamps. While a table is
being recorded (``recording()``, which ``SceneOptimizer.run`` opens around
each run) it also adds the span's call, its host seconds (``perf_counter``,
no device synchronisation) and its self seconds (host seconds less the part
of them that its child spans cover) to the table. Without a table it costs
a ``record_function`` and one context lookup. Names nest by ``/``: a child
span's name extends its parent's (``back_end/tracks/union_find``). Spans
open at coarse boundaries, never once per iteration of a hot loop.

``count(name, value)`` is the table's other half: while a table is being
recorded it adds ``value`` to the counter ``name`` of the run
(``SpanTable.counters``, ``result.trace["counters"]`` after
``SceneOptimizer.run``); without a table it does nothing. Counters hold
amounts of work that the host already knows, such as the layers and tokens
that adaptive LightGlue ran (``lightglue/*``, counted from the decisions it
reads back between layers): a caller passes plain Python numbers, never a
device value, so counting adds no device-to-host copy.

``device_counts`` reduces a torch.profiler chrome trace to counts per
innermost span: launch calls (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaGraphLaunch`` and their variants, one per call however many kernels it
starts), the kernels themselves, host-to-device and device-to-host copies
with their bytes, and explicit synchronisations. A host call belongs to the
innermost span that holds its own timestamp; a device operation to the one
that holds the timestamp of the runtime call that issued it (matched by
correlation id). A span holds the times from its start to its end, both
included; the rest goes to ``(no span)``. This is the rule by which the
benchmark's ``sfm_bench/trace.py`` files device time and idle gaps, so a
kernel that a library starts with ``cuLaunchKernel`` (a low-level CUDA API
call, counted as a launch in its span) is filed under ``(no span)`` here as
there.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import time

import numpy as np
from torch.profiler import record_function

NO_SPAN = "(no span)"
# Host calls, by their name before any "_" version suffix.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")
COUNT_KEYS = ("launches", "kernels", "h2d_copies", "h2d_bytes", "d2h_copies", "d2h_bytes", "syncs")


class SpanTable:
    """Per span name: ``calls``, ``host_s`` and ``self_s`` of one run; per
    counter name, its sum (``counters``)."""

    def __init__(self):
        self.rows: dict[str, dict] = {}
        self.counters: dict[str, int | float] = {}
        self._child_s: list[float] = []  # per open span: seconds its children covered so far

    def _open(self) -> None:
        self._child_s.append(0.0)

    def _close(self, name: str, seconds: float) -> None:
        child = self._child_s.pop()
        if self._child_s:
            self._child_s[-1] += seconds
        row = self.rows.get(name)
        if row is None:
            row = self.rows[name] = {"calls": 0, "host_s": 0.0, "self_s": 0.0}
        row["calls"] += 1
        row["host_s"] += seconds
        row["self_s"] += seconds - child


# The table of the run this thread is recording, if any. A context variable
# and not an argument: spans open deep inside modules that know nothing of
# the run, as record_function's do; other threads start without a table.
_current: contextvars.ContextVar[SpanTable | None] = contextvars.ContextVar("gtsfm_tpu_torch_span_table",
                                                                            default=None)


@contextlib.contextmanager
def recording():
    """Records the spans of the enclosed code into a new SpanTable, which it
    yields; the table recorded before is restored on the way out, also when
    the code raises."""
    table = SpanTable()
    token = _current.set(table)
    try:
        yield table
    finally:
        _current.reset(token)


def count(name: str, value: int | float) -> None:
    """Adds ``value`` (a host number) to the counter ``name`` of the table
    being recorded, if any (see the module docstring)."""
    table = _current.get()
    if table is not None:
        table.counters[name] = table.counters.get(name, 0) + value


class span:
    """``with span("back_end/tracks"):`` (see the module docstring)."""

    __slots__ = ("name", "_annotation", "_table", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._annotation = record_function(name)

    def __enter__(self):
        self._annotation.__enter__()
        self._table = _current.get()
        if self._table is not None:
            self._table._open()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._table is not None:
            self._table._close(self.name, time.perf_counter() - self._t0)
        self._annotation.__exit__(*exc)
        return False


def load_events(path: str) -> list[dict]:
    """The complete ("X") events of a chrome trace that torch.profiler wrote."""
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]


def _owners(spans: list[tuple[str, float, float]], times: np.ndarray) -> np.ndarray:
    """Index into ``spans`` (sorted longest first) of the innermost span
    holding each time, or -1: a later, shorter span wins."""
    owner = np.full(len(times), -1, np.int64)
    for k, (_, a, b) in enumerate(spans):
        owner[(times >= a) & (times <= b)] = k
    return owner


def device_counts(events: list[dict]) -> dict[str, dict[str, int]]:
    """Per innermost span name (``NO_SPAN`` for none), the COUNT_KEYS of the
    chrome-trace ``events``; a name with nothing counted is left out."""
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "user_annotation"),
                   key=lambda s: s[1] - s[2])
    issued = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    times, keys, nbytes = [], [], []  # per counted event: its time, COUNT_KEYS slot, bytes
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "kernel" or (cat == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name)):
            args = e.get("args", {})
            times.append(issued.get(args.get("correlation"), np.nan))
            keys.append(1 if cat == "kernel" else 2 if "HtoD" in name else 3)
            nbytes.append(0 if cat == "kernel" else int(args.get("bytes", 0)))
        elif cat in ("cuda_runtime", "cuda_driver") and name.split("_")[0] in LAUNCH_CALLS:
            times.append(e["ts"])
            keys.append(0)
            nbytes.append(0)
        elif cat == "cuda_runtime" and name.split("_")[0] in SYNC_CALLS:
            times.append(e["ts"])
            keys.append(4)
            nbytes.append(0)
    key, size = np.asarray(keys, np.int64), np.asarray(nbytes, np.int64)
    owner = _owners(spans, np.asarray(times, np.float64)) + 1  # 0: no span
    names = [NO_SPAN] + [name for name, _, _ in spans]
    out: dict[str, dict[str, int]] = {}
    for k in np.unique(owner).tolist():
        mine = owner == k
        n = np.bincount(key[mine], minlength=5)
        b = np.bincount(key[mine], weights=size[mine], minlength=5)
        c = out.setdefault(names[k], dict.fromkeys(COUNT_KEYS, 0))
        for name, v in zip(COUNT_KEYS, (n[0], n[1], n[2], b[2], n[3], b[3], n[4])):
            c[name] += int(v)
    return out
