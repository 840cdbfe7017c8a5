"""Reading a ``torch.profiler`` trace of a stretch of the window.

:func:`traced` runs a stretch under the profiler with the card's activity
alone, whose window is the stretch by the host's clock, then a short one
with the host's activity too, inside a host range named ``WINDOW``.  The
trace's leaf device events (kernels, copies, sets; not the ranges that
``record_function`` puts on the device track) are read into
:class:`Trace`.  The device is busy over the union of their intervals, so
that kernels that overlap on two streams, NCCL's beside the compute, count
once; the idle share is what the union leaves of the window.  Each idle
gap is named by the innermost host event that covers its middle: what the
host was doing while the card waited.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

WINDOW = "portbench.traced"
COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]                  # the stretch, us
    device: List[Tuple[str, float, float]]       # leaf device events, us
    host: List[Tuple[str, float, float]]         # host events, us
    iters: int = 0                               # requests or steps in the stretch

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self):
        """Device events that are kernels (not copies or sets)."""
        return [e for e in self.device if not e[0].startswith(COPY_PREFIXES)]

    def copies(self):
        return [e for e in self.device if e[0].startswith(COPY_PREFIXES)]


def traced(stretch, iters: int, sync, labelled: int = 0):
    """Run ``stretch(n)`` (``n`` requests or steps) under the profiler:
    ``iters`` of them with the card's activity alone, for the numbers (the
    host's own recording would slow a host-paced step several times over),
    then ``labelled`` more with the host's activity too, whose idle gaps are
    named by what the host was doing.  ``sync()`` waits for the card.
    Returns (the Trace of the numbers, the Trace of the labels or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    card = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    with profile(activities=card) as prof:
        t0 = time.perf_counter()
        stretch(iters)
        sync()
        wall = time.perf_counter() - t0
    device = [(e.name, float(e.time_range.start), float(e.time_range.end))
              for e in prof.events() if str(e.device_type).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)]
    device.sort(key=lambda e: e[1])
    start = device[0][1] if device else 0.0
    numbers = Trace((start, start + wall * 1e6), device, [], iters)
    labels = None
    if labelled:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                stretch(labelled)
                sync()
        labels = read(prof.events(), labelled)
    return numbers, labels


def read(events, iters: int = 0) -> Trace:
    """A :class:`Trace` of a profiler's ``events()``."""
    device, host, window = [], [], None
    for e in events:
        span = (float(e.time_range.start), float(e.time_range.end))
        if e.name == WINDOW and str(e.device_type).endswith("CPU"):
            window = span
        elif str(e.device_type).endswith("CUDA"):
            if not getattr(e, "is_user_annotation", False) and e.name != WINDOW:
                device.append((e.name, *span))
        else:
            host.append((e.name, *span))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    inside = [e for e in device if e[1] >= window[0] and e[2] <= window[1]]
    return Trace(window, sorted(inside, key=lambda e: e[1]), host, iters)


def union(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(tr: Trace) -> float:
    """Seconds in which some device event ran, within the window."""
    return sum(e - s for s, e in union((s, e) for _, s, e in tr.device)) / 1e6


def idle_share(tr: Trace) -> float:
    return 1.0 - busy_s(tr) / tr.window_s


def top_ops(tr: Trace, n: int = 10):
    """[[name, seconds], ...]: the device events that took most time, by name."""
    by = {}
    for name, s, e in tr.device:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10):
    """[[host activity, seconds], ...]: the ``n`` longest stretches of the
    window in which the card ran nothing, each named by the innermost host
    event over its middle (``"host idle"`` where none is)."""
    gaps, t = [], tr.window[0]
    for s, e in union((s, e) for _, s, e in tr.device) + [(tr.window[1], tr.window[1])]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        over = [h for h in tr.host if h[1] <= mid <= h[2] and h[0] != WINDOW]
        name = min(over, key=lambda h: h[2] - h[1])[0] if over else "host idle"
        out.append([name, (e - s) / 1e6])
    return out


def matched_s(tr: Trace, patterns) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds one of ``patterns``."""
    hits = [(s, e) for name, s, e in tr.kernels() if any(p in name for p in patterns)]
    return sum(e - s for s, e in hits) / 1e6, len(hits)


def roofline(run, kernel: str, patterns):
    """100 x the least time of the traced stretch's ``kernel`` work
    (``run.bounds_s[kernel]`` an iteration, times its iterations) over the
    device time of the kernels whose name holds one of ``patterns``; None
    where there is no trace or no such kernel ran."""
    tr = run.trace
    if tr is None or not tr.iters or kernel not in run.bounds_s:
        return None
    s, n = matched_s(tr, patterns)
    return 100.0 * run.bounds_s[kernel] * tr.iters / s if n else None
