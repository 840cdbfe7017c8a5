"""Profiling hooks (counterpart of ``focalnet_tpu/utils/profiling.py``).

Device traces come from ``torch.profiler`` (CPU and CUDA activities) and are
written as Chrome traces; :func:`parse_trace` and :func:`op_mix` read them
back, counting the card's leaf events only.  :func:`device_profile` is the
per-kind breakdown and idle share that ``chip_smoke.py`` prints.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time

import torch

# leaf device events of a torch.profiler Chrome trace; everything else is a
# host track (cpu_op, cuda_runtime, python_function, ...) or a range that
# spans leaf events ("gpu_user_annotation": record_function on the device
# track, e.g. Adam.step's) and would count them twice
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# the JAX package's op_mix keys, matched against the port's kernel names
OP_MIX_BUCKETS = {
    "scan_kernel": ("selective_scan",),
    "conv": ("conv", "cudnn", "implicit"),
    "fusion": ("elementwise", "reduce", "fused"),
    "layout": ("memcpy", "memset", "copy", "transpose", "permute", "cat"),
}

# the kinds of device_profile, first match wins
KINDS = (
    ("scan_bwd", ("selective_scan_bwd",)),
    ("scan_fwd", ("selective_scan",)),
    ("conv", ("conv", "cudnn", "implicit")),
    ("matmul", ("gemm", "xmma", "cutlass")),
    ("fft", ("fft",)),
)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str = "focalnet_trace"):
    """Capture a trace viewable in Perfetto or chrome://tracing:

        with trace("tr"):
            step(...)  # synchronise inside the context

    The Chrome trace is written into ``log_dir`` on exit."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, iters: int = 10, warmup: int = 3):
    """Seconds per call of ``fn(*args)`` by the wall clock, after ``warmup``
    calls; the card is synchronised before the clock is read."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def parse_trace(log_dir: str, min_us: float = 0.0):
    """Aggregate DEVICE time from the newest Chrome trace in ``log_dir``.

    Returns ``{"total_ms": float, "ops": [(name, ms, count, category), ...]}``
    sorted by time, summing complete events of the leaf device categories
    (:data:`DEVICE_CATEGORIES`).  Host events and annotation ranges are
    excluded."""
    files = sorted(glob.glob(os.path.join(log_dir, "*.json")), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace under {log_dir}")
    with open(files[-1]) as f:
        events = json.load(f)["traceEvents"]
    agg = collections.defaultdict(lambda: [0.0, 0])
    total = 0.0
    for e in events:
        cat = str(e.get("cat", ""))
        if e.get("ph") != "X" or cat.lower() not in DEVICE_CATEGORIES:
            continue
        dur = float(e.get("dur", 0.0))
        if dur < min_us:
            continue
        key = (e.get("name", "?"), cat)
        agg[key][0] += dur
        agg[key][1] += 1
        total += dur
    ops = sorted(((k[0], v[0] / 1000.0, v[1], k[1]) for k, v in agg.items()),
                 key=lambda x: -x[1])
    return {"total_ms": total / 1000.0, "ops": ops}


def _bucket(text: str, buckets):
    low = text.lower()
    for key, pats in buckets:
        if any(p in low for p in pats):
            return key
    return "other"


def op_mix(log_dir: str, buckets=None, min_us: float = 0.0):
    """Bucket :func:`parse_trace` output by substring of
    ``"<category> <name>"`` -> ms (keys of :data:`OP_MIX_BUCKETS` by default,
    then ``"other"`` and ``"total"``)."""
    r = parse_trace(log_dir, min_us=min_us)
    buckets = buckets or OP_MIX_BUCKETS
    out = {k: 0.0 for k in buckets}
    out["other"] = 0.0
    for name, ms, _count, cat in r["ops"]:
        out[_bucket(f"{cat} {name}", buckets.items())] += ms
    out["total"] = r["total_ms"]
    return out


def device_profile(fn, reps: int):
    """Where the device time of ``reps`` calls of ``fn`` goes: torch.profiler
    over them (after one untraced call), kernel time by kind (:data:`KINDS`)
    and by name, and the device's idle share between the first kernel's
    start and the last one's end.  ``None`` when no device event was
    recorded."""
    from torch.profiler import profile

    fn()
    _sync()
    with profile(activities=_activities()) as prof:
        for _ in range(reps):
            fn()
        _sync()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    by_name, by_kind = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        kind = _bucket(e.name, KINDS)
        by_kind[kind] = by_kind.get(kind, 0.0) + us
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    busy = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(
        calls=reps, kernels_per_call=len(kernels) / reps,
        device_ms_per_call=busy / reps / 1e3, span_ms_per_call=span / reps / 1e3,
        idle_share=1.0 - busy / span,
        ms_per_call_by_kind={k: v / reps / 1e3 for k, v in sorted(by_kind.items())},
        top=[dict(name=k[:80], launches=n // reps, ms_per_call=t / reps / 1e3)
             for k, (n, t) in top])
