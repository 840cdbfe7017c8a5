"""Measured fp32 FMA rate of the card, and the selective-scan forward kernel
in units of it (counterpart of ``benchmarks/vpu_probe.py``, the TPU's
VPU-ceiling probe).

The probe runs P dependent FMA passes over the scan's own (B, 1, D, L)
operand (the kernel of ``ops/csrc/fma_passes.cu``) at two values of P; the
difference of the two device times cancels the fixed cost and gives the
time of one pass, and so the card's fp32 FMA rate.  The scan's forward
kernel (K1) is timed at the same shape, with the JAX probe's options
(softplus, no D, no bias), and expressed as pass-equivalents against the
cost-model floor 9·N/2 (the reference's 9·B·L·D·N FLOPs, 2 per FMA).
Device times come from a ``torch.profiler`` trace, summed over each
kernel's own events.

Usage:
    python -m focalnet_tpu_torch.benchmarks.vpu_probe [--B 4] [--D 192] [--L 16384] [--N 16]

The JAX probe's ``--D_blk`` and ``--T`` are the TPU kernel's block sizes;
the CUDA kernel is a flat grid over the elements and has none.  It runs on
the CUDA card and raises without one; ``--device cpu`` runs the plain
versions (for the tests), and then every measured value is null.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import torch

from focalnet_tpu_torch.ops.fma_passes import UNROLL, fma_passes
from focalnet_tpu_torch.ops.selective_scan import selective_scan
from focalnet_tpu_torch.utils.device import nvidia_smi, resolve_device
from focalnet_tpu_torch.utils.flops import scan_flops
from focalnet_tpu_torch.utils.profiling import parse_trace, trace

LOOPS = (8, 64)  # P = 64 and 512 passes, the JAX probe's pair
ITERS = 4  # traced calls per point, after two untraced ones
TRACE_ATTEMPTS = 3  # traces taken at most when one holds none of the kernel's events


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, pattern: str, device, per_call=None):
    """Device ms per call of ``fn()``: the trace's device events whose name
    holds ``pattern``, summed over :data:`ITERS` calls (after two untraced
    ones) and divided by their number.  With ``per_call`` (the kernels of
    the pattern that one call launches), the mean event's time times
    ``per_call`` instead, so that an event missing from the trace does not
    read as a faster call, and a trace with none of them is taken again (NaN
    after :data:`TRACE_ATTEMPTS`).  On the CPU there are no device events,
    and this is 0."""
    fn()
    fn()
    _sync(device)
    for _ in range(TRACE_ATTEMPTS):
        d = tempfile.mkdtemp(prefix=f"vpu_{pattern}_")
        try:
            with trace(d):
                for _ in range(ITERS):
                    fn()
                _sync(device)
            hits = [(ms, n) for name, ms, n, _ in parse_trace(d)["ops"] if pattern in name]
        finally:
            shutil.rmtree(d, ignore_errors=True)
        total, events = sum(ms for ms, _ in hits), sum(n for _, n in hits)
        if per_call is None or device.type != "cuda":
            return total / ITERS
        if events:
            return total / events * per_call
    return float("nan")


def probe_input(B, D, L, device):
    """The probe's operand, (B, 1, D, L) fp32 uniform in [0, 1), from seed 0."""
    g = torch.Generator(device=device).manual_seed(0)
    return torch.rand(B, 1, D, L, generator=g, device=device)


def run_probe(B=4, D=192, L=16384, N=16, loops=LOOPS, device=None):
    """The probe at (B, D, L, N) and the pair ``loops`` of n_loop values,
    over :func:`probe_input`.

    Returns the JSON line's fields (``metric`` ... ``ratio_to_arithmetic_floor``),
    unrounded, plus ``passes``, ``probe_ms`` and ``device``.  On the CPU the
    plain versions run and every measured value is None."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    x = probe_input(B, D, L, device)
    passes = [UNROLL * n for n in loops]
    ts = []
    for n_loop, P in zip(loops, passes):
        t = device_ms(lambda: fma_passes(x, n_loop), "fma_passes", device)
        ts.append(t if on_card else None)
        print(f"  P={P:4d} passes: {t:8.3f} ms device" if on_card
              else f"  P={P:4d} passes: not measured (cpu)", flush=True)

    g = torch.Generator(device=device).manual_seed(1)
    A = -torch.exp(torch.rand(D, N, generator=g, device=device))
    dl = torch.rand(B, D, L, generator=g, device=device) * 0.1
    Bm = torch.rand(B, 1, N, L, generator=g, device=device)
    Cm = torch.rand(B, 1, N, L, generator=g, device=device)
    backend = "cuda" if on_card else "chunked"

    def scan():
        with torch.no_grad():
            return selective_scan(x[:, 0], dl, A, Bm, Cm, delta_softplus=True,
                                  backend=backend)

    t_scan = device_ms(scan, "selective_scan_fwd", device, per_call=1)
    floor = scan_flops(B, L, D, N, with_D=False) / (2 * B * L * D)
    out = dict(metric="scan_vpu_ceiling", scan_fwd_device_ms=None, probe_fma_tflops=None,
               pass_equivalents=None, cost_model_floor_passes=floor,
               ratio_to_arithmetic_floor=None)
    if on_card:
        per_pass = (ts[1] - ts[0]) / (passes[1] - passes[0])
        fma_rate = B * D * L / (per_pass * 1e-3)
        n_eq = t_scan / per_pass
        print(f"per-pass {per_pass * 1e3:.1f} us -> "
              f"{2 * fma_rate / 1e12:.2f} TFLOP/s fp32 fma over the scan blocks", flush=True)
        out.update(scan_fwd_device_ms=t_scan, probe_fma_tflops=2 * fma_rate / 1e12,
                   pass_equivalents=n_eq, ratio_to_arithmetic_floor=n_eq / floor)
    return dict(out, passes=passes, probe_ms=ts, device=str(device))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--B", type=int, default=4)
    p.add_argument("--D", type=int, default=192)
    p.add_argument("--L", type=int, default=16384)
    p.add_argument("--N", type=int, default=16)
    p.add_argument("--device", type=str, default="",
                   help="'' = the CUDA card (error without one); 'cpu' runs the "
                        "plain versions and measures nothing")
    args = p.parse_args(argv)
    device = resolve_device(args.device or None)
    print(f"card: {nvidia_smi()}" if device.type == "cuda"
          else "device: cpu (plain versions; device times not measured)", flush=True)
    r = run_probe(args.B, args.D, args.L, args.N, device=device)
    keys = ("metric", "scan_fwd_device_ms", "probe_fma_tflops", "pass_equivalents",
            "cost_model_floor_passes", "ratio_to_arithmetic_floor")
    print(json.dumps({k: r[k] for k in keys}), flush=True)
    return r


if __name__ == "__main__":
    main()
