#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``focalnet_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds every kernel of the port's main paths from the checkout's sources
(the selective-scan forward and backward and the FMA-pass probe, one nvcc
each, in parallel; and the forward and backward kernels as of their
baseline commits, to be timed beside them, when the checkout's history or
``_build/baseline/`` holds them), holds each against its plain PyTorch
version at the main paths' shapes (both scan kernels at batch 1 and 4 and
at every tile of channels they take), runs the fp32 FMA-rate probe
(``python -m focalnet_tpu_torch.benchmarks.vpu_probe``) with launch counts,
serves the full-width ``1mlp_g2`` dehazer through the CLI's ``--mode serve``
(whole-image and ``--tile``) with kernel launch counts, compares the whole
forward (256x256 and 480x640) and the whole gradient on the kernels with the
plain scans, runs the CLI's ``--mode test`` on a synthetic SOTS-indoor-sized
test split (460x620) on the kernel and on the plain scan and ``--mode
infer`` on a directory of mixed sizes (batch 1, batch 2, ``--tile``) with
launch counts, times and profiles a batch-4 256x256 train step, and trains
through the CLI's ``--mode train`` for 2 epochs on a synthetic dataset and
resumes for a third, with launch counts and the log scraper on its log.  K1
is also held against its plain version, and timed, at the eval slice's scan
lengths (76800, 19200, 4800), and both scan kernels at the other presets'
lengths (256, one chunk; 1200, a ragged tail) and with bf16 operands.  The
other three presets (``baseline``, ``1mlp``, ``1mlp_g4``) run their
forwards (kernel vs plain), train steps (gradients, kernel vs plain) and
``--mode test`` / ``--mode infer`` through the CLI; the bf16 recipe
(``--compute_dtype bfloat16 --ssm_out_dtype bfloat16``) its forwards, its
step (gradients, peak memory with and without ``use_checkpoint``) and one
``--mode train`` epoch of ``1mlp``; and the fp32 forward and step are timed
with TF32 off and on.  The sequence-parallel slice: both scan kernels'
segment API (K1 h0 -> h_last, K2 dh_last -> dh0) against their plain
versions at the sharded path's shapes (384 channels in two groups, half
the lengths of a 256x256 step and a 480x640 test, fp32 and bf16, both
directions, chained halves against the whole call), timed beside the plain
launch; ``--mode test --mesh_shape 1,2`` on the 460x620 split against the
single-rank run; and ``--mesh_shape 1,2`` training (the first step's
gradients against one rank's, then 3 steps through the CLI with the ranks'
parameters compared), with every rank's launch counts and peak memory.
The two ranks share the one card (gloo); a rank that dies or a collective
that hangs fails the run.  The rest of parallelism: K1 (with and without
y_accum) and K2 at the channel-split scan's shards against their plain
versions, timed (``kernel_tp``); ``--mode test`` at ``--mesh_shape 4`` and
``2,1`` and ``--mode serve --mesh_shape 1,2`` run without a mesh, as in
JAX (``mesh_free_cli``); with two ranks on the card, data parallelism (the
first batch-4 step against one process, ``dp_grad``; 3 steps of ``--mode
train --mesh_shape 2`` under the bf16 recipe) and ``--mode infer`` at ``2``
and ``1,2`` against the one-process PNGs (``dp_infer_cli``); with four, dp
x sp at ``2,2`` (``dpsp_grad``, and 3 CLI steps) and the channel-split scan
over a (data, model) = (2, 2) mesh (``tp_grad``, and 3 steps), each rank's
launches, peak memory and step time.  ``python3 chip_smoke.py --sp_only``
runs the sequence-parallel phases alone on every card of the machine (one
card per rank over NCCL where there are enough; ``--mesh_shape 1,4`` too
with four), and with several cards data parallelism over NCCL at ``2`` and
``4`` ranks, batch 4 and 16, against one card, and ``--mode train`` with the
default mesh.  The modules no preset uses: the full-width ``1mlp_g2`` at
four SS2D variants that together take every flag (``variants``: force_fp32
under the bf16 recipe, so K1 and K2 read fp32 operands in a bf16 model; the
softmax, dwconv3 and no out-norm; noz, nozact; v1 and v2 init; no
depthwise conv), each 256x256 forward and batch-4 step on the kernels
against the plain scans; ``MambaSS2D`` at the model's width on 128x128
(``mamba``: its Mamba1D scans 384 channels in one group), forward and
step, and K1 and K2 alone at that shape, held and timed; and ``grad_accum``
under data parallelism (``dp_accum``: ``--mesh_shape 4 --batch_size 4
--grad_accum 2`` on four ranks, two of them without rows, and batch 2 over
two ranks, against one process over the same micro-batches, and that
command through the CLI for 3 steps).  The native data loader
(``data/csrc/loader.cpp``, built with g++ beside the kernels; the build line
names its codecs): decode and u8 decode bit for bit against the numpy codec
on every file of a synthetic RESIDE-ITS split at 460x620 (rows with every
PNG filter) and on palette, 16-bit, gray+alpha and Adam7 PNGs, batch-4
pair batches at crop 256 and 1, 4, 8 threads against the plain version, the
encoder's round trip, and their times on the card's host (``loader``); then
one epoch of ``--mode train`` on that split through it, 4 steps and 2
validated images, with launch counts (``train_its_cli``).
Each phase prints one JSON line; any failed check
exits non-zero before the last line, which is ``{"ok": true,
"device": {...}}``.
Weights are random, from a seed: no trained checkpoint is in the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data-sheet peaks
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
SFU_EXP_PER_CLOCK_PER_SM = 16
TOLS = {torch.float32: (6e-4, 2e-3), torch.bfloat16: (3e-2, 5e-2)}  # rtol, atol
MODEL_TOL = (1e-3, 3e-4)
# gradients, per tensor: |got - want| <= rtol |want| + atol max(1, max |want|);
# fp32 sums in another order (dB/dC by atomics, in no fixed order); with
# bf16 inputs du, ddelta, dB and dC come back rounded to bf16
GRAD_TOLS = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
# whole-model gradients, per parameter: max |got - want| <= rel max |want| + abs
MODEL_GRAD_TOL = (1e-3, 1e-5)
GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dbias", "dy_accum")
PATH_LS = (16384, 4096, 1024)  # scan lengths of a 256x256 forward
# SOTS-indoor's 460x620 images, padded to 480x640: the eval slice's lengths
SOTS_HW = (460, 620)
EVAL_LS = (76800, 19200, 4800)
EVAL_BATCHES = (1, 2)          # --mode test and infer; infer at --valid_batch 2
# --mode infer's directory: two 460x620, two 256x256, one 250x310
INFER_SIZES = [SOTS_HW, SOTS_HW, (256, 256), (256, 256), (250, 310)]
LAUNCHES_PER_FORWARD = 48      # 12 SS2D x 4 directions
# the other presets: K1 launches per forward, and K1 and K2 per train step
# (the dual branch of 1mlp scans twice; the baseline's ResBlocks not at all)
PRESET_LAUNCHES = {"baseline": 0, "1mlp": 96, "1mlp_g2": 48, "1mlp_g4": 48}
OTHER_PRESETS = ("baseline", "1mlp", "1mlp_g4")
# the patch-4 branch's quarter-scale lengths: 256 at 256x256 (exactly one
# 256-item chunk), 1200 at 480x640 (four chunks and a ragged 176)
NEW_LS = (256, 1200)
# the JAX package's bf16 recipe
RECIPE = dict(compute_dtype="bfloat16", ssm_out_dtype="bfloat16")
# bf16 recipe, kernel vs plain scan.  K1 adds y_accum in fp32 before its
# bf16 rounding, the plain scan after it (JAX has the same split): one bf16
# step in a reversed call's y.  Emulated on the CPU (the plain scan with the
# kernel's order of add and rounding) it moved the 128x128 and 256x256
# forward's outputs (|out| <= 2.5) by at most 0.0156, one bf16 step in
# [2, 4), where bf16 against fp32 moves them 0.064-0.076.  Forward: atol
# 0.0625, four such steps (the kernel's fp32 sums also flip roundings).
# Gradients: per parameter max |got - want| <= 0.1 max |want| + 0.02 G, G the
# largest |gradient| of the model: the emulated split reached 0.63 of that
# limit (a bias before a norm, whose true gradient is 0) at 64x64, batch 2,
# on the train loss (smooth_loss, which the check uses, has no sign flips).
BF16_MODEL_TOL = (0.0, 0.0625)
BF16_GRAD_TOL = (0.1, 0.02)
TRAIN_BATCH = 4
# the FMA-pass probe: its check shape, its (and the JAX probe's) shape, and
# the n_loop values; P = 8 n_loop passes.  At the check shape, one FMA per
# pass in the kernel against a rounded product and sum in the fp32 plain
# version: rtol 1e-4 at P <= 512; at the probe's shape, against the float64
# plain version with rtol probe_rtol(P)
PROBE_CHECK_SHAPE = (1, 1, 192, 4096)
PROBE_SHAPE = dict(B=4, D=192, L=16384, N=16)
PROBE_CHECK_LOOPS = (1, 8, 64)
PROBE_PATH_LOOPS = (8, 64, 512)  # the CLI's pair and chip_smoke's (64, 512)
PROBE_RTOL = 1e-4
FMA_LANES_PER_SM = 128
# the sequence-parallel path (--mesh_shape 1,2): each SS2D stacks its two
# rasters into one scan of D = 2 x 192 channels in two B/C groups, twice (the
# forward pair, the reversed pair), each rank scanning L / 2; the lengths
# per rank at 256x256 (the train step's batch 4) and 480x640 (--mode test)
SP_MESH, SP_RANKS = "1,2", 2
SP_DIM, SP_GROUPS = 384, 2
SP_LS = {TRAIN_BATCH: (8192, 2048, 512), 1: (38400, 9600, 2400)}
SP_LAUNCHES_PER_FORWARD = 24   # 12 SS2D x 2 stacked-pair calls, on each rank
# a rank that dies fails the run at once; a collective that hangs fails its
# rank after parallel.mesh.COLLECTIVE_TIMEOUT_S (300 s), and with it the run
SP_TIMEOUT_S = 300
# data parallelism (--mesh_shape 2: two ranks, each 2 rows of the batch of
# 4), dp x sp (2,2) and the channel-split scan over a (data, model) = (2, 2)
# mesh, each rank's DropPath masks those of the whole batch (a generator
# seeded with DP_MASK_SEED).  The mesh's first step against one process:
# the loss within DP_LOSS_RTOL (the ranks' layers sum half the batch, in
# another order), the gradients under GRAD_TOLS
DP_MESH, DP_RANKS = "2", 2
DPSP_SHAPE = TP_SHAPE = (2, 2)
DP_MASK_SEED = 77
DP_LOSS_RTOL = 1e-4
DP_NCCL_BATCHES = (TRAIN_BATCH, 16)  # --sp_only on several cards: 1 and 4 images a card
# grad_accum under data parallelism: the step over DP_ACCUM micro-batches of
# batch / DP_ACCUM rows, resharded over the data axis (four ranks at batch
# 4: micro-batches of 2 rows, ranks 2 and 3 with none; two ranks at batch 2:
# micro-batches of one row, rank 1 with none), against one process over the
# same micro-batches
DP_ACCUM = 2
# the channel-split scan: each SS2D's two stacked-pair calls, with their
# 2 x 192 channels split over the model axis; a sub-group shard holds half
# of each group's channels (2 x 96 in two groups), and the whole-group shard
# of the (2, 2) mesh one group of 192
TP_DIM, TP_SUB_GROUPS = 192, 2
TP_LAUNCHES_PER_FORWARD = 24   # 12 SS2D x 2 stacked-pair calls, on each rank
TP_STEPS = 3
# the variants slice: configurations of the full-width 1mlp_g2 that together
# take every SS2D flag (force_fp32 under the bf16 recipe; softmax, dwconv3
# and no out-norm; noz, nozact; v1 and v2 init; no depthwise conv), and
# MambaSS2D at the model's width on a 128x128 map (its Mamba1D pair scans
# 2 x 192 = 384 channels in one group, L = 16384)
VARIANTS = (
    ("v2sigmoid_bf16", dict(forward_type="v2sigmoid", **RECIPE)),
    ("v4softmaxnoz", dict(forward_type="v4softmaxnoz", ssm_conv=1, ssm_init="v1")),
    ("v4dwconv3nozact", dict(forward_type="v4dwconv3nozact", ssm_init="v2")),
    ("v4none", dict(forward_type="v4none")),
)
MAMBA_DIM, MAMBA_HW = 96, 128
MAMBA_SCAN_DIM = 2 * 2 * MAMBA_DIM  # ssm_ratio 2, then Mamba1D's expand 2
# MambaSS2D, kernel vs plain: max |got - want| <= MAMBA_RTOL max |want| for
# the output and each parameter's gradient (MODEL_GRAD_TOL's relative part)
MAMBA_RTOL = 1e-3
# the native loader's slice: RESIDE-ITS's 460x620 images, 8 GTs with 2 hazy
# images each (4 steps of TRAIN_BATCH), 1 test GT (2 validated images)
ITS_HW = SOTS_HW
ITS_TRAIN, ITS_TEST = 8, 1
LOADER_THREADS = (1, 4, 8)


def emit(**fields):
    print(json.dumps(fields), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps=20, warmup=3):
    """Median time of one call of ``fn`` in ms on the device's stream: CUDA
    events around each call (the host's issue time included).  Used for the
    plain versions and the whole model."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, pattern):
    """A kernel's own device time per call of ``fn`` in ms: the profiled
    device events whose name holds ``pattern``, as the probe measures them
    (:func:`focalnet_tpu_torch.benchmarks.vpu_probe.device_ms`), for a
    ``fn`` that launches one such kernel.  Every kernel's ``ms`` is taken
    this way."""
    from focalnet_tpu_torch.benchmarks.vpu_probe import TRACE_ATTEMPTS, device_ms

    ms = device_ms(fn, pattern, torch.device("cuda"), per_call=1)
    if not math.isfinite(ms):
        fail(f"the profiler recorded no {pattern} kernel in {TRACE_ATTEMPTS} traces")
    return ms


def max_err(got, want, rtol, atol):
    """(max |got - want|, whether every element is within atol + rtol |want|)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), ok


def scan_inputs(L, dim=192, N=16, dtype=torch.float32, seed=0, batch=1, groups=1):
    """Scan operands at the main path's widths, with the model's A and dt laws."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    dt = torch.exp(torch.rand(dim, generator=g, device="cuda")
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    x = dict(
        u=r(batch, dim, L).to(dtype), delta=(0.1 * r(batch, dim, L)).to(dtype),
        A=-torch.arange(1.0, N + 1, device="cuda").expand(dim, N).contiguous(),
        B=(0.5 * r(batch, groups, N, L)).to(dtype), C=(0.5 * r(batch, groups, N, L)).to(dtype),
        D=r(dim), delta_bias=dt + torch.log(-torch.expm1(-dt)),
    )
    return x, r(batch, dim, L)


def bound(L, clock_mhz, sms, dim=192, N=16, in_bytes=4, out_bytes=4, accum=False, batch=1,
          chunk_states=False, groups=1):
    """Least time (ms) for one forward call: the larger of the bytes moved
    once (u, delta, B, C of ``groups`` groups in the input dtype, y and
    y_accum in the output dtype, the chunk states, A, D, bias in fp32) at the
    memory rate, the 9*L*D*N + L*D fp32 operations per batch row at the fp32
    rate, and the exponentials' floor."""
    n_chunks = -(-L // 256)
    nbytes = (batch * (dim * L * (2 * in_bytes + out_bytes * (2 if accum else 1))
                       + 2 * groups * N * L * in_bytes
                       + (dim * n_chunks * N * 4 if chunk_states else 0))
              + (dim * N + 2 * dim) * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = batch * (9 * L * dim * N + L * dim) / PEAK_FP32_FLOPS * 1e3
    t_sfu = batch * sfu_ms(L, clock_mhz, sms, dim, N)
    return max(t_bytes, t_ops, t_sfu), "bytes" if t_bytes >= max(t_ops, t_sfu) else "operations"


def sfu_ms(L, clock_mhz, sms, dim=192, N=16):
    """The special-function units' floor: dim * N * L exponentials at 16 per
    clock per SM."""
    return dim * N * L / (SFU_EXP_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6) * 1e3


def bound_bwd(L, clock_mhz, sms, dim=192, N=16, in_bytes=4, batch=1, groups=1):
    """Least time (ms) for one backward call: the larger of the bytes moved
    once (u, delta, B, C, du, ddelta in the input dtype; dy, the chunk
    states, dB, dC, A, D, bias, dA, dD, dbias in fp32; B, C of ``groups``
    groups) at the memory rate, 22*L*D*N + 10*L*D fp32 operations per batch
    row (the forward's 9 per state and element again, 13 for the adjoint and
    its sums) at the fp32 rate, and the exponentials' floor."""
    n_chunks = -(-L // 256)
    nbytes = (batch * (dim * L * (4 * in_bytes + 4) + 2 * groups * N * L * (in_bytes + 4)
                       + dim * n_chunks * N * 4) + 2 * (dim * N + 2 * dim) * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = batch * (22 * L * dim * N + 10 * L * dim) / PEAK_FP32_FLOPS * 1e3
    t_sfu = batch * sfu_ms(L, clock_mhz, sms, dim, N)
    return max(t_bytes, t_ops, t_sfu), "bytes" if t_bytes >= max(t_ops, t_sfu) else "operations"


def grad_err(got, want, rtol, atol):
    """(max |got - want|, whether every element is within
    rtol |want| + atol max(1, max |want|))."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = max(1.0, float(want.abs().max()))
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol * scale + rtol * want.abs()).all())
    return float(diff.max()), ok


def phase_kernel(scan, fwd, fwd_ref_states, tile_of, launched_tile, baseline, clock_mhz, sms):
    """K1 vs its plain version at the path's shapes: B = 1 and the train
    step's B = 4, L = 16384, 4096, 1024, 1000, both directions, with and
    without y_accum, fp32 and bf16 out (fp32 in), and bf16 in; its chunk
    states vs chunk_states_ref at B = 1 and 4; then at widths and batches
    that take each tile of channels (fails unless tiles of 1, 2, 3, 4 and 6
    were all taken, each the tile the launch reports).  Then K1's own time
    at B = 1 (serving) and B = 4 with chunk states (the train step's call)
    vs the plain scan's and, when ``baseline`` (K1 before the channel
    tiles) was built, vs its time, in turns (baseline, K1, K1, baseline)."""
    from focalnet_tpu_torch.ops.selective_scan_cuda import launch_fwd

    worst = 0.0
    cases = [(batch, L, rev, acc, out, torch.float32)
             for batch in (1, TRAIN_BATCH) for L in PATH_LS + (1000,) for rev in (False, True)
             for acc in (False, True) for out in (torch.float32, torch.bfloat16)]
    cases += [(batch, L, rev, True, out, torch.bfloat16) for batch in (1, TRAIN_BATCH)
              for L in (4096, 1000) for rev in (False, True)
              for out in (torch.float32, torch.bfloat16)]
    with torch.inference_mode():
        for batch, L, rev, acc, out, inp in cases:
            x, yacc = scan_inputs(L, dtype=inp, batch=batch)
            kw = dict(delta_softplus=True, reverse=rev, out_dtype=out,
                      y_accum=yacc.to(out) if acc else None)
            got = scan(**x, backend="cuda", **kw)
            want = scan(**x, backend="chunked", **kw)
            torch.cuda.synchronize()
            rtol, atol = TOLS[out]
            err, ok = max_err(got, want, rtol, atol)
            emit(phase="kernel_vs_plain", batch=batch, L=L, reverse=rev, y_accum=acc,
                 in_dtype=str(inp), out_dtype=str(out), tile=launched_tile(),
                 max_abs_err=err, rtol=rtol, atol=atol, ok=ok)
            if not ok:
                fail(f"kernel disagrees with the plain scan at B={batch} L={L} reverse={rev} "
                     f"y_accum={acc} in={inp} out={out}: max abs err {err}")
            if out == torch.float32:
                worst = max(worst, err)
        # the chunk states the backward kernel reads
        for batch in (1, TRAIN_BATCH):
            for L in PATH_LS + (1000,):
                x, _ = scan_inputs(L, batch=batch)
                for rev in (False, True):
                    _, hchk = fwd(**x, delta_softplus=True, reverse=rev, chunk_states=True)
                    want = fwd_ref_states(x["u"], x["delta"], x["A"], x["B"],
                                          x["delta_bias"], True, rev)
                    torch.cuda.synchronize()
                    err, ok = max_err(hchk, want, *TOLS[torch.float32])
                    emit(phase="kernel_chunk_states", batch=batch, L=L, reverse=rev,
                         tile=launched_tile(), max_abs_err=err, ok=ok)
                    if not ok:
                        fail(f"chunk states disagree at B={batch} L={L} reverse={rev}: {err}")
                    worst = max(worst, err)
        # widths that take each tile of T channels: T divides a group's
        # channels and the batch fills the SMs with one wave of T-channel blocks
        tiles = set()
        for dim, T in ((12, 6), (16, 4), (18, 3), (20, 2), (10, 1)):  # 6, 8, 9, 10, 5 a group
            batch = sms * T // dim
            for rev in (False, True):
                x, yacc = scan_inputs(1000, dim=dim, batch=batch, groups=2)
                kw = dict(delta_softplus=True, reverse=rev, y_accum=yacc)
                got, hchk = fwd(**x, chunk_states=True, **kw)
                torch.cuda.synchronize()
                tile = launched_tile()
                want = scan(**x, backend="chunked", **kw)
                want_h = fwd_ref_states(x["u"], x["delta"], x["A"], x["B"], x["delta_bias"],
                                        True, rev)
                err, ok = max_err(got, want, *TOLS[torch.float32])
                err_h, ok_h = max_err(hchk, want_h, *TOLS[torch.float32])
                reported = tile_of(batch, dim, 2, 16)
                emit(phase="kernel_tiles", batch=batch, dim=dim, groups=2, L=1000, reverse=rev,
                     tile=tile, reported_tile=reported, max_abs_err=err,
                     max_abs_err_chunk_states=err_h, ok=ok and ok_h)
                if not (ok and ok_h) or tile != reported:
                    fail(f"K1 at B={batch} D={dim} G=2 reverse={rev}: tile {tile} (reported "
                         f"{reported}), max abs err {err} (y), {err_h} (chunk states)")
                tiles.add(tile)
                worst = max(worst, err, err_h)
        if tiles != {1, 2, 3, 4, 6}:
            fail(f"the forward kernel's checks took tiles {sorted(tiles)}, not 1, 2, 3, 4, 6")
        timing = {}
        for batch in (1, TRAIN_BATCH):
            states = batch == TRAIN_BATCH  # the train step's forward writes them
            for L in PATH_LS:
                x, yacc = scan_inputs(L, batch=batch)
                for rev, acc in ((False, False), (True, True)):
                    kw = dict(delta_softplus=True, reverse=rev,
                              y_accum=yacc if acc else None, chunk_states=states)
                    base = lambda: kernel_ms(lambda: launch_fwd(baseline, **x, **kw),
                                             "selective_scan_fwd")
                    base_ms = [base()] if baseline else []
                    ms = [kernel_ms(lambda: fwd(**x, **kw), "selective_scan_fwd")
                          for _ in range(2)]
                    base_ms += [base()] if baseline else []
                    plain = time_ms(lambda: scan(**x, backend="chunked", delta_softplus=True,
                                                 reverse=rev, y_accum=kw["y_accum"]),
                                    reps=20 if batch == 1 else 5)
                    b, by = bound(L, clock_mhz, sms, accum=acc, batch=batch,
                                  chunk_states=states)
                    emit(phase="kernel_time", batch=batch, L=L, reverse=rev, y_accum=acc,
                         chunk_states=states, tile=tile_of(batch, 192), ms=ms,
                         baseline_ms=base_ms or None, plain_ms=plain, bound_ms=b, bound_by=by,
                         sfu_exp_ms=batch * sfu_ms(L, clock_mhz, sms))
                    timing[(batch, L, rev)] = (statistics.mean(ms), plain, b, by,
                                               statistics.mean(base_ms) if base_ms else None)
    return worst, timing


def phase_kernel_eval(scan, fwd, tile_of, launched_tile, clock_mhz, sms):
    """K1 vs its plain version at the eval slice's lengths (a 480x640
    forward: 76800, 19200 and 4800, the last not a multiple of the 256-item
    chunk), B = 1 and 2, forward, and reverse with y_accum, fp32, under
    TOLS, and against a second call of itself, bitwise (its sums run in a
    fixed order); then its own time per call there beside the plain scan's
    and the bound."""
    worst, timing = 0.0, {}
    rtol, atol = TOLS[torch.float32]
    with torch.inference_mode():
        for batch in EVAL_BATCHES:
            for L in EVAL_LS:
                x, yacc = scan_inputs(L, batch=batch)
                for rev, acc in ((False, False), (True, True)):
                    kw = dict(delta_softplus=True, reverse=rev, y_accum=yacc if acc else None)
                    got = fwd(**x, **kw)
                    torch.cuda.synchronize()
                    tile = launched_tile()
                    repeat = bool(torch.equal(got, fwd(**x, **kw)))
                    want = scan(**x, backend="chunked", **kw)
                    err, ok = max_err(got, want, rtol, atol)
                    emit(phase="kernel_vs_plain", batch=batch, L=L, reverse=rev, y_accum=acc,
                         in_dtype=str(torch.float32), out_dtype=str(torch.float32), tile=tile,
                         reported_tile=tile_of(batch, 192), max_abs_err=err, rtol=rtol,
                         atol=atol, repeat_bitwise=repeat, ok=ok)
                    if not ok or tile != tile_of(batch, 192) or not repeat:
                        fail(f"K1 at the eval length L={L} B={batch} reverse={rev}: tile {tile}, "
                             f"max abs err {err}, a second call bitwise equal: {repeat}")
                    worst = max(worst, err)
                    del got, want
                    ms = [kernel_ms(lambda: fwd(**x, **kw), "selective_scan_fwd")
                          for _ in range(2)]
                    plain = time_ms(lambda: scan(**x, backend="chunked", **kw), reps=5, warmup=1)
                    b, by = bound(L, clock_mhz, sms, accum=acc, batch=batch)
                    emit(phase="kernel_time", batch=batch, L=L, reverse=rev, y_accum=acc,
                         chunk_states=False, tile=tile, ms=ms, baseline_ms=None,
                         plain_ms=plain, bound_ms=b, bound_by=by,
                         sfu_exp_ms=batch * sfu_ms(L, clock_mhz, sms))
                    timing[(batch, L, rev)] = (statistics.mean(ms), plain, b, by)
                del x, yacc
                torch.cuda.empty_cache()
    return worst, timing


def bwd_vs_plain(scan, L, rev, acc, inp, batch=1, dim=192, groups=1):
    """K2 vs its plain version through the autograd Function (the forward
    kernel with chunk states, then the backward kernel) against the plain
    Function (plain forward, plain adjoint): every gradient's max abs error;
    fails outside GRAD_TOLS."""
    x, dy = scan_inputs(L, dim=dim, dtype=inp, seed=1, batch=batch, groups=groups)
    yacc = torch.randn_like(dy) if acc else None
    grads = []
    for backend in ("cuda", "chunked"):
        leaves = {k: v.clone().requires_grad_() for k, v in x.items()}
        ya = yacc.clone().requires_grad_() if acc else None
        y = scan(**leaves, delta_softplus=True, backend=backend, reverse=rev, y_accum=ya)
        grads.append(torch.autograd.grad(y, list(leaves.values()) + ([ya] if acc else []), dy))
    torch.cuda.synchronize()
    rtol, atol = GRAD_TOLS[inp]
    errs = {}
    for name, g, w in zip(GRAD_NAMES, *grads):
        err, ok = grad_err(g, w, rtol, atol)
        errs[name] = err
        if not ok:
            fail(f"backward kernel: {name} disagrees at B={batch} D={dim} G={groups} L={L} "
                 f"reverse={rev} y_accum={acc} in={inp}: max abs err {err}")
    return errs


def phase_kernel_bwd(scan, fwd, bwd, bwd_ref, tile_of, baseline, clock_mhz, sms):
    """The backward kernel vs its plain version: every gradient, at the
    path's shapes at B = 1 (with and without y_accum) and at the train
    step's B = 4, both directions, fp32 and bf16 in; then at B = 4 with two
    groups, and at widths and batches that take each tile of channels
    (fails unless tiles of 1, 2, 3, 4 and 6 were all taken).
    Then K2's own time at B = 1 and B = 4 vs the plain adjoint's and, when
    ``baseline`` (K2 before the channel tiles) was built, vs its time, in
    turns (baseline, K2, K2, baseline)."""
    from focalnet_tpu_torch.ops.selective_scan_cuda import launch_bwd

    worst = 0.0
    cases = [(1, 192, 1, L, rev, acc, inp) for L in PATH_LS + (1000,) for rev in (False, True)
             for acc in (False, True) for inp in (torch.float32, torch.bfloat16)]
    cases += [(TRAIN_BATCH, 192, 1, L, rev, False, inp) for L in PATH_LS + (1000,)
              for rev in (False, True) for inp in (torch.float32, torch.bfloat16)]
    cases += [(TRAIN_BATCH, 192, 2, 4096, rev, False, inp) for rev in (False, True)
              for inp in (torch.float32, torch.bfloat16)]
    # widths that take each tile of T channels: T divides a group's channels
    # and the batch fills the SMs with one wave of T-channel blocks
    for dim, T in ((12, 6), (16, 4), (18, 3), (20, 2), (10, 1)):  # 6, 8, 9, 10, 5 a group
        cases += [(sms * T // dim, dim, 2, 1000, rev, False, torch.float32)
                  for rev in (False, True)]
    tiles = set()
    for batch, dim, groups, L, rev, acc, inp in cases:
        errs = bwd_vs_plain(scan, L, rev, acc, inp, batch, dim, groups)
        rtol, atol = GRAD_TOLS[inp]
        tile = tile_of(batch, dim, groups, 16, inp)
        tiles.add(tile)
        emit(phase="kernel_bwd_vs_plain", batch=batch, dim=dim, groups=groups, tile=tile,
             L=L, reverse=rev, y_accum=acc, in_dtype=str(inp), max_abs_err=errs,
             rtol=rtol, atol=atol, ok=True)
        if inp == torch.float32:
            worst = max(worst, *errs.values())
    if tiles != {1, 2, 3, 4, 6}:
        fail(f"the backward kernel's checks took tiles {sorted(tiles)}, not 1, 2, 3, 4, 6")
    timing = {}
    with torch.inference_mode():
        for batch in (1, TRAIN_BATCH):
            for L in PATH_LS:
                x, dy = scan_inputs(L, seed=1, batch=batch)
                for rev in (False, True):
                    _, hchk = fwd(**x, delta_softplus=True, reverse=rev, chunk_states=True)
                    args = (*x.values(), dy, hchk, True, rev)
                    k2_ms = lambda lib: kernel_ms(lambda: launch_bwd(lib, *args),
                                                  "selective_scan_bwd")
                    base_ms = [k2_ms(baseline)] if baseline else []
                    ms = [kernel_ms(lambda: bwd(*args), "selective_scan_bwd") for _ in range(2)]
                    base_ms += [k2_ms(baseline)] if baseline else []
                    plain = time_ms(lambda: bwd_ref(*args[:8], True, rev), reps=5, warmup=1)
                    b, by = bound_bwd(L, clock_mhz, sms, batch=batch)
                    emit(phase="kernel_bwd_time", batch=batch, L=L, reverse=rev,
                         tile=tile_of(batch, 192), ms=ms, baseline_ms=base_ms or None,
                         plain_ms=plain, bound_ms=b, bound_by=by,
                         sfu_exp_ms=batch * sfu_ms(L, clock_mhz, sms))
                    timing[(batch, L, rev)] = (statistics.mean(ms), plain, b, by,
                                               statistics.mean(base_ms) if base_ms else None)
    return worst, timing


def phase_forward(name, profile, model, plain, hw, rng, counter, card, smi, reps, plain_reps,
                  expect=LAUNCHES_PER_FORWARD, tol=MODEL_TOL):
    """The whole full-width forward on a batch-1 image of ``hw`` on the
    kernel vs on the plain scan (``plain``; None: the kernel alone): its 3
    outputs under ``tol`` (rtol, atol), ``expect`` K1 launches, whether a
    second forward gives the same bits (reported), ms by CUDA events
    (medians of ``reps`` and ``plain_reps``); then the device profile of 5
    forwards by kind.  Returns the launches."""
    img = rng.integers(0, 256, (1, *hw, 3), dtype=np.uint8)
    x = torch.from_numpy(img).cuda().float() / 255.0
    with torch.inference_mode():
        counter.launches = 0
        got = model(x)
        torch.cuda.synchronize()
        launches = counter.launches
        repeat = all(torch.equal(a, b) for a, b in zip(got, model(x)))
        errs = []
        if plain is not None:
            for i, (g, w) in enumerate(zip(got, plain(x))):
                err, ok = max_err(g, w, *tol)
                errs.append(err)
                if not ok:
                    fail(f"{name}: forward output {i}, kernel vs plain max abs err {err}")
        if launches != expect or not all(bool(torch.isfinite(g).all()) for g in got):
            fail(f"{name}: one forward launched the kernel {launches} times (expected "
                 f"{expect}); outputs finite: {[bool(torch.isfinite(g).all()) for g in got]}")
        del got
        fwd_ms = time_ms(lambda: model(x), reps=reps)
        plain_ms = None
        if plain is not None:
            plain_ms = time_ms(lambda: plain(x), reps=plain_reps,
                               warmup=1 if plain_reps < 20 else 3)
        emit(phase=name, shape=[1, *hw, 3], rtol=tol[0], atol=tol[1],
             max_abs_err=errs or None, launches=launches, repeat_bitwise=repeat, ms=fwd_ms,
             plain_ms=plain_ms,
             card=card, after=smi("clocks.sm,power.draw,temperature.gpu"))
        phase_profile(profile, lambda: model(x), reps=5)
    return launches


def phase_profile(name, fn, reps):
    """Where the device time of ``reps`` calls of ``fn`` goes
    (:func:`focalnet_tpu_torch.utils.profiling.device_profile`)."""
    from focalnet_tpu_torch.utils.profiling import device_profile

    r = device_profile(fn, reps)
    if r is None:
        emit(phase=name, note="torch.profiler recorded no device events")
    else:
        emit(phase=name, **r)


def probe_bound(P, E):
    """Least time (ms) of P FMA passes over E fp32 elements: 8 E bytes moved
    once at the memory rate vs 2 P E fp32 operations at the fp32 rate."""
    t_bytes = 8 * E / PEAK_BYTES_PER_S
    t_ops = 2 * P * E / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def probe_rtol(P):
    """K3's relative error bound against the exact function (the float64
    plain version) at P <= 4096 passes: one fp32 rounding (2^-24) per pass
    of an acc that grows about as x (k + 1), so at most 2^-24 (P/2 + 1),
    times 1.1 for the multipliers' growth (c^(2P) <= 1.07).  One pass missing
    moves the result by about 1/P, one multiplier off by one index by about
    1e-6 P/16: both above it."""
    assert P <= 4096, P
    return 1.1 * 2.0 ** -24 * (P / 2 + 1)


def phase_kernel_probe(fma_cuda, fma_ref):
    """K3 against its fp32 plain version at the check shape, P = 8, 64, 512;
    then on the probe's own input (``vpu_probe.probe_input``, the shape the
    probe path gives it) against the float64 plain version at P = 64, 512,
    4096, and its profiled time there beside the fp32 plain version's and
    the bound."""
    from focalnet_tpu_torch.benchmarks.vpu_probe import probe_input

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(*PROBE_CHECK_SHAPE, generator=g, device="cuda")
    for n_loop in PROBE_CHECK_LOOPS:
        got = fma_cuda(x, n_loop)
        want = fma_ref(x, n_loop)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, PROBE_RTOL, 0.0)
        emit(phase="kernel_probe", shape=list(PROBE_CHECK_SHAPE), passes=8 * n_loop,
             max_abs_err=err, max_abs=float(want.abs().max()), rtol=PROBE_RTOL, ok=ok)
        if not ok:
            fail(f"fma_passes disagrees with its plain version at P={8 * n_loop}: "
                 f"max abs err {err}")
    b, d, l = PROBE_SHAPE["B"], PROBE_SHAPE["D"], PROBE_SHAPE["L"]
    x = probe_input(b, d, l, torch.device("cuda"))
    x64 = x.double()
    worst, timing = 0.0, {}
    for n_loop in PROBE_PATH_LOOPS:
        P = 8 * n_loop
        got = fma_cuda(x, n_loop)
        want = fma_ref(x64, n_loop)
        rtol = probe_rtol(P)
        diff = (got.double() - want).abs()  # in float64: want is not rounded
        ok = bool(torch.isfinite(got).all()) and bool((diff <= rtol * want.abs()).all())
        err = float(diff.max())
        rel = float((diff / want.abs().clamp_min(1e-30)).max())
        emit(phase="kernel_probe_path", shape=[b, 1, d, l], passes=P, max_abs_err=err,
             max_rel_err=rel, max_abs=float(want.abs().max()), rtol=rtol, ok=ok)
        if not ok:
            fail(f"fma_passes disagrees with its float64 plain version on the probe's "
                 f"input at P={P}: max rel err {rel} > {rtol}")
        worst = max(worst, err)
        del got, want, diff
        ms = kernel_ms(lambda: fma_cuda(x, n_loop), "fma_passes")
        plain = time_ms(lambda: fma_ref(x, n_loop), reps=3, warmup=1)
        bnd, by = probe_bound(P, x.numel())
        emit(phase="kernel_probe_time", shape=[b, 1, d, l], passes=P, ms=ms, plain_ms=plain,
             bound_ms=bnd, bound_by=by, tflops=2 * P * x.numel() / (ms * 1e-3) / 1e12)
        timing[P] = (ms, plain, bnd, by)
    return worst, timing


def phase_vpu_probe(counters, fma_cuda, bwd, fwd, peak_tflops):
    """The probe through its CLI (the JAX pair of n_loop) and its function
    at n_loop (64, 512), with K1 and K3 launch counts over both; then K2's
    pass-equivalents at the probe's shape.  Fails unless both measured
    rates are positive and the (64, 512) one is at most 5% above the SMs'
    FMA peak (a folded chain would show far above it); the JAX pair's P = 64
    point is bytes-bound, which overstates its rate by a few percent."""
    from focalnet_tpu_torch.benchmarks import vpu_probe

    for c in counters:
        c.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_pair = vpu_probe.main([])
    lines = buf.getvalue().splitlines()
    with contextlib.redirect_stdout(io.StringIO()):
        wide = vpu_probe.run_probe(**PROBE_SHAPE, loops=PROBE_PATH_LOOPS[1:])
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    if not launches[fma_cuda.__name__] or not launches["selective_scan_cuda"]:
        fail(f"the probe did not launch K3 and K1: {launches}")

    # K2 at the probe's shape, softplus, no D, no bias, in the same harness
    b, d, l, n = (PROBE_SHAPE[k] for k in ("B", "D", "L", "N"))
    g = torch.Generator(device="cuda").manual_seed(2)
    r = lambda *s: torch.rand(*s, generator=g, device="cuda")
    u, dl, A, Bm, Cm = r(b, d, l), 0.1 * r(b, d, l), -torch.exp(r(d, n)), r(b, 1, n, l), r(b, 1, n, l)
    dy = r(b, d, l)
    with torch.inference_mode():
        _, hchk = fwd(u, dl, A, Bm, Cm, delta_softplus=True, chunk_states=True)
        t_bwd = vpu_probe.device_ms(
            lambda: bwd(u, dl, A, Bm, Cm, None, None, dy, hchk, True, False),
            "selective_scan_bwd", torch.device("cuda"), per_call=1)
    per_pass = (wide["probe_ms"][1] - wide["probe_ms"][0]) / (wide["passes"][1] - wide["passes"][0])
    emit(phase="vpu_probe", lines=lines, jax_pair=jax_pair, wide=wide,
         scan_bwd_device_ms=t_bwd, scan_bwd_pass_equivalents=t_bwd / per_pass,
         peak_fma_tflops=peak_tflops, launches=launches)
    if not jax_pair["probe_fma_tflops"] > 0:
        fail(f"probe, JAX pair: {jax_pair['probe_fma_tflops']} TFLOP/s")
    if not 0 < wide["probe_fma_tflops"] <= 1.05 * peak_tflops:
        fail(f"probe (64, 512): {wide['probe_fma_tflops']} TFLOP/s is not in "
             f"(0, 1.05 x {peak_tflops}]")
    return launches, jax_pair, wide


def smooth_loss(preds, label):
    """The mean squared error of the three outputs against the label at their
    scales.  The gradients are held kernel against plain on this loss, not
    on the train loss: the train loss's L1 terms take the sign of pred -
    label, so an fp32 difference of the outputs flips a few of those signs
    by chance, and the gradients then differ as much between two plain
    versions (the chunked scan at chunks of 64 and of 128, 1mlp_g4: 1.04x
    the limit) as between kernel and plain."""
    from focalnet_tpu_torch.train.losses import bilinear_down

    labels = [bilinear_down(label, 4), bilinear_down(label, 2), label]
    return sum(((p - t) ** 2).mean() for p, t in zip(preds, labels))


def phase_grad(build_net, counters, card, preset="1mlp_g2", name="grad_256",
               profile="profile_train_step", tol=MODEL_GRAD_TOL, scaled=False, plain_reps=3,
               timed=True, **overrides):
    """One backward of the full-width ``preset`` (with config ``overrides``) at
    batch 4, 256x256, on the kernels vs on the plain scans (per-parameter
    gradients of :func:`smooth_loss`, max |got - want| <= rel max |want| +
    abs, abs times the
    largest |gradient| of the plain run when ``scaled``; launch counts),
    then ms per train step (loss, backward, clip, Adam) of each (the plain
    one ``plain_reps`` times; not at 0), and a profile of the kernels' train
    step (neither without ``timed``).  Returns the kernels' ms per step."""
    from focalnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    gen = torch.Generator().manual_seed(4321)
    x = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=gen).cuda()
    gt = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=gen).cuda()
    models, grads = [], []
    expect = PRESET_LAUNCHES[preset]
    for backend in ("cuda", "chunked"):
        model = build_net(preset, device="cuda", drop_path_rate=0.0, scan_backend=backend,
                          generator=torch.Generator().manual_seed(1234), **overrides).train()
        for c in counters:
            c.launches = 0
        smooth_loss(model(x), gt).backward()
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        if launches != ([expect] * 2 if backend == "cuda" else [0, 0]):
            fail(f"{name} on {backend}: one train backward launched {launches} (K1, K2)")
        models.append(model)
        grads.append({k: p.grad for k, p in model.named_parameters()})
        if backend == "cuda":
            k_launches = launches
    worst, worst_key, max_abs = 0.0, None, 0.0
    rel, ab = tol
    scale = max(float(w.abs().max()) for w in grads[1].values()) if scaled else 1.0
    for k, w in grads[1].items():
        err = float((grads[0][k] - w).abs().max())
        lim = rel * float(w.abs().max()) + ab * scale
        if not (err <= lim and bool(torch.isfinite(grads[0][k]).all())):
            fail(f"{name}: whole-model gradient of {k}: kernel vs plain max abs err {err} > {lim}")
        max_abs = max(max_abs, err)
        if err / lim > worst:
            worst, worst_key = err / lim, k
    steps = [make_train_step(m, make_optimizer(m)) for m in models]
    ms = time_ms(lambda: steps[0](x, gt), reps=10, warmup=3) if timed else None
    plain_ms = time_ms(lambda: steps[1](x, gt), reps=plain_reps, warmup=1) if plain_reps else None
    emit(phase=name, preset=preset, overrides=overrides, batch=TRAIN_BATCH,
         params=len(grads[0]), max_abs_err=max_abs, max_err_over_limit=worst,
         worst_param=worst_key, tol_rel=rel, tol_abs=ab, tol_abs_scale=scale,
         launches_fwd=k_launches[0], launches_bwd=k_launches[1],
         train_step_ms=ms, plain_train_step_ms=plain_ms, card=card,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del models, grads, steps
    torch.cuda.empty_cache()
    if not timed:
        return ms
    model = build_net(preset, device="cuda", generator=torch.Generator().manual_seed(1234),
                      **overrides).train()
    from focalnet_tpu_torch.models import set_dropout_generator

    set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, make_optimizer(model))
    phase_profile(profile, lambda: step(x, gt), reps=3)
    del model, step
    torch.cuda.empty_cache()
    return ms


def phase_train_cli(cli_main, counters, tmp):
    """``--mode train`` through the CLI at full width: 2 epochs of a synthetic
    8-pair dataset (2 steps an epoch at batch 4, validation on 2 images
    every epoch), then ``--resume`` for a third.  Launch counts: 48 of each
    kernel per step, 48 forward launches per validated image."""
    from focalnet_tpu_torch.data.reside import make_synthetic_dataset
    from focalnet_tpu_torch.utils.convert import load_checkpoint

    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "weights")
    make_synthetic_dataset(data, n_train=4, n_test=1, hw=(256, 256), seed=0)
    common = ["--mode", "train", "--mesh_shape", "1", "--data_dir", data,
              "--batch_size", str(TRAIN_BATCH), "--crop_size", "256", "--print_freq", "1",
              "--save_freq", "1",
              "--valid_freq", "1", "--num_worker", "4", "--model_save_dir", out,
              "--result_dir", os.path.join(tmp, "train_images")]
    runs = []
    for epochs, extra in ((2, []), (3, ["--resume", os.path.join(out, "model.pkl")])):
        for c in counters:
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_main(common + ["--num_epoch", str(epochs)] + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [c.launches for c in counters]
        n_epochs = epochs - (2 if extra else 0)
        steps, val_images = 2 * n_epochs, 2 * n_epochs
        expected = [LAUNCHES_PER_FORWARD * (steps + val_images), LAUNCHES_PER_FORWARD * steps]
        log = buf.getvalue()
        rolling = load_checkpoint(os.path.join(out, "model.pkl"), full=True)
        emit(phase="train_cli", num_epoch=epochs, resume=bool(extra), seconds=seconds,
             launches_fwd=launches[0], launches_bwd=launches[1],
             expected_launches=expected, rolling_epoch=rolling["epoch"],
             log_tail=log.strip().splitlines()[-4:])
        if launches != expected:
            fail(f"train run: launches (K1, K2) {launches}, expected {expected}")
        if rolling["epoch"] != epochs:
            fail(f"rolling checkpoint at epoch {rolling['epoch']}, expected {epochs}")
        if extra and "Resume from 2" not in log:
            fail("the resumed run did not report 'Resume from 2'")
        if f"EPOCH: {epochs:02d}" not in log:
            fail(f"no 'EPOCH: {epochs:02d}' line in the train log")
        runs.append(launches)
    names = ["model", "model_1", "model_2", "model_3", "Best", "Final"]
    missing = [n for n in names if not os.path.exists(os.path.join(out, f"{n}.pkl"))]
    if missing:
        fail(f"checkpoints missing: {missing}")
    with open(os.path.join(out, "train.metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [(r["pixel_loss"], r["fft_loss"]) for r in rows if "step" in r]
    if len(losses) != 6 or not all(math.isfinite(v) for r in losses for v in r):
        fail(f"train losses: {losses}")
    # the log scraper on train.log: a PSNR point per validated epoch (all
    # three, the resumed one appended) and a loss record per printed step
    from focalnet_tpu_torch.utils.plot_logs import parse_log

    curves = parse_log(os.path.join(out, "train.log"))
    emit(phase="train_cli_result", steps=len(losses), losses=losses,
         psnr=[r["psnr"] for r in rows if "psnr" in r], checkpoints=names,
         log_psnr=curves["psnr"], log_loss_records=len(curves["content"]))
    if [e for e, _ in curves["psnr"]] != [1.0, 2.0, 3.0]:
        fail(f"parse_log found PSNR points {curves['psnr']}, want epochs 1, 2, 3")
    if len(curves["content"]) != len(losses) or len(curves["fft"]) != len(losses):
        fail(f"parse_log found {len(curves['content'])} loss records, want {len(losses)}")
    return runs[0]


def _png_variant(samples, depth, ctype, interlace=0, chunks=()):
    """PNG bytes of (h, w, ch) ``samples`` at ``depth`` (16: big-endian;
    below 8: packed), every filter in turn, Adam7 where ``interlace``."""
    import struct
    import zlib

    from focalnet_tpu_torch.data.png import _filter_rows

    def rows(sub):
        h, w, ch = sub.shape
        if depth == 16:
            img = sub.astype(">u2").view(np.uint8).reshape(h, w, 2 * ch)
        elif depth == 8:
            img = sub.astype(np.uint8)
        else:
            bits = np.unpackbits(sub.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
            img = np.packbits(bits.reshape(h, -1), axis=1)[..., None]
        return _filter_rows(img, (0, 1, 2, 3, 4)).tobytes()

    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
              (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),)
    raw = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                   if samples[y0::dy, x0::dx].size)
    h, w = samples.shape[:2]
    body = [(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)), *chunks,
            (b"IDAT", zlib.compress(raw, 1)), (b"IEND", b"")]
    return b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(b)) + k + b + struct.pack(">I", zlib.crc32(k + b)) for k, b in body)


def phase_loader(tmp, card):
    """The native loader (``data/csrc/loader.cpp``) against its plain
    versions on a synthetic RESIDE-ITS split at 460x620 (every PNG row
    filter in turn) and on one PNG each of palette (with tRNS), 16-bit RGB,
    gray+alpha and Adam7 at that size: decode and u8 decode bit for bit
    against the numpy codec, ``load_pair_batch`` at batch 4, crop 256 and 1,
    4, 8 threads against ``load_pair_batch_ref``, the encoder's round trip.
    Then times on the card's host: ms per decode (native against numpy; all
    rows Paeth, and the split's mixed rows), per batch-4 pair batch by
    threads, per encode, and ``TrainLoader``'s batches a second over an
    epoch, each backend alone.  Returns the split's root and the times."""
    from focalnet_tpu_torch.data import native_loader as nl
    from focalnet_tpu_torch.data.png import read_png, to_rgb, write_png
    from focalnet_tpu_torch.data.reside import TrainLoader, make_synthetic_dataset

    t0 = time.perf_counter()
    root = make_synthetic_dataset(os.path.join(tmp, "its"), n_train=ITS_TRAIN,
                                  n_test=ITS_TEST, hw=ITS_HW, seed=0)
    write_s = time.perf_counter() - t0
    rng = np.random.default_rng(13)
    h, w = ITS_HW
    plte = rng.integers(0, 256, (256, 3), dtype=np.uint8).tobytes()
    variants = {
        "palette8_trns": _png_variant(rng.integers(0, 256, (h, w, 1)), 8, 3,
                                      chunks=[(b"PLTE", plte), (b"tRNS", bytes(range(0, 256, 2)))]),
        "rgb16": _png_variant(rng.integers(0, 65536, (h, w, 3)), 16, 2),
        "gray_alpha": _png_variant(rng.integers(0, 256, (h, w, 2)), 8, 4),
        "rgb8_adam7": _png_variant(rng.integers(0, 256, (h, w, 3)), 8, 2, interlace=1),
    }
    vdir = os.path.join(tmp, "png_variants")
    os.makedirs(vdir, exist_ok=True)
    files = []
    for name, data in variants.items():
        files.append(os.path.join(vdir, name + ".png"))
        with open(files[-1], "wb") as f:
            f.write(data)
    for split in ("train", "test"):
        for sub in ("hazy", "gt"):
            d = os.path.join(root, split, sub)
            files += [os.path.join(d, n) for n in sorted(os.listdir(d))]
    # decode, u8 decode: bit for bit against the numpy codec
    plain = {}
    for path in files:
        plain[path] = to_rgb(read_png(path))
        got_u8, got = nl.decode_image_u8(path), nl.decode_image(path)
        if not (np.array_equal(got_u8, plain[path])
                and np.array_equal(got, plain[path].astype(np.float32) / 255.0)):
            fail(f"loader: native decode of {path} differs from the numpy codec's")
    # pair batches: 4 pairs, crop 256, seeds as TrainLoader draws them
    tdir = os.path.join(root, "train")
    names = sorted(os.listdir(os.path.join(tdir, "hazy")))[:TRAIN_BATCH]
    hazy = [os.path.join(tdir, "hazy", n) for n in names]
    gt = [os.path.join(tdir, "gt", n.split("_")[0] + ".png") for n in names]
    seeds = np.random.default_rng(1234).integers(0, 2**31, TRAIN_BATCH).astype(np.uint64)
    want = nl.load_pair_batch_ref(hazy, gt, 256, seeds)
    for threads in LOADER_THREADS:
        got = nl.load_pair_batch(hazy, gt, 256, seeds, threads)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"loader: load_pair_batch at {threads} threads differs from load_pair_batch_ref")
    # the encoder's round trip, through the numpy codec
    enc = os.path.join(tmp, "encoded.png")
    img = plain[files[-1]]
    nl.encode_png(enc, img)
    if not np.array_equal(read_png(enc), img):
        fail("loader: the native PNG encoder's round trip differs")

    def host_ms(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    paeth = os.path.join(tmp, "paeth.png")
    write_png(paeth, img, filters=(4,))
    mixed = hazy[0]
    decode_ms = {}
    for name, path in (("paeth", paeth), ("mixed", mixed)):
        decode_ms[name] = dict(native=host_ms(lambda: nl.decode_image(path), 20),
                               numpy=host_ms(lambda: read_png(path), 3))
    batch_ms = {t: host_ms(lambda t=t: nl.load_pair_batch(hazy, gt, 256, seeds, t), 10)
                for t in LOADER_THREADS}
    encode_ms = host_ms(lambda: nl.encode_png(enc, img), 10)
    epoch = {}
    for backend in ("native", "numpy"):
        loader = TrainLoader(root, TRAIN_BATCH, crop=256, seed=1234, backend=backend)
        t = time.perf_counter()
        n = sum(1 for _ in loader.epoch())
        secs = time.perf_counter() - t
        epoch[backend] = dict(batches=n, seconds=secs, batches_per_s=n / secs)
        if n != ITS_TRAIN * 2 // TRAIN_BATCH:
            fail(f"loader: TrainLoader({backend!r}) gave {n} batches an epoch")
    emit(phase="loader", build=nl.build_info(), hw=list(ITS_HW), files=len(files),
         variants=sorted(variants), write_split_s=write_s, decode_ms=decode_ms,
         pair_batch_ms_by_threads=batch_ms, encode_ms=encode_ms,
         train_loader_epoch=epoch, host_cpus=os.cpu_count(), card=card)
    return root, dict(decode_ms=decode_ms, batch_ms=batch_ms, epoch=epoch)


def phase_train_its_cli(cli_main, counters, root, tmp, step_ms, card):
    """``--mode train`` through the CLI for one epoch of the synthetic
    RESIDE-ITS split at 460x620 (4 steps at batch 4, crop 256; 2 images
    validated) through the native loader: 48 K1 launches a step and a
    validated image, 48 K2 a step; 4 pair batches and 4 decodes; finite
    losses; the run's seconds beside ``grad_256``'s step by events."""
    from focalnet_tpu_torch.data import native_loader as nl

    out = os.path.join(tmp, "its_weights")
    for c in counters:
        c.launches = 0
    nl.load_pair_batch.batches = nl.decode_image.images = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(["--mode", "train", "--mesh_shape", "1", "--data_dir", root,
                  "--batch_size", str(TRAIN_BATCH), "--crop_size", "256", "--num_epoch", "1",
                  "--valid_freq", "1", "--print_freq", "1", "--model_save_dir", out,
                  "--result_dir", os.path.join(tmp, "its_images")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    steps, val_images = ITS_TRAIN * 2 // TRAIN_BATCH, ITS_TEST * 2
    expected = [LAUNCHES_PER_FORWARD * (steps + val_images), LAUNCHES_PER_FORWARD * steps]
    with open(os.path.join(out, "train.metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [(r["pixel_loss"], r["fft_loss"]) for r in rows if "step" in r]
    loader = dict(pair_batches=nl.load_pair_batch.batches, decodes=nl.decode_image.images)
    emit(phase="train_its_cli", hw=list(ITS_HW), steps=len(losses), seconds=seconds,
         step_ms_by_events_grad_256=step_ms, launches_fwd=launches[0],
         launches_bwd=launches[1], expected_launches=expected, loader=loader, losses=losses,
         psnr=[r["psnr"] for r in rows if "psnr" in r], card=card)
    if launches != expected:
        fail(f"train_its_cli: launches (K1, K2) {launches}, expected {expected}")
    if loader != dict(pair_batches=steps, decodes=2 * val_images):
        fail(f"train_its_cli: the native loader made {loader}, expected {steps} pair "
             f"batches and {2 * val_images} decodes")
    if len(losses) != steps or not all(math.isfinite(v) for r in losses for v in r):
        fail(f"train_its_cli: losses {losses}")
    print(f"--mode train, 1 epoch at {ITS_HW[0]}x{ITS_HW[1]} through the native loader: "
          f"{seconds:.3f} s ({steps} steps, {val_images} validated images); a step "
          f"{step_ms:.3f} ms by events (grad_256); {card}", flush=True)
    return launches


def _eval_lines(text):
    """--mode test's per-image (PSNR_dehazing, ssim) pairs and its three
    summary lines, in the reference eval.py's formats."""
    per_image = [(float(a), float(b)) for a, b in
                 re.findall(r"^\d+ iter PSNR_dehazing: (\d+\.\d{2}) ssim: (\d+\.\d{6})$",
                            text, re.M)]
    summary = re.findall(r"^(The average PSNR is \d+\.\d{2} dB|The average SSIM is "
                         r"\d+\.\d{5} dB|Average time: \d+\.\d{6})$", text, re.M)
    return per_image, summary


def phase_test_cli(cli_main, counters, tmp, ckpt, card):
    """``--mode test --save_image`` through the CLI at full width on a
    synthetic SOTS-indoor-sized test split (3 GTs, 2 hazy images each, at
    460x620), on the kernel and then on the plain scan (``--scan_backend
    chunked``): per-image PSNR within 0.01 dB, SSIM within 1e-4 (as
    printed), saved PNGs within 1 LSB; 48 K1 launches per image, none of K2.
    Returns the kernel run's time per image, K1 launches and per-image
    (PSNR, SSIM)."""
    from focalnet_tpu_torch.data.png import read_png
    from focalnet_tpu_torch.data.reside import make_synthetic_dataset

    data = make_synthetic_dataset(os.path.join(tmp, "sots"), n_train=2, n_test=3,
                                  hw=SOTS_HW, seed=0)
    n_images = len(os.listdir(os.path.join(data, "test", "hazy")))
    runs = {}
    for backend in ("cuda", "chunked"):
        res_dir = os.path.join(tmp, f"test_{backend}")
        for c in counters:
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = cli_main(["--mode", "test", "--save_image", "--data_dir", data,
                               "--test_model", ckpt, "--result_dir", res_dir,
                               "--model_save_dir", os.path.join(tmp, "test_cfg"),
                               "--scan_backend", backend])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [c.launches for c in counters]
        per_image, summary = _eval_lines(buf.getvalue())
        expected = [LAUNCHES_PER_FORWARD * n_images, 0] if backend == "cuda" else [0, 0]
        emit(phase="test_cli", backend=backend, images=n_images, per_image=per_image,
             summary=summary, result=result, seconds=seconds, launches_fwd=launches[0],
             launches_bwd=launches[1], expected_launches=expected, card=card)
        if launches != expected:
            fail(f"--mode test on {backend}: launches (K1, K2) {launches}, expected {expected}")
        if len(per_image) != n_images or len(summary) != 3:
            fail(f"--mode test on {backend} printed {len(per_image)} per-image lines and "
                 f"summary {summary}: want {n_images} and the three summary lines")
        if not all(math.isfinite(v) for v in result.values()):
            fail(f"--mode test on {backend}: {result}")
        names = sorted(os.listdir(res_dir))
        if names != sorted(os.listdir(os.path.join(data, "test", "hazy"))):
            fail(f"--mode test on {backend} saved {names}")
        runs[backend] = (per_image, result, res_dir, names, launches[0])
    (k_img, k_res, k_dir, names, k_launches), (p_img, p_res, p_dir, _, _) = (
        runs["cuda"], runs["chunked"])
    d_psnr = max(abs(a[0] - b[0]) for a, b in zip(k_img, p_img))
    d_ssim = max(abs(a[1] - b[1]) for a, b in zip(k_img, p_img))
    d_png = max(int(np.abs(read_png(os.path.join(k_dir, n)).astype(int)
                           - read_png(os.path.join(p_dir, n)).astype(int)).max())
                for n in names)
    emit(phase="test_cli_vs_plain", max_psnr_diff_db=d_psnr, max_ssim_diff=d_ssim,
         max_png_diff_lsb=d_png, psnr=[k_res["psnr"], p_res["psnr"]],
         ssim=[k_res["ssim"], p_res["ssim"]], average_time_s=k_res["time"],
         plain_average_time_s=p_res["time"], card=card)
    # printed to 2 decimals: a true difference below 0.005 dB shows as at most 0.01
    if not (d_psnr <= 0.01 + 1e-9 and d_ssim <= 1e-4 + 1e-12 and d_png <= 1
            and abs(k_res["psnr"] - p_res["psnr"]) <= 0.01
            and abs(k_res["ssim"] - p_res["ssim"]) <= 1e-4):
        fail(f"--mode test, kernel vs plain: PSNR {d_psnr} dB, SSIM {d_ssim}, PNG {d_png} LSB")
    print(f"--mode test at {SOTS_HW[0]}x{SOTS_HW[1]}: Average time: {k_res['time']:.6f} s "
          f"(kernel), {p_res['time']:.6f} s (plain scan); {card}", flush=True)
    return k_res["time"], k_launches, k_img


def _tile_forwards(hw, tile=256, overlap=32, batch=4):
    """Forwards of ``--tile`` inference on an image of ``hw`` (padded up to
    the tile where smaller): its tiles, ``batch`` per forward."""
    from focalnet_tpu_torch.evaluation.infer import _tile_starts

    h, w = max(hw[0], tile), max(hw[1], tile)
    n = len(_tile_starts(h, tile, tile - overlap)) * len(_tile_starts(w, tile, tile - overlap))
    return -(-n // batch)


def phase_infer_cli(cli_main, counters, tmp, ckpt, rng):
    """``--mode infer`` through the CLI at full width on a directory of five
    PNGs (two 460x620, two 256x256, one 250x310) at ``--valid_batch`` 1 and
    2, at 1 again (is a second run bitwise equal?) and at ``--tile 256
    --valid_batch 4``, with K1 launch counts (48 per
    forward; batch 2 makes one forward per padded shape, three here); batch
    2 against batch 1 and batch 1 against ``--mode serve`` for the same
    files, within 1 LSB.  Returns the batch-1 run's K1 launches."""
    from focalnet_tpu_torch.data.png import read_png, write_png

    sizes = INFER_SIZES
    src = os.path.join(tmp, "infer_in")
    os.makedirs(src)
    for i, (h, w) in enumerate(sizes):
        write_png(os.path.join(src, f"img{i}_{h}x{w}.png"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    names = sorted(os.listdir(src))
    hw = {f"img{i}_{h}x{w}.png": (h, w) for i, (h, w) in enumerate(sizes)}
    runs = {}
    for mode, extra, forwards in (
        ("batch1", ["--valid_batch", "1"], len(sizes)),
        ("batch2", ["--valid_batch", "2"], 3),
        ("batch1_again", ["--valid_batch", "1"], len(sizes)),
        ("tile_256", ["--tile", "256", "--valid_batch", "4"],
         sum(_tile_forwards(s) for s in sizes)),
    ):
        out_dir = os.path.join(tmp, f"infer_{mode}")
        for c in counters:
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = cli_main(["--mode", "infer", "--input", src, "--test_model", ckpt,
                               "--result_dir", out_dir,
                               "--model_save_dir", os.path.join(tmp, "infer_cfg")] + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [c.launches for c in counters]
        expected = [LAUNCHES_PER_FORWARD * forwards, 0]
        emit(phase="infer_cli", mode=mode, images=len(sizes), result=result,
             printed=buf.getvalue().strip().splitlines()[-1:], seconds=seconds,
             launches_fwd=launches[0], launches_bwd=launches[1], expected_launches=expected)
        if launches != expected:
            fail(f"--mode infer {mode}: launches (K1, K2) {launches}, expected {expected}")
        if sorted(os.listdir(out_dir)) != names:
            fail(f"--mode infer {mode} wrote {sorted(os.listdir(out_dir))}, want {names}")
        imgs = {n: read_png(os.path.join(out_dir, n)) for n in names}
        for n, img in imgs.items():
            if img.shape != (*hw[n], 3):
                fail(f"--mode infer {mode}: {n} has shape {img.shape}, want {(*hw[n], 3)}")
        runs[mode] = (imgs, launches[0])

    # the same files through --mode serve, whole image
    serve_dir = os.path.join(tmp, "infer_serve")
    for c in counters:
        c.launches = 0
    _, launches, _, expected = serve_run(cli_main, ckpt, [(os.path.join(src, n), hw[n])
                                                          for n in names],
                                         serve_dir, [], counters[0], len(names))
    if launches != expected:
        fail(f"--mode serve on the infer inputs: {launches} K1 launches, expected {expected}")
    served = {n: read_png(os.path.join(serve_dir, n)) for n in names}

    def lsb(a, b):
        return max(int(np.abs(a[n].astype(int) - b[n].astype(int)).max()) for n in names)

    def bitwise(a, b):
        return all(np.array_equal(a[n], b[n]) for n in names)

    b1, b2 = runs["batch1"][0], runs["batch2"][0]
    d_b2, d_serve = lsb(b2, b1), lsb(b1, served)
    emit(phase="infer_cli_vs", batch2_vs_batch1_lsb=d_b2, batch2_bitwise=bitwise(b2, b1),
         batch1_vs_serve_lsb=d_serve, serve_bitwise=bitwise(b1, served),
         batch1_again_bitwise=bitwise(runs["batch1_again"][0], b1))
    if d_b2 > 1 or d_serve > 1:
        fail(f"--mode infer: batch 2 vs batch 1 {d_b2} LSB, batch 1 vs serve {d_serve} LSB")
    return runs["batch1"][1]


def phase_kernel_new_lengths(scan, fwd, bwd, bwd_ref, fwd_ref_states, tile_of, launched_tile,
                             clock_mhz, sms):
    """K1 at the other presets' new lengths, L = 256 (B = 1, and the train
    step's B = 4 with chunk states) and L = 1200 (B = 1), forward, and
    reverse with y_accum, fp32, against its plain version (and its chunk
    states against chunk_states_ref), timed beside the plain scan and the
    bound; K2 at L = 256, B = 4, against the plain adjoint, timed.  Then both
    with the bf16 recipe's operands at the 256x256 lengths (bf16 u, delta,
    B, C; K1 bf16 out and y_accum, B = 1 and 4 with chunk states; K2 bf16 dy,
    B = 4; also against the plain adjoint with that dy), against their plain
    versions under TOLS / GRAD_TOLS, timed
    against the bound with 2-byte operands.  Returns the worst fp32 errors of
    K1 and K2 and the timings."""
    timing, worst, worst_bwd = {}, 0.0, 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(1, 256, f32), (TRAIN_BATCH, 256, f32), (1, 1200, f32)]
    cases += [(b, L, bf16) for b in (1, TRAIN_BATCH) for L in PATH_LS]
    with torch.inference_mode():
        for batch, L, dt in cases:
            states = batch == TRAIN_BATCH
            x, yacc = scan_inputs(L, dtype=dt, batch=batch)
            for rev, acc in ((False, False), (True, True)):
                kw = dict(delta_softplus=True, reverse=rev, out_dtype=dt,
                          y_accum=yacc.to(dt) if acc else None)
                got, hchk = fwd(**x, chunk_states=True, **kw)
                torch.cuda.synchronize()
                tile = launched_tile()
                want = scan(**x, backend="chunked", **kw)
                rtol, atol = TOLS[dt]
                err, ok = max_err(got, want, rtol, atol)
                want_h = fwd_ref_states(x["u"], x["delta"], x["A"], x["B"], x["delta_bias"],
                                        True, rev)
                err_h, ok_h = max_err(hchk, want_h, *TOLS[f32])
                reported = tile_of(batch, 192, 1, 16, dt, dt)
                emit(phase="kernel_new_lengths", kernel="fwd", batch=batch, L=L, reverse=rev,
                     y_accum=acc, dtype=str(dt), tile=tile, reported_tile=reported,
                     max_abs_err=err, max_abs_err_chunk_states=err_h, rtol=rtol, atol=atol,
                     ok=ok and ok_h)
                if not (ok and ok_h) or tile != reported:
                    fail(f"K1 at B={batch} L={L} reverse={rev} {dt}: tile {tile} (reported "
                         f"{reported}), max abs err {err} (y), {err_h} (chunk states)")
                if dt == f32:
                    worst = max(worst, err, err_h)
                del got, want, hchk, want_h
                ms = [kernel_ms(lambda: fwd(**x, chunk_states=states, **kw),
                                "selective_scan_fwd") for _ in range(2)]
                plain = time_ms(lambda: scan(**x, backend="chunked", **kw), reps=5, warmup=1)
                nb = 2 if dt == bf16 else 4
                b, by = bound(L, clock_mhz, sms, in_bytes=nb, out_bytes=nb, accum=acc,
                              batch=batch, chunk_states=states)
                emit(phase="kernel_time", batch=batch, L=L, reverse=rev, y_accum=acc,
                     chunk_states=states, dtype=str(dt), tile=tile, ms=ms, baseline_ms=None,
                     plain_ms=plain, bound_ms=b, bound_by=by,
                     sfu_exp_ms=batch * sfu_ms(L, clock_mhz, sms))
                timing[("fwd", batch, L, rev, str(dt))] = (statistics.mean(ms), plain, b, by)
    for L, dt in [(256, f32)] + [(L, bf16) for L in PATH_LS]:
        for rev in (False, True):
            errs = bwd_vs_plain(scan, L, rev, False, dt, TRAIN_BATCH)
            rtol, atol = GRAD_TOLS[dt]
            emit(phase="kernel_new_lengths", kernel="bwd", batch=TRAIN_BATCH, L=L, reverse=rev,
                 dtype=str(dt), tile=tile_of(TRAIN_BATCH, 192, 1, 16, dt),
                 max_abs_err=errs, rtol=rtol, atol=atol, ok=True)
            if dt == f32:
                worst_bwd = max(worst_bwd, *errs.values())
            with torch.inference_mode():
                x, dy = scan_inputs(L, dtype=dt, seed=1, batch=TRAIN_BATCH)
                dy = dy.to(dt)  # the recipe's dy is bf16: its y is
                _, hchk = fwd(**x, delta_softplus=True, reverse=rev, chunk_states=True)
                args = (*x.values(), dy, hchk, True, rev)
                if dt == bf16:  # with the bf16 dy, against the plain adjoint
                    for name, g, w in zip(GRAD_NAMES, bwd(*args), bwd_ref(*args[:8], True, rev)):
                        err, ok = grad_err(g, w, *GRAD_TOLS[dt])
                        if not ok:
                            fail(f"K2 with bf16 dy at L={L} reverse={rev}: {name} max abs "
                                 f"err {err}")
                ms = [kernel_ms(lambda: bwd(*args), "selective_scan_bwd") for _ in range(2)]
                plain = time_ms(lambda: bwd_ref(*args[:8], True, rev), reps=3, warmup=1)
                b, by = bound_bwd(L, clock_mhz, sms, in_bytes=2 if dt == bf16 else 4,
                                  batch=TRAIN_BATCH)
                emit(phase="kernel_bwd_time", batch=TRAIN_BATCH, L=L, reverse=rev,
                     dtype=str(dt), tile=tile_of(TRAIN_BATCH, 192, 1, 16, dt), ms=ms,
                     baseline_ms=None, plain_ms=plain, bound_ms=b, bound_by=by,
                     sfu_exp_ms=TRAIN_BATCH * sfu_ms(L, clock_mhz, sms))
                timing[("bwd", TRAIN_BATCH, L, rev, str(dt))] = (statistics.mean(ms), plain, b,
                                                                 by)
    return worst, worst_bwd, timing


def phase_presets(build_net, counters, card, smi, rng):
    """The other three presets at full width, random weights from seed 1234:
    the 256x256 batch-1 forward on the kernel vs the plain scan (MODEL_TOL,
    0 / 96 / 48 K1 launches, ms by events, device ms by kind), the 480x640
    forward on the kernel alone (launches, device ms by kind), and for the
    scanning presets the batch-4 train step's gradients, kernel vs plain,
    with launch counts.  Returns {preset: K1 launches per 256x256 forward}."""
    launches = {}
    for preset in OTHER_PRESETS:
        model = build_net(preset, device="cuda", generator=torch.Generator().manual_seed(1234))
        plain = build_net(preset, device="cuda", scan_backend="chunked")
        plain.load_state_dict(model.state_dict(), strict=True)
        expect = PRESET_LAUNCHES[preset]
        launches[preset] = phase_forward(
            f"forward_256_{preset}", f"profile_{preset}", model, plain, (256, 256), rng,
            counters[0], card, smi, reps=20, plain_reps=5, expect=expect)
        del plain
        phase_forward(f"forward_640_{preset}", f"profile_640_{preset}", model, None,
                      (480, 640), rng, counters[0], card, smi, reps=10, plain_reps=0,
                      expect=expect)
        del model
        torch.cuda.empty_cache()
        if expect:
            phase_grad(build_net, counters, card, preset=preset, name=f"grad_256_{preset}",
                       profile=f"profile_train_step_{preset}", plain_reps=0)
    return launches


def phase_preset_cli(cli_main, counters, tmp):
    """``--mode test --preset baseline`` on the synthetic SOTS-sized split of
    ``phase_test_cli`` (no K1, no K2) and ``--mode infer --preset 1mlp`` on
    the PNGs of ``phase_infer_cli`` at batch 1 (96 K1 launches an image),
    from checkpoints of those presets: the CLI carries the preset."""
    from focalnet_tpu_torch.data.png import read_png
    from focalnet_tpu_torch.models import build_net
    from focalnet_tpu_torch.utils import save_checkpoint

    data, src = os.path.join(tmp, "sots"), os.path.join(tmp, "infer_in")
    names = sorted(os.listdir(src))
    for preset, argv, forwards in (
        ("baseline", ["--mode", "test", "--data_dir", data],
         len(os.listdir(os.path.join(data, "test", "hazy")))),
        ("1mlp", ["--mode", "infer", "--input", src], len(names)),
    ):
        ckpt = os.path.join(tmp, f"{preset}.pkl")
        save_checkpoint(ckpt, build_net(preset, device="cuda",
                                        generator=torch.Generator().manual_seed(1234))
                        .state_dict())
        out_dir = os.path.join(tmp, f"cli_{preset}")
        for c in counters:
            c.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = cli_main(argv + ["--preset", preset, "--test_model", ckpt,
                                      "--result_dir", out_dir,
                                      "--model_save_dir", os.path.join(out_dir, "cfg")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [c.launches for c in counters]
        expected = [PRESET_LAUNCHES[preset] * forwards, 0]
        with open(os.path.join(out_dir, "cfg", "config.json")) as f:
            recorded = json.load(f)["model"]
        emit(phase="preset_cli", preset=preset, mode=argv[1], result=result, seconds=seconds,
             printed=buf.getvalue().strip().splitlines()[-3:], launches_fwd=launches[0],
             launches_bwd=launches[1], expected_launches=expected,
             recorded_block_type=recorded["block_type"], recorded_gl_merge=recorded["gl_merge"])
        if launches != expected:
            fail(f"--mode {argv[1]} --preset {preset}: launches (K1, K2) {launches}, "
                 f"expected {expected}")
        if argv[1] == "test":
            per_image, summary = _eval_lines(buf.getvalue())
            if len(per_image) != forwards or len(summary) != 3 or not all(
                    math.isfinite(v) for v in result.values()):
                fail(f"--mode test --preset {preset}: {per_image}, {summary}, {result}")
        elif sorted(os.listdir(out_dir)) != sorted(names + ["cfg"]) or any(
                read_png(os.path.join(out_dir, n)).shape != read_png(os.path.join(src, n)).shape
                for n in names):
            fail(f"--mode infer --preset {preset} wrote {sorted(os.listdir(out_dir))}")


def phase_bf16(build_net, counters, card, smi, rng):
    """The bf16 recipe on ``1mlp_g2``: the 256x256 and 480x640 forwards on the
    kernels vs the plain scan (BF16_MODEL_TOL, 48 launches, device ms by
    kind), the batch-4 step's gradients (BF16_GRAD_TOL, launches, ms, device
    ms by kind), then the step's peak memory, ms and launches in fp32, bf16
    and bf16 with use_checkpoint (DropPath on).  Returns the memory rows."""
    from focalnet_tpu_torch.models import set_dropout_generator
    from focalnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    model = build_net("1mlp_g2", device="cuda", generator=torch.Generator().manual_seed(1234),
                      **RECIPE)
    plain = build_net("1mlp_g2", device="cuda", scan_backend="chunked", **RECIPE)
    plain.load_state_dict(model.state_dict(), strict=True)
    phase_forward("forward_256_bf16", "profile_bf16", model, plain, (256, 256), rng,
                  counters[0], card, smi, reps=20, plain_reps=5, tol=BF16_MODEL_TOL)
    phase_forward("forward_640_bf16", "profile_640_bf16", model, plain, (480, 640), rng,
                  counters[0], card, smi, reps=10, plain_reps=3, tol=BF16_MODEL_TOL)
    del model, plain
    torch.cuda.empty_cache()
    phase_grad(build_net, counters, card, name="grad_256_bf16",
               profile="profile_train_step_bf16", tol=BF16_GRAD_TOL, scaled=True, **RECIPE)

    gen = torch.Generator().manual_seed(4321)
    x = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=gen).cuda()
    gt = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=gen).cuda()
    rows = {}
    for tag, kw, expect in (("fp32", {}, [48, 48]), ("bf16", RECIPE, [48, 48]),
                            ("bf16_checkpoint", dict(RECIPE, use_checkpoint=True), [96, 48])):
        model = build_net("1mlp_g2", device="cuda",
                          generator=torch.Generator().manual_seed(1234), **kw).train()
        set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(model, make_optimizer(model))
        loss = step(x, gt)["loss"]  # Adam's state exists from here on
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for c in counters:
            c.launches = 0
        loss = float(step(x, gt)["loss"])
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        peak = torch.cuda.max_memory_allocated()
        ms = time_ms(lambda: step(x, gt), reps=5, warmup=1)
        rows[tag] = dict(peak_gb=peak / 1e9, resident_gb=base / 1e9, step_ms=ms,
                         launches_fwd=launches[0], launches_bwd=launches[1], loss=loss)
        emit(phase="step_memory", mode=tag, batch=TRAIN_BATCH, card=card, **rows[tag])
        if launches != expect or not math.isfinite(loss):
            fail(f"train step {tag}: launches (K1, K2) {launches}, expected {expect}; "
                 f"loss {loss}")
        del model, step
        torch.cuda.empty_cache()
    return rows


def phase_bf16_train_cli(cli_main, counters, tmp):
    """``--mode train --preset 1mlp`` under the bf16 recipe through the CLI,
    1 epoch of the synthetic pairs of ``phase_train_cli`` (2 steps, then
    validation on 2 images): 96 K1 and 96 K2 launches a step, 96 K1 a
    validated image, and finite losses."""
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "weights_bf16")
    for c in counters:
        c.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(["--mode", "train", "--mesh_shape", "1", "--preset", "1mlp",
                  "--compute_dtype", "bfloat16",
                  "--ssm_out_dtype", "bfloat16", "--data_dir", data,
                  "--batch_size", str(TRAIN_BATCH), "--crop_size", "256", "--print_freq", "1",
                  "--valid_freq", "1", "--num_worker", "4", "--num_epoch", "1",
                  "--model_save_dir", out, "--result_dir", os.path.join(tmp, "bf16_images")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    n = PRESET_LAUNCHES["1mlp"]
    expected = [n * (2 + 2), n * 2]
    with open(os.path.join(out, "train.metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [(r["pixel_loss"], r["fft_loss"]) for r in rows if "step" in r]
    psnr = [r["psnr"] for r in rows if "psnr" in r]
    with open(os.path.join(out, "config.json")) as f:
        recorded = json.load(f)["model"]
    emit(phase="train_cli_bf16", preset="1mlp", seconds=seconds, launches_fwd=launches[0],
         launches_bwd=launches[1], expected_launches=expected, losses=losses, psnr=psnr,
         recorded={k: recorded[k] for k in ("gl_merge", "compute_dtype", "ssm_out_dtype")},
         log_tail=buf.getvalue().strip().splitlines()[-3:])
    if launches != expected:
        fail(f"bf16 train run: launches (K1, K2) {launches}, expected {expected}")
    if len(losses) != 2 or not all(math.isfinite(v) for r in losses for v in r) or not (
            psnr and all(math.isfinite(p) for p in psnr)):
        fail(f"bf16 train run: losses {losses}, PSNR {psnr}")
    if (recorded["compute_dtype"], recorded["ssm_out_dtype"]) != ("bfloat16", "bfloat16"):
        fail(f"bf16 train run recorded {recorded}")


def phase_tf32(build_net, card):
    """The fp32 ``1mlp_g2`` 256x256 batch-1 forward and batch-4 train step with
    TF32 off (the port's setting) and on, in turns (off, on, on, off): ms by
    CUDA events and device ms by kind (5 forwards, 3 steps profiled), and
    the largest difference of the forward's outputs and of the first step's
    loss between the two.  TF32 is off again afterwards."""
    from focalnet_tpu_torch.train.trainer import make_optimizer, make_train_step
    from focalnet_tpu_torch.utils.profiling import device_profile

    gen = torch.Generator().manual_seed(4321)
    x1 = torch.rand(1, 256, 256, 3, generator=gen).cuda()
    x = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=gen).cuda()
    gt = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=gen).cuda()
    model = build_net("1mlp_g2", device="cuda", generator=torch.Generator().manual_seed(1234))

    def set_tf32(on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    def device(fn, reps):
        r = device_profile(fn, reps)
        if r is None:
            fail("TF32 phase: torch.profiler recorded no device events")
        return dict(ms=r["device_ms_per_call"], by_kind=r["ms_per_call_by_kind"])

    rows = {False: [], True: []}
    outs, losses = {}, {}
    try:
        for on in (False, True, True, False):
            set_tf32(on)
            with torch.inference_mode():
                outs[on] = model(x1)
                fwd_ms = time_ms(lambda: model(x1), reps=20)
                fwd_dev = device(lambda: model(x1), 5)
            train = build_net("1mlp_g2", device="cuda", drop_path_rate=0.0,
                              generator=torch.Generator().manual_seed(1234)).train()
            step = make_train_step(train, make_optimizer(train))
            losses[on] = float(step(x, gt)["loss"])
            step_ms = time_ms(lambda: step(x, gt), reps=5, warmup=1)
            rows[on].append(dict(forward_ms=fwd_ms, forward_device=fwd_dev, step_ms=step_ms,
                                 step_device=device(lambda: step(x, gt), 3)))
            del train, step
    finally:
        set_tf32(False)
    diff = [float((a - b).abs().max()) for a, b in zip(outs[False], outs[True])]
    emit(phase="tf32", off=rows[False], on=rows[True], forward_max_abs_diff=diff,
         first_step_loss_off=losses[False], first_step_loss_on=losses[True], card=card)
    if not all(math.isfinite(d) for d in diff):
        fail(f"TF32 forward differs by {diff}")
    return diff


# ---------------------------------------------------------------------------
# the variants slice: the SS2D variants and MambaSS2D at full width


def phase_variants(build_net, counters, card, smi, rng):
    """The full-width ``1mlp_g2`` at each configuration of VARIANTS (every
    out-norm, noz and nozact, force_fp32 under the bf16 recipe, v1 and v2
    init, no depthwise conv), through ``build_net``: the 256x256 batch-1
    forward on the kernels vs the plain scan (MODEL_TOL, BF16_MODEL_TOL in
    bf16; 48 K1 launches; ms by events, device ms by kind), then the batch-4
    step's gradients, kernel vs plain (MODEL_GRAD_TOL, BF16_GRAD_TOL scaled
    in bf16; 48 K1 and 48 K2 launches; the step is not timed).  Returns {name: K1 launches of the
    forward}."""
    launches = {}
    for name, kw in VARIANTS:
        bf16 = kw.get("compute_dtype") == "bfloat16"
        model = build_net("1mlp_g2", device="cuda",
                          generator=torch.Generator().manual_seed(1234), **kw)
        plain = build_net("1mlp_g2", device="cuda", scan_backend="chunked", **kw)
        plain.load_state_dict(model.state_dict(), strict=True)
        launches[name] = phase_forward(
            f"variant_forward_{name}", f"profile_variant_{name}", model, plain, (256, 256),
            rng, counters[0], card, smi, reps=10, plain_reps=2,
            tol=BF16_MODEL_TOL if bf16 else MODEL_TOL)
        del model, plain
        torch.cuda.empty_cache()
        phase_grad(build_net, counters, card, name=f"variant_grad_{name}", plain_reps=0,
                   timed=False, tol=BF16_GRAD_TOL if bf16 else MODEL_GRAD_TOL, scaled=bf16,
                   **kw)
    return launches


def phase_kernel_mamba(scan, fwd, bwd, bwd_ref, clock_mhz, sms):
    """K1 and K2 alone at MambaSS2D's scan (the model's width: two Mamba1D of
    192, each scanning D = 384 channels in one B/C group over L = 128 x 128 =
    16384), B = 1 (a forward) and 4 (a step), forward direction: against
    their plain versions (TOLS, GRAD_TOLS through the autograd Function) and
    timed as ``kernel_time`` and ``kernel_bwd_time`` time them, beside the
    plain versions and the bound.  Returns {(kernel, B): (ms, plain ms,
    bound ms, bound by, max abs err)}."""
    timing = {}
    L, dim = MAMBA_HW * MAMBA_HW, MAMBA_SCAN_DIM
    for batch in (1, TRAIN_BATCH):
        x, _ = scan_inputs(L, dim=dim, batch=batch)
        with torch.inference_mode():
            got = fwd(**x, delta_softplus=True)
            want = scan(**x, backend="chunked", delta_softplus=True)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, *TOLS[torch.float32])
            if not ok:
                fail(f"K1 at D={dim} G=1 L={L} B={batch}: max abs err {err}")
            del got, want
            ms = [kernel_ms(lambda: fwd(**x, delta_softplus=True), "selective_scan_fwd")
                  for _ in range(2)]
            plain = time_ms(lambda: scan(**x, backend="chunked", delta_softplus=True),
                            reps=5, warmup=1)
        b, by = bound(L, clock_mhz, sms, dim=dim, batch=batch)
        emit(phase="kernel_time", batch=batch, dim=dim, groups=1, L=L, reverse=False,
             y_accum=False, chunk_states=False, ms=ms, plain_ms=plain, bound_ms=b,
             bound_by=by, sfu_exp_ms=batch * sfu_ms(L, clock_mhz, sms, dim),
             max_abs_err=err, note="MambaSS2D's scan (Mamba1D of d_inner 384)")
        timing["fwd", batch] = (statistics.mean(ms), plain, b, by, err)
        errs = bwd_vs_plain(scan, L, False, False, torch.float32, batch, dim, 1)
        with torch.inference_mode():
            x, dy = scan_inputs(L, dim=dim, seed=1, batch=batch)
            _, hchk = fwd(**x, delta_softplus=True, chunk_states=True)
            args = (*x.values(), dy, hchk, True, False)
            ms = [kernel_ms(lambda: bwd(*args), "selective_scan_bwd") for _ in range(2)]
            plain = time_ms(lambda: bwd_ref(*args[:8], True, False), reps=3, warmup=1)
        b, by = bound_bwd(L, clock_mhz, sms, dim=dim, batch=batch)
        emit(phase="kernel_bwd_time", batch=batch, dim=dim, groups=1, L=L, reverse=False,
             ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=errs,
             sfu_exp_ms=batch * sfu_ms(L, clock_mhz, sms, dim),
             note="MambaSS2D's scan (Mamba1D of d_inner 384)")
        timing["bwd", batch] = (statistics.mean(ms), plain, b, by, max(errs.values()))
        del x, dy, hchk, args
        torch.cuda.empty_cache()
    return timing


def phase_mamba(counters, card):
    """MambaSS2D at the model's width (``d_model`` 96: two Mamba1D of 192,
    each scanning 384 channels in one B/C group over L = H W) on
    (B, 128, 128, 96): the B = 1 forward and the gradients of a B = 4 step
    (``sum(y * w)``), on the kernels vs the plain scan, each held relative
    to its scale (max |got - want| <= MAMBA_RTOL max |want|: the init laws
    make the outputs and gradients small); 2 K1 launches a forward, 2 K1
    and 2 K2 a step; ms by events.  Returns the kernels' launches of the
    forward and of the step."""
    from focalnet_tpu_torch.models import MambaSS2D
    from focalnet_tpu_torch.models.initializers import init_weights

    gen = torch.Generator().manual_seed(4321)
    xs = {b: torch.randn(b, MAMBA_HW, MAMBA_HW, MAMBA_DIM, generator=gen).cuda()
          for b in (1, TRAIN_BATCH)}
    w = torch.randn(TRAIN_BATCH, MAMBA_HW, MAMBA_HW, MAMBA_DIM, generator=gen).cuda()
    models = {}
    for backend in ("cuda", "chunked"):
        m = MambaSS2D(MAMBA_DIM, scan_backend=backend)
        init_weights(m, torch.Generator().manual_seed(1234))
        models[backend] = m.cuda().train()
    outs, grads, launches = {}, {}, {}
    for backend, m in models.items():
        for c in counters:
            c.launches = 0
        with torch.inference_mode():
            outs[backend] = m(xs[1])
        torch.cuda.synchronize()
        launches[backend, "forward"] = [c.launches for c in counters]
        for c in counters:
            c.launches = 0
        (m(xs[TRAIN_BATCH]) * w).sum().backward()
        torch.cuda.synchronize()
        launches[backend, "step"] = [c.launches for c in counters]
        grads[backend] = {k: p.grad for k, p in m.named_parameters()}
    scale = float(outs["chunked"].abs().max())
    fwd_err = float((outs["cuda"] - outs["chunked"]).abs().max())
    if not (fwd_err <= MAMBA_RTOL * scale and bool(torch.isfinite(outs["cuda"]).all())):
        fail(f"mamba: MambaSS2D forward, kernel vs plain max abs err {fwd_err} "
             f"(largest output {scale})")
    worst, worst_key = 0.0, None
    for k, g in grads["chunked"].items():
        err = float((grads["cuda"][k] - g).abs().max())
        lim = MAMBA_RTOL * float(g.abs().max())
        if not (err <= lim and bool(torch.isfinite(grads["cuda"][k]).all())):
            fail(f"mamba: gradient of {k}: kernel vs plain max abs err {err} > {lim}")
        if err / lim > worst:
            worst, worst_key = err / lim, k
    expect = {("cuda", "forward"): [2, 0], ("cuda", "step"): [2, 2],
              ("chunked", "forward"): [0, 0], ("chunked", "step"): [0, 0]}
    if launches != expect:
        fail(f"mamba: launches (K1, K2) {launches}, expected {expect}")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: models["cuda"](xs[1]), reps=10)
        plain_ms = time_ms(lambda: models["chunked"](xs[1]), reps=3, warmup=1)
    emit(phase="mamba", d_model=MAMBA_DIM, shape=[1, MAMBA_HW, MAMBA_HW, MAMBA_DIM],
         step_batch=TRAIN_BATCH, forward_max_abs_err=fwd_err, forward_scale=scale,
         rtol=MAMBA_RTOL, grad_max_err_over_limit=worst, worst_param=worst_key,
         params=len(grads["cuda"]), launches={f"{b}_{p}": v for (b, p), v in launches.items()},
         forward_ms=fwd_ms, plain_forward_ms=plain_ms, card=card)
    del models, outs, grads, xs, w
    torch.cuda.empty_cache()
    return launches["cuda", "forward"], launches["cuda", "step"]


# ---------------------------------------------------------------------------
# the sequence-parallel slice: the segment API of K1 and K2, and
# --mesh_shape 1,2 of --mode test and --mode train


def bound_segment(L, clock_mhz, sms, batch, dim=SP_DIM, N=16, groups=SP_GROUPS, in_bytes=4,
                  out_bytes=4, accum=False, chunk_states=False):
    """:func:`bound` for a segment call of K1 with G groups: the bytes also
    hold h0 read and h_last written, (batch, dim, N) fp32 each."""
    n_chunks = -(-L // 256)
    nbytes = (batch * (dim * L * (2 * in_bytes + out_bytes * (2 if accum else 1))
                       + 2 * groups * N * L * in_bytes
                       + (dim * n_chunks * N * 4 if chunk_states else 0) + 2 * dim * N * 4)
              + (dim * N + 2 * dim) * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = batch * (9 * L * dim * N + L * dim) / PEAK_FP32_FLOPS * 1e3
    t_sfu = batch * sfu_ms(L, clock_mhz, sms, dim, N)
    return max(t_bytes, t_ops, t_sfu), "bytes" if t_bytes >= max(t_ops, t_sfu) else "operations"


def bound_segment_bwd(L, clock_mhz, sms, batch, dim=SP_DIM, N=16, groups=SP_GROUPS, in_bytes=4):
    """:func:`bound_bwd` for a segment call of K2 with G groups: the bytes
    also hold dh_last read and dh0 written, (batch, dim, N) fp32 each."""
    n_chunks = -(-L // 256)
    nbytes = (batch * (dim * L * (4 * in_bytes + 4) + 2 * groups * N * L * (in_bytes + 4)
                       + dim * n_chunks * N * 4 + 2 * dim * N * 4) + 2 * (dim * N + 2 * dim) * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = batch * (22 * L * dim * N + 10 * L * dim) / PEAK_FP32_FLOPS * 1e3
    t_sfu = batch * sfu_ms(L, clock_mhz, sms, dim, N)
    return max(t_bytes, t_ops, t_sfu), "bytes" if t_bytes >= max(t_ops, t_sfu) else "operations"


def phase_kernel_segment(scan, fwd, bwd, bwd_ref, fwd_ref_states, clock_mhz, sms):
    """The segment API at the sequence-parallel path's shapes (D = 384, two
    groups, N = 16; a rank's L / 2 of the 256x256 train step at B = 4 and of
    the 480x640 test at B = 1), fp32 and bf16 operands:

    - K1 with h0 -> h_last (and chunk states from h0), both directions,
      with and without y_accum, against the plain scan and chunk_states_ref
      under TOLS; two chained half segments against the whole call; a zero
      h0 gives the plain launch's y and chunk states bit for bit;
    - K2 with dh_last -> dh0 at the B = 4 lengths, both directions, every
      gradient and dh0 against the plain adjoint under GRAD_TOLS; a zero
      dh_last gives the plain launch's du and ddelta bit for bit;
    - in fp32, forward direction: each segment call's time beside the
      plain launch at the same shape (in turns: plain, segment, segment,
      plain), the plain version's and the bound with the states' bytes.

    Returns the worst fp32 errors of K1 and K2 and the timings."""
    f32, bf16 = torch.float32, torch.bfloat16
    worst, worst_bwd, timing = 0.0, 0.0, {}
    for batch, lengths in SP_LS.items():
        for L in lengths:
            for dt in (f32, bf16):
                x, dy = scan_inputs(L, dim=SP_DIM, dtype=dt, seed=2, batch=batch,
                                    groups=SP_GROUPS)
                g = torch.Generator(device="cuda").manual_seed(3)
                h0, dh_last = (torch.randn(batch, SP_DIM, 16, generator=g, device="cuda")
                               for _ in range(2))
                yacc, zero = torch.randn_like(dy), torch.zeros_like(h0)
                rtol, atol = TOLS[dt]
                for rev in (False, True):
                    for acc in (False, True):
                        kw = dict(delta_softplus=True, reverse=rev,
                                  y_accum=yacc if acc else None)
                        with torch.inference_mode():
                            y, h_last, hchk = fwd(**x, **kw, h0=h0, return_state=True,
                                                  chunk_states=True)
                            y_w, h_w = scan(**x, **kw, backend="chunked", h0=h0,
                                            return_state=True)
                            want_h = fwd_ref_states(x["u"], x["delta"], x["A"], x["B"],
                                                    x["delta_bias"], True, rev, h0=h0)
                            half = lambda t, i: (t[..., :L // 2] if i == 0
                                                 else t[..., L // 2:]).contiguous()
                            ops = lambda i: {k: half(v, i) if v.dim() > 2 and v.shape[-1] == L
                                             else v for k, v in x.items()}
                            seg = lambda i, h: fwd(
                                **ops(i), delta_softplus=True, reverse=rev, h0=h,
                                y_accum=half(yacc, i) if acc else None, return_state=True)
                            first, second = (1, 0) if rev else (0, 1)
                            y1, h1 = seg(first, h0)
                            y2, h2 = seg(second, h1)
                            y_chain = torch.cat([y2, y1] if rev else [y1, y2], dim=-1)
                            y_null, hchk_null = fwd(**x, **kw, chunk_states=True)
                            y_zero, _, hchk_zero = fwd(**x, **kw, h0=zero, return_state=True,
                                                       chunk_states=True)
                        torch.cuda.synchronize()
                        errs = dict(y=max_err(y, y_w, rtol, atol),
                                    h_last=max_err(h_last, h_w, rtol, atol),
                                    chunk_states=max_err(hchk, want_h, rtol, atol),
                                    chained_y=max_err(y_chain, y, rtol, atol),
                                    chained_h_last=max_err(h2, h_last, rtol, atol))
                        bitwise = bool(torch.equal(y_zero, y_null)
                                       and torch.equal(hchk_zero, hchk_null))
                        emit(phase="kernel_segment", kernel="fwd", batch=batch, L=L,
                             reverse=rev, y_accum=acc, dtype=str(dt),
                             max_abs_err={k: e for k, (e, _) in errs.items()},
                             zero_h0_bitwise=bitwise, rtol=rtol, atol=atol)
                        if not (bitwise and all(ok for _, ok in errs.values())):
                            fail(f"K1 segment at B={batch} L={L} reverse={rev} y_accum={acc} "
                                 f"{dt}: {errs}, zero h0 bit for bit: {bitwise}")
                        if dt == f32:
                            worst = max(worst, *(e for e, _ in errs.values()))
                        del y, y_w, y_chain, y_null, y_zero, want_h, hchk_null, hchk_zero, y1, y2
                        if batch != TRAIN_BATCH or acc:
                            continue
                        args = (*x.values(), dy, hchk, True, rev)
                        grads = bwd(*args, dh_last=dh_last, with_state=True)
                        want = bwd_ref(*args[:8], True, rev, h0=h0, dh_last=dh_last,
                                       with_state=True)
                        g_null = bwd(*args)
                        g_zero = bwd(*args, dh_last=zero, with_state=True)
                        torch.cuda.synchronize()
                        gerrs = {}
                        for name, got, w in zip(GRAD_NAMES[:7] + ("dh0",), grads, want):
                            gerrs[name], ok = grad_err(got, w, *GRAD_TOLS[dt])
                            if not ok:
                                fail(f"K2 segment at B={batch} L={L} reverse={rev} {dt}: "
                                     f"{name} max abs err {gerrs[name]}")
                        bitwise = bool(torch.equal(g_zero[0], g_null[0])
                                       and torch.equal(g_zero[1], g_null[1]))
                        emit(phase="kernel_segment", kernel="bwd", batch=batch, L=L,
                             reverse=rev, dtype=str(dt), max_abs_err=gerrs,
                             zero_dh_last_bitwise=bitwise, rtol=GRAD_TOLS[dt][0],
                             atol=GRAD_TOLS[dt][1])
                        if not bitwise:
                            fail(f"K2 at B={batch} L={L} reverse={rev} {dt}: a zero dh_last "
                                 "does not give the plain launch's du and ddelta")
                        if dt == f32:
                            worst_bwd = max(worst_bwd, *gerrs.values())
                        del grads, want, g_null, g_zero
                if dt == f32:
                    timing.update(_time_segment(scan, fwd, bwd, bwd_ref, x, dy, h0, dh_last,
                                                batch, L, clock_mhz, sms))
                del x, dy, yacc
                torch.cuda.empty_cache()
    return worst, worst_bwd, timing


def _time_segment(scan, fwd, bwd, bwd_ref, x, dy, h0, dh_last, batch, L, clock_mhz, sms):
    """K1 (and at the train step's batch, with its chunk states, K2) as the
    sequence-parallel path launches them, forward direction, fp32: the
    segment call and the plain launch at the same shape, in turns, the plain
    versions and the bounds."""
    train = batch == TRAIN_BATCH
    kw = dict(delta_softplus=True, chunk_states=train)
    seg_kw = dict(kw, h0=h0, return_state=True)
    with torch.inference_mode():
        k1 = lambda **k: kernel_ms(lambda: fwd(**x, **k), "selective_scan_fwd")
        dense = [k1(**kw)]
        seg = [k1(**seg_kw), k1(**seg_kw)]
        dense.append(k1(**kw))
        plain = time_ms(lambda: scan(**x, delta_softplus=True, backend="chunked", h0=h0,
                                     return_state=True), reps=3, warmup=1)
        b, by = bound_segment(L, clock_mhz, sms, batch, chunk_states=train)
        emit(phase="kernel_segment_time", kernel="fwd", batch=batch, L=L, dim=SP_DIM,
             groups=SP_GROUPS, chunk_states=train, ms=seg, dense_ms=dense, plain_ms=plain,
             bound_ms=b, bound_by=by)
        out = {("fwd", batch, L): (statistics.mean(seg), statistics.mean(dense), plain, b, by)}
        if not train:
            return out
        hchk = fwd(**x, **seg_kw)[2]
        args = (*x.values(), dy, hchk, True, False)
        k2 = lambda **k: kernel_ms(lambda: bwd(*args, **k), "selective_scan_bwd")
        dense = [k2()]
        seg = [k2(dh_last=dh_last, with_state=True), k2(dh_last=dh_last, with_state=True)]
        dense.append(k2())
        plain = time_ms(lambda: bwd_ref(*args[:8], True, False, h0=h0, dh_last=dh_last,
                                        with_state=True), reps=3, warmup=1)
        b, by = bound_segment_bwd(L, clock_mhz, sms, batch)
        emit(phase="kernel_segment_time", kernel="bwd", batch=batch, L=L, dim=SP_DIM,
             groups=SP_GROUPS, ms=seg, dense_ms=dense, plain_ms=plain, bound_ms=b, bound_by=by)
        out[("bwd", batch, L)] = (statistics.mean(seg), statistics.mean(dense), plain, b, by)
    return out


@contextlib.contextmanager
def _stdout_fd_to(path):
    """File descriptor 1 (this process's and the ranks' it spawns) into
    ``path`` for the block."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _sp_cli(cli_main, argv, tmp, name, mesh_shape=SP_MESH):
    """``cli_main(argv + --mesh_shape mesh_shape)`` with its ranks' output in
    a file; returns the ranks' reports and the run's seconds."""
    t0 = time.perf_counter()
    with _stdout_fd_to(os.path.join(tmp, f"{name}.out")):
        reports = cli_main(argv + ["--mesh_shape", mesh_shape])
    return reports, time.perf_counter() - t0


def _sp_note(ranks):
    return ("the ranks share one card: times measure correctness and overhead, not scaling"
            if torch.cuda.device_count() < ranks else None)


def phase_sp_test_cli(cli_main, tmp, ckpt, single_per_image, card, mesh_shape=SP_MESH):
    """``--mode test --mesh_shape 1,M`` through the CLI on the synthetic
    460x620 split of ``phase_test_cli``: M ranks (gloo when they share a
    card), each image's PSNR within 0.01 dB and SSIM within 1e-4 of the
    single-rank kernel run (as printed), 24 segment K1 launches per image on
    each rank and no K2, and each rank's peak memory.  Ranks that share a
    card contend for its SMs: the time per image then measures correctness
    and overhead, not scaling.  Returns rank 0's K1 launches and time per
    image."""
    data = os.path.join(tmp, "sots")
    n_images = len(single_per_image)
    reports, seconds = _sp_cli(cli_main, [
        "--mode", "test", "--data_dir", data, "--test_model", ckpt,
        "--result_dir", os.path.join(tmp, f"sp_test_{mesh_shape}"),
        "--model_save_dir", os.path.join(tmp, "sp_test_cfg")], tmp, "sp_test_cli", mesh_shape)
    per_image, summary = _eval_lines(reports[0]["stdout"])
    expected = [SP_LAUNCHES_PER_FORWARD * n_images] * 2 + [0, 0]
    got = [[r["launches_fwd"], r["segment_launches_fwd"], r["launches_bwd"],
            r["segment_launches_bwd"]] for r in reports]
    d_psnr = max((abs(a[0] - b[0]) for a, b in zip(per_image, single_per_image)), default=None)
    d_ssim = max((abs(a[1] - b[1]) for a, b in zip(per_image, single_per_image)), default=None)
    emit(phase="sp_test_cli", mesh_shape=mesh_shape, ranks=len(reports),
         backend=reports[0]["backend"], images=n_images, per_image=per_image,
         single_rank_per_image=single_per_image, summary=summary,
         max_psnr_diff_db=d_psnr, max_ssim_diff=d_ssim, seconds=seconds,
         launches=got, expected_launches=expected,
         average_time_s=[r["result"]["time"] for r in reports],
         peak_mem_gb=[r["peak_mem_gb"] for r in reports], card=card,
         note=_sp_note(len(reports)))
    if any(g != expected for g in got):
        fail(f"--mode test --mesh_shape {mesh_shape}: launches per rank (K1, segment K1, K2, "
             f"segment K2) {got}, expected {expected}")
    if len(per_image) != n_images or len(summary) != 3:
        fail(f"--mode test --mesh_shape {mesh_shape} printed {per_image} and {summary}")
    if not (d_psnr <= 0.01 + 1e-9 and d_ssim <= 1e-4 + 1e-12):
        fail(f"--mode test --mesh_shape {mesh_shape} vs one rank: PSNR {d_psnr} dB, "
             f"SSIM {d_ssim}")
    # each rank runs the layers outside the scans itself, and their cuDNN
    # kernels may differ between two processes: the ranks agree to rounding
    spread = max(r["result"]["psnr"] for r in reports) - min(r["result"]["psnr"] for r in reports)
    if not spread <= 1e-6:
        fail(f"the ranks' average PSNR differ by {spread} dB: {[r['result'] for r in reports]}")
    return got[0][0], reports[0]["result"]["time"]


def _sp_grad_rank(mesh, x, gt):
    """One rank of ``phase_sp_train``'s gradient check: the full-width
    seq-sharded ``1mlp_g2`` (seed 1234, no DropPath), one forward and
    backward of :func:`smooth_loss` at batch 4 with its launch counts and
    peak memory, then the times of a forward and a train step (with the
    gradients' all-reduce) by CUDA events and their device profiles."""
    from focalnet_tpu_torch.models import build_net
    from focalnet_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bwd_cuda,
        selective_scan_cuda,
    )
    from focalnet_tpu_torch.train.trainer import make_optimizer, make_train_step
    from focalnet_tpu_torch.utils.profiling import device_profile

    counters = (selective_scan_cuda, selective_scan_bwd_cuda)
    model = build_net("1mlp_g2", device=mesh.device, drop_path_rate=0.0, seq_mesh=mesh,
                      seq_axis="seq", data_axis="data",
                      generator=torch.Generator().manual_seed(1234)).train()
    x, gt = torch.from_numpy(x).to(mesh.device), torch.from_numpy(gt).to(mesh.device)
    for c in counters:
        c.launches = c.segment_launches = 0
    torch.cuda.reset_peak_memory_stats()
    smooth_loss(model(x), gt).backward()
    torch.cuda.synchronize()
    launches = [[c.launches, c.segment_launches] for c in counters]
    grads = {k: p.grad.cpu().numpy() for k, p in model.named_parameters()}
    peak = torch.cuda.max_memory_allocated() / 1e9

    def forward():
        with torch.no_grad():
            model(x)

    step = make_train_step(model, make_optimizer(model), mesh=mesh)
    return dict(rank=mesh.rank, launches=launches, grads=grads, peak_mem_gb=peak,
                backend=mesh.backend, forward_ms=time_ms(forward, reps=3, warmup=1),
                step_ms=time_ms(lambda: step(x, gt), reps=3, warmup=1),
                forward_profile=device_profile(forward, 2),
                step_profile=device_profile(lambda: step(x, gt), 2))


def phase_sp_train(build_net, cli_main, tmp, card):
    """``--mesh_shape 1,2`` training of the full-width ``1mlp_g2`` at batch 4,
    256x256, two ranks on the card:

    - the first step's gradients (smooth_loss, no DropPath) on each rank
      against the single-rank kernel model's, per parameter within
      MODEL_GRAD_TOL (``phase_grad``'s limit); 24 segment K1 and 24 segment
      K2 launches per rank; each rank's peak memory; the forward's and the
      step's time by CUDA events and device profile on each rank;
    - ``--mode train`` through the CLI for one epoch of 3 steps (validation
      on 2 images, mesh-free, the ranks splitting them): the parameters equal
      on both ranks after the steps (a digest), 24 segment K1 and K2
      launches a step per rank (and 48 dense K1 a validated image), finite
      losses in rank 0's log.

    Returns rank 0's K1 and K2 launches of the CLI run."""
    from focalnet_tpu_torch.data.reside import make_synthetic_dataset
    from focalnet_tpu_torch.parallel import spawn

    gen = torch.Generator().manual_seed(4321)
    x = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=gen)
    gt = torch.rand(TRAIN_BATCH, 256, 256, 3, generator=gen)
    model = build_net("1mlp_g2", device="cuda", drop_path_rate=0.0,
                      generator=torch.Generator().manual_seed(1234)).train()
    smooth_loss(model(x.cuda()), gt.cuda()).backward()
    want = {k: p.grad for k, p in model.named_parameters()}
    with _stdout_fd_to(os.path.join(tmp, "sp_grad.out")):
        ranks = spawn(_sp_grad_rank, (1, SP_RANKS), "cuda", args=(x.numpy(), gt.numpy()),
                      timeout_s=SP_TIMEOUT_S)
    rel, ab = MODEL_GRAD_TOL
    for r in ranks:
        worst, worst_key, max_abs = 0.0, None, 0.0
        for k, w in want.items():
            err = float((torch.from_numpy(r["grads"][k]).cuda() - w).abs().max())
            lim = rel * float(w.abs().max()) + ab
            if not (err <= lim and np.isfinite(r["grads"][k]).all()):
                fail(f"sp_train rank {r['rank']}: gradient of {k} vs one rank: max abs err "
                     f"{err} > {lim}")
            max_abs = max(max_abs, err)
            if err / lim > worst:
                worst, worst_key = err / lim, k
        expected = [[SP_LAUNCHES_PER_FORWARD] * 2] * 2
        emit(phase="sp_grad", mesh_shape=SP_MESH, rank=r["rank"], backend=r["backend"],
             params=len(r["grads"]), max_abs_err=max_abs, max_err_over_limit=worst,
             worst_param=worst_key, launches=r["launches"], expected_launches=expected,
             peak_mem_gb=r["peak_mem_gb"], forward_ms=r["forward_ms"], step_ms=r["step_ms"],
             forward_profile=r["forward_profile"], step_profile=r["step_profile"], card=card,
             note=_sp_note(SP_RANKS))
        if r["launches"] != expected or len(r["grads"]) != len(want):
            fail(f"sp_grad rank {r['rank']}: launches (K1, segment K1), (K2, segment K2) "
                 f"{r['launches']}, expected {expected}; {len(r['grads'])} gradients")
    del model, want
    torch.cuda.empty_cache()

    data, out = os.path.join(tmp, "sp_data"), os.path.join(tmp, "sp_weights")
    make_synthetic_dataset(data, n_train=6, n_test=1, hw=(256, 256), seed=0)
    steps, val_images = 3, 2
    reports, seconds = _sp_cli(cli_main, [
        "--mode", "train", "--data_dir", data, "--batch_size", str(TRAIN_BATCH),
        "--crop_size", "256", "--print_freq", "1", "--valid_freq", "1", "--num_worker", "4",
        "--num_epoch", "1", "--model_save_dir", out,
        "--result_dir", os.path.join(tmp, "sp_train_images")], tmp, "sp_train_cli")
    got = [[r["launches_fwd"], r["segment_launches_fwd"], r["launches_bwd"],
            r["segment_launches_bwd"]] for r in reports]
    n = SP_LAUNCHES_PER_FORWARD * steps
    expected = [[n + LAUNCHES_PER_FORWARD * len(range(r, val_images, len(reports))), n, n, n]
                for r in range(len(reports))]
    digests = [r["result"]["param_sha256"] for r in reports]
    with open(os.path.join(out, "train.metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [(r["pixel_loss"], r["fft_loss"]) for r in rows if "step" in r]
    emit(phase="sp_train_cli", mesh_shape=SP_MESH, ranks=len(reports),
         backend=reports[0]["backend"], steps=steps,
         seconds=seconds, launches=got, expected_launches=expected, param_sha256=digests,
         losses=losses, psnr=[r["psnr"] for r in rows if "psnr" in r],
         peak_mem_gb=[r["peak_mem_gb"] for r in reports],
         checkpoints=sorted(os.listdir(out)), card=card)
    if got != expected:
        fail(f"--mode train --mesh_shape {SP_MESH}: launches per rank (K1, segment K1, K2, "
             f"segment K2) {got}, expected {expected}")
    if len(set(digests)) != 1:
        fail(f"--mode train --mesh_shape {SP_MESH}: the ranks' parameters differ: {digests}")
    if len(losses) != steps or not all(math.isfinite(v) for r in losses for v in r):
        fail(f"--mode train --mesh_shape {SP_MESH}: losses {losses}")
    if not {"model.pkl", "Best.pkl", "Final.pkl"} <= set(os.listdir(out)):
        fail(f"--mode train --mesh_shape {SP_MESH} wrote {sorted(os.listdir(out))}")
    return got[0][1], got[0][3]


def run_sp_only(cli_main, build_net, save_checkpoint, card):
    """``python3 chip_smoke.py --sp_only``: the sequence-parallel phases alone,
    on every card the machine has (NCCL when each rank has a card of its
    own): ``--mode test`` at ``1,2``, and at ``1,4`` with four cards, against
    one rank on a 2-GT synthetic 460x620 split, then ``phase_sp_train``; and
    with several cards data parallelism over NCCL (``phase_dp_nccl``)."""
    from focalnet_tpu_torch.data.reside import make_synthetic_dataset

    with tempfile.TemporaryDirectory() as tmp:
        data = make_synthetic_dataset(os.path.join(tmp, "sots"), n_train=2, n_test=2,
                                      hw=SOTS_HW, seed=0)
        ckpt = os.path.join(tmp, "model.pkl")
        save_checkpoint(ckpt, build_net("1mlp_g2", device="cuda",
                                        generator=torch.Generator().manual_seed(1234))
                        .state_dict())
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["--mode", "test", "--data_dir", data, "--test_model", ckpt,
                      "--result_dir", os.path.join(tmp, "test"),
                      "--model_save_dir", os.path.join(tmp, "test_cfg")])
        per_image, _ = _eval_lines(buf.getvalue())
        for mesh_shape in (SP_MESH, "1,4")[:1 + (torch.cuda.device_count() >= 4)]:
            phase_sp_test_cli(cli_main, tmp, ckpt, per_image, card, mesh_shape)
        phase_sp_train(build_net, cli_main, tmp, card)
        phase_dp_nccl(build_net, cli_main, tmp, card, torch.cuda.device_count())


# the rest of parallelism: data parallelism (--mesh_shape N and the auto
# default), dp x sp (--mesh_shape D,M), sharded --mode infer, the
# channel-split scan over a (data, model) mesh (build_net(tp_axis="model")),
# and the mesh commands that run without a mesh


def phase_kernel_tp(scan, fwd, bwd, bwd_ref, clock_mhz, sms):
    """K1 and K2 at the channel-split scan's shards, against their plain
    versions:

    - the sub-group shard of a stacked pair (B = 4, 2 x 96 channels, two B/C
      groups: each group's 192 channels halved), at L = 16384, 4096, 1024,
      fp32 and bf16 operands: K1 with and without y_accum in both directions
      against the plain scan under TOLS; K2 from K1's chunk states in both
      directions against the plain adjoint under GRAD_TOLS;
    - the whole-group shard that a (2, 2) data x model mesh gives each rank
      (its 2 rows, one group of 192 channels, y_accum: JAX's rule picks
      whole groups where the 2 groups divide over the 2 ranks), at the same
      lengths, fp32, K1 both directions with y_accum and K2;
    - in fp32, forward direction: K1 with y_accum timed beside the plain
      launch (no y_accum) in turns (plain, y_accum, y_accum, plain), the
      plain version's time and the bound; K2 with its plain version's time
      and bound.

    Returns the worst fp32 errors of K1 and K2 and the timings by (shard,
    kernel, L)."""
    f32, bf16 = torch.float32, torch.bfloat16
    worst, worst_bwd, timing = 0.0, 0.0, {}
    shards = (("sub_group", TRAIN_BATCH, TP_SUB_GROUPS, (f32, bf16)),
              ("whole_group", TRAIN_BATCH // 2, 1, (f32,)))
    for shard, batch, groups, dtypes in shards:
        for L in PATH_LS:
            for dt in dtypes:
                x, dy = scan_inputs(L, dim=TP_DIM, dtype=dt, seed=5, batch=batch, groups=groups)
                yacc = torch.randn_like(dy)
                rtol, atol = TOLS[dt]
                errs, gerrs = {}, {}
                for rev in (False, True):
                    for acc in ((False, True) if shard == "sub_group" else (True,)):
                        with torch.inference_mode():
                            kw = dict(delta_softplus=True, reverse=rev,
                                      y_accum=yacc if acc else None)
                            y = fwd(**x, **kw)
                            want = scan(**x, **kw, backend="chunked")
                        torch.cuda.synchronize()
                        errs[f"reverse={rev},y_accum={acc}"], ok = max_err(y, want, rtol, atol)
                        if not ok:
                            fail(f"K1 at the tp {shard} shard B={batch} L={L} reverse={rev} "
                                 f"y_accum={acc} {dt}: max abs err {errs}")
                    _, hchk = fwd(**x, delta_softplus=True, reverse=rev, chunk_states=True)
                    args = (*x.values(), dy, hchk, True, rev)
                    got, want = bwd(*args), bwd_ref(*args[:8], True, rev)
                    torch.cuda.synchronize()
                    for name, g, w in zip(GRAD_NAMES[:7], got, want):
                        gerrs[f"reverse={rev},{name}"], ok = grad_err(g, w, *GRAD_TOLS[dt])
                        if not ok:
                            fail(f"K2 at the tp {shard} shard B={batch} L={L} reverse={rev} "
                                 f"{dt}: {name} max abs err {gerrs}")
                    del got, want, hchk
                emit(phase="kernel_tp", shard=shard, batch=batch, dim=TP_DIM, groups=groups, L=L,
                     dtype=str(dt), max_abs_err=errs, max_abs_err_bwd=gerrs, rtol=rtol, atol=atol,
                     grad_rtol=GRAD_TOLS[dt][0], grad_atol=GRAD_TOLS[dt][1])
                if dt == f32:
                    worst = max(worst, *errs.values())
                    worst_bwd = max(worst_bwd, *gerrs.values())
                    timing.update(_time_tp(scan, fwd, bwd, bwd_ref, x, dy, yacc, shard, batch,
                                           groups, L, clock_mhz, sms))
                del x, dy, yacc
                torch.cuda.empty_cache()
    return worst, worst_bwd, timing


def _time_tp(scan, fwd, bwd, bwd_ref, x, dy, yacc, shard, batch, groups, L, clock_mhz, sms):
    """K1 with y_accum beside the plain launch, in turns, and K2, forward
    direction, fp32, with the plain versions' times and the bounds."""
    with torch.inference_mode():
        k1 = lambda **k: kernel_ms(lambda: fwd(**x, delta_softplus=True, **k),
                                   "selective_scan_fwd")
        plain_launch = [k1()]
        ms = [k1(y_accum=yacc), k1(y_accum=yacc)]
        plain_launch.append(k1())
        plain = time_ms(lambda: scan(**x, delta_softplus=True, backend="chunked", y_accum=yacc),
                        reps=3, warmup=1)
        b, by = bound(L, clock_mhz, sms, dim=TP_DIM, accum=True, batch=batch, groups=groups)
        _, hchk = fwd(**x, delta_softplus=True, chunk_states=True)
        args = (*x.values(), dy, hchk, True, False)
        ms_bwd = kernel_ms(lambda: bwd(*args), "selective_scan_bwd")
        plain_bwd = time_ms(lambda: bwd_ref(*args[:8], True, False), reps=3, warmup=1)
        b_bwd, by_bwd = bound_bwd(L, clock_mhz, sms, dim=TP_DIM, batch=batch, groups=groups)
    emit(phase="kernel_tp_time", shard=shard, batch=batch, dim=TP_DIM, groups=groups, L=L,
         ms=ms, plain_launch_ms=plain_launch, plain_ms=plain, bound_ms=b, bound_by=by,
         ms_bwd=ms_bwd, plain_ms_bwd=plain_bwd, bound_ms_bwd=b_bwd, bound_by_bwd=by_bwd)
    return {(shard, "fwd", L): (statistics.mean(ms), statistics.mean(plain_launch), plain, b, by),
            (shard, "bwd", L): (ms_bwd, None, plain_bwd, b_bwd, by_bwd)}


def _first_step(model, mesh, x, gt, grad_accum=1):
    """One forward and backward of :func:`smooth_loss` over ``grad_accum``
    micro-batches of ``x``, ``gt`` (host arrays), on this rank's rows of each
    (maybe none), with each micro-batch's DropPath masks drawn whole
    (generator seeded with DP_MASK_SEED), the gradients and the loss then
    averaged over the mesh as the train step averages them
    (``train.trainer.accumulate``, ``sync_grads``); the loss, the K1 and K2
    launches (all, and those of the segment API), the gradients on the host
    and the peak memory."""
    from focalnet_tpu_torch.models import set_dropout_generator
    from focalnet_tpu_torch.ops.selective_scan_cuda import (
        selective_scan_bwd_cuda,
        selective_scan_cuda,
    )
    from focalnet_tpu_torch.train.trainer import (
        accumulate,
        batch_rows,
        micro_batch_rows,
        sync_grads,
    )

    counters = (selective_scan_cuda, selective_scan_bwd_cuda)
    batch = len(x)
    rows = batch_rows(batch, grad_accum, mesh)
    rows = slice(None) if rows is None else rows
    xs, gts = (torch.from_numpy(a[rows]).to(mesh.device) for a in (x, gt))
    set_dropout_generator(model, torch.Generator(device=mesh.device).manual_seed(DP_MASK_SEED),
                          (micro_batch_rows(batch, grad_accum, mesh).start, batch // grad_accum))
    for c in counters:
        c.launches = c.segment_launches = 0
    torch.cuda.reset_peak_memory_stats()
    sums = accumulate(model, xs, gts, lambda p, g: (smooth_loss(p, g),), grad_accum, mesh,
                      batch, n_terms=1)
    loss = sync_grads(model, mesh, sums) / grad_accum
    torch.cuda.synchronize()
    return dict(loss=float(loss), launches=[[c.launches, c.segment_launches] for c in counters],
                grads={k: p.grad.cpu().numpy() for k, p in model.named_parameters()},
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), (xs, gts)


def _step_ms(model, mesh, xs, gts):
    """ms per train step (loss, backward, the gradients' all-reduce, clip,
    Adam) of ``model`` on this rank's rows, by CUDA events."""
    from focalnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    step = make_train_step(model, make_optimizer(model), mesh=mesh)
    return time_ms(lambda: step(xs, gts), reps=3, warmup=1)


def _cli_reports(cli_main, argvs):
    """Each CLI command of ``argvs`` on the running world (this rank's
    report; None on a rank outside the command's mesh), with its seconds."""
    out = {}
    for name, argv in argvs:
        t0 = time.perf_counter()
        report = cli_main(argv)
        out[name] = (report, time.perf_counter() - t0)
    return out


def _dp_rank(mesh, x, gt, argvs, accum_case):
    """A rank of ``phase_dp``'s 2-rank world: the first step of the
    full-width ``1mlp_g2`` (seed 1234, DropPath on) data parallel at batch 4,
    its train step's time, the first step at batch 2 over two micro-batches
    of one row (``accum_case``: rank 1 holds none), then the CLI commands on
    the running world."""
    from focalnet_tpu_torch.main import main as cli_main
    from focalnet_tpu_torch.models import build_net

    model = build_net("1mlp_g2", device=mesh.device,
                      generator=torch.Generator().manual_seed(1234)).train()
    out, (xs, gts) = _first_step(model, mesh, x, gt)
    out.update(rank=mesh.rank, backend=mesh.backend, step_ms=_step_ms(model, mesh, xs, gts))
    del model, xs, gts
    model = build_net("1mlp_g2", device=mesh.device,
                      generator=torch.Generator().manual_seed(1234)).train()
    out["accum"] = _first_step(model, mesh, *accum_case, grad_accum=DP_ACCUM)[0]
    del model
    torch.cuda.empty_cache()
    out["cli"] = _cli_reports(cli_main, argvs)
    return out


def _dpsp_tp_rank(mesh, x, gt, argvs):
    """A rank of ``phase_dpsp_tp``'s 4-rank world (``mesh``: (data, seq) =
    (2, 2)): the first step of the full-width ``1mlp_g2`` dp x sp, its train
    step's time and the CLI commands on the running world; then on a (data,
    model) = (2, 2) mesh of the same ranks the first step with channel-split
    scans and 3 steps (their wall time), after which the parameters'
    digest; then data parallel over the four ranks, the first step over
    DP_ACCUM micro-batches of 2 rows (ranks 2 and 3 hold none)."""
    import hashlib

    from focalnet_tpu_torch.main import main as cli_main
    from focalnet_tpu_torch.models import build_net
    from focalnet_tpu_torch.parallel import make_mesh
    from focalnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    out = {"rank": mesh.rank, "backend": mesh.backend}
    model = build_net("1mlp_g2", device=mesh.device, seq_mesh=mesh, seq_axis="seq",
                      data_axis="data", generator=torch.Generator().manual_seed(1234)).train()
    out["dpsp"], (xs, gts) = _first_step(model, mesh, x, gt)
    out["dpsp"]["step_ms"] = _step_ms(model, mesh, xs, gts)
    del model
    torch.cuda.empty_cache()
    out["cli"] = _cli_reports(cli_main, argvs)

    tp = make_mesh(TP_SHAPE, mesh.device, axes=("data", "model"))
    model = build_net("1mlp_g2", device=mesh.device, seq_mesh=tp, tp_axis="model",
                      data_axis="data", generator=torch.Generator().manual_seed(1234)).train()
    out["tp"], (xs, gts) = _first_step(model, tp, x, gt)
    step = make_train_step(model, make_optimizer(model), mesh=tp)
    t0 = time.perf_counter()
    for _ in range(TP_STEPS):
        step(xs, gts)
    torch.cuda.synchronize()
    out["tp"]["steps_seconds"] = time.perf_counter() - t0
    digest = hashlib.sha256()
    for k, v in model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().numpy().tobytes())
    out["tp"]["param_sha256"] = digest.hexdigest()
    del model, step, xs, gts
    torch.cuda.empty_cache()

    dp = make_mesh((math.prod(TP_SHAPE),), mesh.device)
    model = build_net("1mlp_g2", device=mesh.device,
                      generator=torch.Generator().manual_seed(1234)).train()
    out["dp_accum"] = _first_step(model, dp, x, gt, grad_accum=DP_ACCUM)[0]
    return out


def _check_first_step(name, r, want_loss, want, expected_launches, card, ranks, **fields):
    """Hold one rank's first step against the one-process step: the loss
    within DP_LOSS_RTOL, every gradient under GRAD_TOLS, the launches."""
    rtol, atol = GRAD_TOLS[torch.float32]
    worst, worst_key, max_abs = 0.0, None, 0.0
    for k, w in want.items():
        err, ok = grad_err(torch.from_numpy(r["grads"][k]).cuda(), w, rtol, atol)
        if not ok:
            fail(f"{name} rank {fields.get('rank')}: gradient of {k} vs one process: "
                 f"max abs err {err}")
        max_abs = max(max_abs, err)
        lim = atol * max(1.0, float(w.abs().max()))
        if err / lim > worst:
            worst, worst_key = err / lim, k
    d_loss = abs(r["loss"] - want_loss) / abs(want_loss)
    emit(phase=name, **fields, loss=r["loss"], one_process_loss=want_loss,
         loss_rel_diff=d_loss, params=len(r["grads"]), max_abs_err=max_abs,
         max_err_over_atol=worst, worst_param=worst_key, grad_rtol=rtol, grad_atol=atol,
         launches=r["launches"], expected_launches=expected_launches,
         peak_mem_gb=r["peak_mem_gb"], step_ms=r.get("step_ms"), card=card,
         note=_sp_note(ranks))
    if not d_loss <= DP_LOSS_RTOL:
        fail(f"{name}: loss {r['loss']} vs one process {want_loss}")
    if r["launches"] != expected_launches or len(r["grads"]) != len(want):
        fail(f"{name}: launches (K1, segment K1), (K2, segment K2) {r['launches']}, expected "
             f"{expected_launches}; {len(r['grads'])} gradients")


def _one_process_step(build_net, batch=TRAIN_BATCH, grad_accum=1):
    """The batch (host arrays) and the one-process reference of the mesh
    phases' first step: the loss and gradients of :func:`smooth_loss` of the
    full-width ``1mlp_g2`` (seed 1234, DropPath masks from DP_MASK_SEED) on
    the whole batch, over ``grad_accum`` micro-batches."""
    from focalnet_tpu_torch.models import set_dropout_generator
    from focalnet_tpu_torch.train.trainer import accumulate

    gen = torch.Generator().manual_seed(4321)
    x = torch.rand(batch, 256, 256, 3, generator=gen)
    gt = torch.rand(batch, 256, 256, 3, generator=gen)
    model = build_net("1mlp_g2", device="cuda",
                      generator=torch.Generator().manual_seed(1234)).train()
    set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(DP_MASK_SEED))
    sums = accumulate(model, x.cuda(), gt.cuda(), lambda p, g: (smooth_loss(p, g),),
                      grad_accum, n_terms=1)
    return (x.numpy(), gt.numpy(), float(sums[0] / grad_accum),
            {k: p.grad for k, p in model.named_parameters()})


def _train_argv(tmp, name, mesh_shape=None, extra=()):
    """``--mode train`` of 3 steps at batch 4 and one validation on 2 images
    (``dp_data``), with ``--mesh_shape`` (None: the default)."""
    from focalnet_tpu_torch.data.reside import make_synthetic_dataset

    data = os.path.join(tmp, "dp_data")
    if not os.path.isdir(data):
        make_synthetic_dataset(data, n_train=6, n_test=1, hw=(256, 256), seed=0)
    return ["--mode", "train", "--data_dir", data, "--batch_size", str(TRAIN_BATCH),
            "--crop_size", "256", "--print_freq", "1", "--valid_freq", "1", "--num_worker", "4",
            "--num_epoch", "1", "--model_save_dir", os.path.join(tmp, name),
            "--result_dir", os.path.join(tmp, f"{name}_images"), *extra,
            *(["--mesh_shape", mesh_shape] if mesh_shape is not None else [])]


def _check_train_cli(name, mesh_shape, reports, tmp, card, steps=3, val_images=2,
                     segment=False, step_launches=None):
    """A ``--mode train`` run of 3 steps on a mesh: the ranks' parameter
    digests equal, the K1 and K2 launches of each rank (24 segment calls of
    each a step under a seq axis, 48 dense a step otherwise; 48 dense K1 a
    validated image, the images split over the ranks), finite losses in
    rank 0's log and its ``Mesh:`` line.  ``step_launches``: each rank's
    dense K1 and K2 launches a step, where they differ from 48."""
    size = len(reports)
    per_step = SP_LAUNCHES_PER_FORWARD if segment else LAUNCHES_PER_FORWARD
    got, expected = [], []
    for r, (report, _) in enumerate(reports):
        got.append([report["launches_fwd"], report["segment_launches_fwd"],
                    report["launches_bwd"], report["segment_launches_bwd"]])
        val = LAUNCHES_PER_FORWARD * len(range(r, val_images, size))
        n = (per_step if step_launches is None else step_launches[r]) * steps
        expected.append([n + val, n if segment else 0, n, n if segment else 0])
    digests = [rep["result"]["param_sha256"] for rep, _ in reports]
    with open(os.path.join(tmp, name, "train.metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [(r["pixel_loss"], r["fft_loss"]) for r in rows if "step" in r]
    first = reports[0][0]["stdout"].splitlines()[:1]
    emit(phase=f"{name}_cli", mesh_shape=mesh_shape, ranks=size,
         backend=reports[0][0]["backend"], steps=steps, seconds=reports[0][1], launches=got,
         expected_launches=expected, param_sha256=digests, losses=losses,
         psnr=[r["psnr"] for r in rows if "psnr" in r], first_line=first,
         peak_mem_gb=[rep["peak_mem_gb"] for rep, _ in reports], card=card)
    if got != expected:
        fail(f"--mode train --mesh_shape {mesh_shape}: launches per rank (K1, segment K1, K2, "
             f"segment K2) {got}, expected {expected}")
    if len(set(digests)) != 1:
        fail(f"--mode train --mesh_shape {mesh_shape}: the ranks' parameters differ: {digests}")
    if len(losses) != steps or not all(math.isfinite(v) for r in losses for v in r):
        fail(f"--mode train --mesh_shape {mesh_shape}: losses {losses}")
    shape = dict(zip(("data", "seq"), (int(n) for n in mesh_shape.split(","))))
    if first != [f"Mesh: {shape} over {size} devices"]:
        fail(f"--mode train --mesh_shape {mesh_shape} printed {first} first")


def _infer_forwards(sizes, batch, rank, n_data):
    """Forwards of ``--mode infer`` on rank ``rank`` of ``n_data`` data ranks:
    one per bucket of a padded shape (``batch`` images a bucket) in which the
    rank has rows."""
    from collections import Counter

    count = 0
    for n in Counter((-(-h // 32), -(-w // 32)) for h, w in sizes).values():
        for i in range(0, n, batch):
            if rank < min(batch, n - i):
                count += 1
    return count


def phase_dp(build_net, cli_main, tmp, card, infer_src, infer_sizes, infer_want):
    """Data parallelism with two gloo ranks sharing the card (one spawned
    world):

    - ``dp_grad``: the first batch-4 step (each rank its 2 rows, the whole
      batch's DropPath masks) of the full-width ``1mlp_g2``: loss within
      DP_LOSS_RTOL and every gradient under GRAD_TOLS of the one-process
      step; 48 K1 and 48 K2 launches per rank; the step's time;
    - ``dp_accum``: the first batch-2 step over DP_ACCUM micro-batches of
      one row (rank 1 holds none) against one process over the same
      micro-batches, as ``dp_grad``; 96 K1 and 96 K2 launches on rank 0;
    - ``dp_train_cli``: ``--mode train --mesh_shape 2`` under the bf16
      recipe, 3 steps: equal parameters on both ranks, launches, ``Mesh:``;
    - ``dp_infer_cli``: ``--mode infer`` at ``--mesh_shape 2`` and ``1,2`` on
      ``phase_infer_cli``'s directory: JAX's note first, every PNG within 1
      LSB of the one-process batch-1 run, the launches of each rank.

    Returns rank 0's K1 and K2 launches of the first step."""
    from focalnet_tpu_torch.data.png import read_png
    from focalnet_tpu_torch.parallel import spawn

    x, gt, want_loss, want = _one_process_step(build_net)
    x2, gt2, want_loss2, want2 = _one_process_step(build_net, DP_RANKS, DP_ACCUM)
    infer = {shape: ["--mode", "infer", "--input", infer_src, "--test_model",
                     os.path.join(tmp, "model.pkl"), "--result_dir",
                     os.path.join(tmp, f"dp_infer_{shape}"), "--model_save_dir",
                     os.path.join(tmp, "dp_infer_cfg"), "--mesh_shape", shape]
             for shape in ("2", "1,2")}
    argvs = [("dp_train", _train_argv(tmp, "dp_train", DP_MESH, ["--compute_dtype", "bfloat16",
                                                                  "--ssm_out_dtype", "bfloat16"]))]
    argvs += [(f"infer_{s}", a) for s, a in infer.items()]
    with _stdout_fd_to(os.path.join(tmp, "dp.out")):
        ranks = spawn(_dp_rank, (DP_RANKS,), "cuda", args=(x, gt, argvs, (x2, gt2)),
                      timeout_s=SP_TIMEOUT_S)
    expected = [[LAUNCHES_PER_FORWARD, 0]] * 2
    for r in ranks:
        _check_first_step("dp_grad", r, want_loss, want, expected, card, DP_RANKS,
                          mesh_shape=DP_MESH, rank=r["rank"], backend=r["backend"])
    for r in ranks:  # micro-batches of one row: rank 0 runs both, rank 1 none
        n = DP_ACCUM * LAUNCHES_PER_FORWARD if r["rank"] == 0 else 0
        _check_first_step("dp_accum", r["accum"], want_loss2, want2, [[n, 0]] * 2, card,
                          DP_RANKS, mesh_shape=DP_MESH, batch=DP_RANKS, grad_accum=DP_ACCUM,
                          rank=r["rank"], backend=r["backend"])
    del want2
    _check_train_cli("dp_train", DP_MESH, [r["cli"]["dp_train"] for r in ranks], tmp, card)
    names = sorted(os.listdir(infer_want))
    for shape in infer:
        reports = [r["cli"][f"infer_{shape}"] for r in ranks]
        out_dir = os.path.join(tmp, f"dp_infer_{shape}")
        got_names = sorted(os.listdir(out_dir))
        lsb = (max(int(np.abs(read_png(os.path.join(out_dir, n)).astype(int)
                              - read_png(os.path.join(infer_want, n)).astype(int)).max())
                   for n in names) if got_names == names else None)
        data = int(shape.split(",")[0])
        segment = "," in shape
        forwards = [_infer_forwards(infer_sizes, data, r * data // DP_RANKS, data)
                    for r in range(DP_RANKS)]
        per = SP_LAUNCHES_PER_FORWARD if segment else LAUNCHES_PER_FORWARD
        expected = [[per * f, per * f if segment else 0, 0, 0] for f in forwards]
        got = [[rep["launches_fwd"], rep["segment_launches_fwd"], rep["launches_bwd"],
                rep["segment_launches_bwd"]] for rep, _ in reports]
        note = (f"note: --valid_batch raised to {data} (one image per 'data'-axis device of "
                f"--mesh_shape {shape})")
        printed = reports[0][0]["stdout"].strip().splitlines()
        emit(phase="dp_infer_cli", mesh_shape=shape, ranks=len(reports),
             backend=reports[0][0]["backend"], images=len(names), files=got_names,
             max_png_diff_lsb=lsb, printed=printed, launches=got, expected_launches=expected,
             seconds=reports[0][1], peak_mem_gb=[rep["peak_mem_gb"] for rep, _ in reports],
             card=card, note=_sp_note(DP_RANKS))
        if got_names != names or lsb > 1:
            fail(f"--mode infer --mesh_shape {shape} wrote {got_names}, {lsb} LSB from one "
                 "process")
        if got != expected:
            fail(f"--mode infer --mesh_shape {shape}: launches per rank {got}, expected "
                 f"{expected}")
        if not printed or printed[0] != note:
            fail(f"--mode infer --mesh_shape {shape} printed {printed[:1]}, want {note!r}")
    del want
    torch.cuda.empty_cache()
    return ranks[0]["launches"][0][0], ranks[0]["launches"][1][0]


def phase_dpsp_tp(build_net, cli_main, tmp, card):
    """dp x sp and the channel-split scan with four gloo ranks sharing the
    card (one spawned world, ``(data, seq) = (2, 2)``, and a ``(data,
    model) = (2, 2)`` mesh of the same ranks):

    - ``dpsp_grad``: the first batch-4 step of the full-width ``1mlp_g2``
      against the one-process step (as ``dp_grad``); 24 segment K1 and 24
      segment K2 launches per rank; ``dpsp_train_cli``: ``--mode train
      --mesh_shape 2,2``, 3 steps, as ``dp_train_cli``;
    - ``tp_grad``: the same first step with every SS2D's scans split over
      the channels (``build_net(tp_axis="model")``); 24 K1 and 24 K2 launches
      per rank; then 3 steps, after which the ranks' parameter digests are
      equal;
    - ``dp_accum``: ``--mesh_shape 4 --batch_size 4 --grad_accum 2``, the
      first step data parallel over the four ranks and DP_ACCUM
      micro-batches of 2 rows (ranks 2 and 3 hold none) against one process
      over the same micro-batches, as ``dp_grad`` (96 K1 and 96 K2 launches
      on ranks 0 and 1, none on 2 and 3); then ``dp_accum_train_cli``, 3
      steps of that command through the CLI, as ``dp_train_cli``.

    Returns rank 0's tp launches (K1, K2) of the first step and the tp
    step's ms."""
    from focalnet_tpu_torch.parallel import spawn

    x, gt, want_loss, want = _one_process_step(build_net)
    _, _, accum_loss, accum_want = _one_process_step(build_net, grad_accum=DP_ACCUM)
    n = math.prod(DPSP_SHAPE)
    argvs = [("dpsp_train", _train_argv(tmp, "dpsp_train", "2,2")),
             ("dp_accum_train", _train_argv(tmp, "dp_accum_train", str(n),
                                            ["--grad_accum", str(DP_ACCUM)]))]
    with _stdout_fd_to(os.path.join(tmp, "dpsp_tp.out")):
        ranks = spawn(_dpsp_tp_rank, DPSP_SHAPE, "cuda", args=(x, gt, argvs),
                      timeout_s=SP_TIMEOUT_S)
    for r in ranks:
        _check_first_step("dpsp_grad", r["dpsp"], want_loss, want,
                          [[SP_LAUNCHES_PER_FORWARD] * 2] * 2, card, n, mesh_shape="2,2",
                          rank=r["rank"], backend=r["backend"])
    _check_train_cli("dpsp_train", "2,2", [r["cli"]["dpsp_train"] for r in ranks], tmp, card,
                     segment=True)
    for r in ranks:
        _check_first_step("tp_grad", r["tp"], want_loss, want,
                          [[TP_LAUNCHES_PER_FORWARD, 0]] * 2, card, n,
                          mesh_shape="(data, model) = (2, 2)", rank=r["rank"],
                          backend=r["backend"], steps=TP_STEPS,
                          steps_seconds=r["tp"]["steps_seconds"],
                          param_sha256=r["tp"]["param_sha256"])
    digests = {r["tp"]["param_sha256"] for r in ranks}
    if len(digests) != 1:
        fail(f"tp_grad: after {TP_STEPS} steps the ranks' parameters differ: {digests}")
    # micro-batches of 2 rows over 4 ranks: ranks 0 and 1 one row each, 2 and 3 none
    per_rank = [DP_ACCUM * LAUNCHES_PER_FORWARD if r < TRAIN_BATCH // DP_ACCUM else 0
                for r in range(n)]
    for r in ranks:
        _check_first_step("dp_accum", r["dp_accum"], accum_loss, accum_want,
                          [[per_rank[r["rank"]], 0]] * 2, card, n, mesh_shape=str(n),
                          batch=TRAIN_BATCH, grad_accum=DP_ACCUM, rank=r["rank"],
                          backend=r["backend"])
    _check_train_cli("dp_accum_train", str(n), [r["cli"]["dp_accum_train"] for r in ranks],
                     tmp, card, step_launches=per_rank)
    del want, accum_want
    torch.cuda.empty_cache()
    return ranks[0]["tp"]["launches"][0][0], ranks[0]["tp"]["launches"][1][0]


def phase_mesh_free_cli(cli_main, tmp, ckpt, single_per_image, card, serve_src, serve_want):
    """The mesh commands that the JAX CLI runs without a mesh, in this
    process (``parallel.mesh.spawn`` replaced by a function that fails):
    ``--mode test`` at ``--mesh_shape 4`` and ``2,1`` on ``phase_test_cli``'s
    split print its per-image lines (PSNR within 0.01 dB, SSIM within 1e-4
    of the kernel run as printed) and 48 K1 launches an image, JAX's note
    first at ``2,1``; ``--mode serve --mesh_shape 1,2`` answers one request
    within 1 LSB of the mesh-free server's answer."""
    import focalnet_tpu_torch.parallel.mesh as mesh_mod
    from focalnet_tpu_torch.data.png import read_png
    from focalnet_tpu_torch.ops.selective_scan_cuda import selective_scan_cuda

    def no_spawn(*args, **kwargs):
        fail("a mesh command that JAX runs without a mesh spawned ranks")

    note = ('note: --mode test is batch-1; ignoring the dp axis of --mesh_shape '
            '(use "1,M" for sequence-parallel eval)')
    spawn, mesh_mod.spawn = mesh_mod.spawn, no_spawn
    try:
        for shape in ("4", "2,1"):
            selective_scan_cuda.launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli_main(["--mode", "test", "--data_dir", os.path.join(tmp, "sots"),
                          "--test_model", ckpt, "--result_dir", os.path.join(tmp, "mf_test"),
                          "--model_save_dir", os.path.join(tmp, "mf_cfg"),
                          "--mesh_shape", shape])
            torch.cuda.synchronize()
            text = buf.getvalue()
            per_image, summary = _eval_lines(text)
            d_psnr = max(abs(a[0] - b[0]) for a, b in zip(per_image, single_per_image))
            d_ssim = max(abs(a[1] - b[1]) for a, b in zip(per_image, single_per_image))
            first = text.splitlines()[:1]
            expected = LAUNCHES_PER_FORWARD * len(single_per_image)
            emit(phase="mesh_free_cli", mode="test", mesh_shape=shape, first_line=first,
                 per_image=per_image, max_psnr_diff_db=d_psnr, max_ssim_diff=d_ssim,
                 launches_fwd=selective_scan_cuda.launches, expected_launches=expected,
                 card=card)
            if (first == [note]) != (shape == "2,1"):
                fail(f"--mode test --mesh_shape {shape} printed {first} first")
            if len(per_image) != len(single_per_image) or len(summary) != 3:
                fail(f"--mode test --mesh_shape {shape} printed {per_image} and {summary}")
            if not (d_psnr <= 0.01 + 1e-9 and d_ssim <= 1e-4 + 1e-12):
                fail(f"--mode test --mesh_shape {shape}: PSNR {d_psnr} dB, SSIM {d_ssim} from "
                     "the run without a mesh")
            if selective_scan_cuda.launches != expected:
                fail(f"--mode test --mesh_shape {shape}: {selective_scan_cuda.launches} K1 "
                     f"launches, expected {expected}")
        out_dir = os.path.join(tmp, "mf_serve")
        h, w = read_png(serve_src).shape[:2]
        lines, launches, _, expected = serve_run(cli_main, ckpt, [(serve_src, (h, w))], out_dir,
                                                 ["--mesh_shape", "1,2"], selective_scan_cuda, 1)
        name = os.path.basename(serve_src)
        lsb = int(np.abs(read_png(os.path.join(out_dir, name)).astype(int)
                         - read_png(os.path.join(serve_want, name)).astype(int)).max())
        emit(phase="mesh_free_cli", mode="serve", mesh_shape="1,2", answers=lines,
             max_png_diff_lsb=lsb, launches_fwd=launches, expected_launches=expected, card=card)
        if lsb > 1 or launches != expected:
            fail(f"--mode serve --mesh_shape 1,2: {lsb} LSB from the mesh-free server, "
                 f"{launches} K1 launches (expected {expected})")
    finally:
        mesh_mod.spawn = spawn


def _dp_nccl_rank(mesh, batches):
    """A rank of ``phase_dp_nccl``: for each global batch of ``batches``
    (host arrays), the first step of the full-width ``1mlp_g2`` on this
    rank's rows and its train step's time."""
    from focalnet_tpu_torch.models import build_net

    out = {"rank": mesh.rank, "backend": mesh.backend}
    for x, gt in batches:
        model = build_net("1mlp_g2", device=mesh.device,
                          generator=torch.Generator().manual_seed(1234)).train()
        r, (xs, gts) = _first_step(model, mesh, x, gt)
        r["step_ms"] = _step_ms(model, mesh, xs, gts)
        out[len(x)] = r
        del model, xs, gts
        torch.cuda.empty_cache()
    return out


def phase_dp_nccl(build_net, cli_main, tmp, card, cards):
    """``--sp_only`` on a machine with several cards: data parallelism over
    NCCL, one card a rank, at ``--mesh_shape 2`` and ``4`` (as many as there
    are cards), at batch 4 and 16: the first step against one card's (loss,
    gradients; 48 K1 and 48 K2 launches per rank) and each rank's train step
    time beside one card's at the same batch; then ``--mode train`` with no
    ``--mesh_shape`` (JAX's default: data parallel over every card dividing
    the batch), which must print ``Mesh: {'data': N} over N devices``.
    ``cards``: the machine's card count."""
    from focalnet_tpu_torch.models import set_dropout_generator
    from focalnet_tpu_torch.parallel import spawn
    from focalnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    refs, batches = {}, []
    for batch in DP_NCCL_BATCHES:
        x, gt, loss, want = _one_process_step(build_net, batch)
        model = build_net("1mlp_g2", device="cuda",
                          generator=torch.Generator().manual_seed(1234)).train()
        set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(DP_MASK_SEED))
        step = make_train_step(model, make_optimizer(model))
        xs, gts = torch.from_numpy(x).cuda(), torch.from_numpy(gt).cuda()
        one_ms = time_ms(lambda: step(xs, gts), reps=3, warmup=1)
        refs[batch] = (loss, {k: v.cpu() for k, v in want.items()}, one_ms)
        batches.append((x, gt))
        del model, step, xs, gts, want
        torch.cuda.empty_cache()
    for n in (2, 4):
        if n > cards:
            continue
        with _stdout_fd_to(os.path.join(tmp, f"dp_nccl_{n}.out")):
            ranks = spawn(_dp_nccl_rank, (n,), "cuda", args=(batches,), timeout_s=SP_TIMEOUT_S)
        for batch in DP_NCCL_BATCHES:
            loss, want, one_ms = refs[batch]
            for r in ranks:
                _check_first_step("dp_nccl", r[batch], loss, {k: v.cuda() for k, v in want.items()},
                                  [[LAUNCHES_PER_FORWARD, 0]] * 2, card, n, mesh_shape=str(n),
                                  rank=r["rank"], backend=r["backend"], batch=batch,
                                  one_card_step_ms=one_ms)
    if cards < 2:
        return
    t0 = time.perf_counter()
    with _stdout_fd_to(os.path.join(tmp, "dp_auto.out")):
        reports = cli_main(_train_argv(tmp, "dp_auto"))
    seconds = time.perf_counter() - t0
    n = len(reports)
    first = reports[0]["stdout"].splitlines()[:1]
    emit(phase="dp_auto_cli", ranks=n, backend=reports[0]["backend"], first_line=first,
         seconds=seconds, launches=[[r["launches_fwd"], r["launches_bwd"]] for r in reports],
         param_sha256=[r["result"]["param_sha256"] for r in reports], card=card)
    want_n = max(k for k in range(1, cards + 1) if TRAIN_BATCH % k == 0)
    if first != [f"Mesh: {{'data': {want_n}}} over {want_n} devices"] or n != want_n:
        fail(f"--mode train with the default mesh on {cards} cards printed {first} on {n} ranks")
    if len({r["result"]["param_sha256"] for r in reports}) != 1:
        fail("--mode train with the default mesh: the ranks' parameters differ")


def serve_run(main, ckpt, requests, out_dir, extra, ss_cuda, expect_forwards):
    """One ``--mode serve`` run through the CLI entry point, in this
    process so that the kernel's launch count is visible."""
    req = "".join(f"{p}\t{os.path.join(out_dir, os.path.basename(p))}\n" for p, _ in requests)
    out = io.StringIO()
    ss_cuda.launches = 0
    t0 = time.perf_counter()
    main(["--mode", "serve", "--test_model", ckpt, "--result_dir", out_dir,
          "--model_save_dir", os.path.join(out_dir, "cfg")] + extra,
         inp=io.StringIO(req), out=out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ss_cuda.launches
    lines = out.getvalue().splitlines()
    if not lines or lines[0] != "READY":
        fail(f"serve did not print READY first: {lines[:3]}")
    if len(lines) != 1 + len(requests) or any(not ln.startswith("OK\t") for ln in lines[1:]):
        fail(f"serve answered {lines[1:]}")
    return lines[1:], launches, seconds, expect_forwards * LAUNCHES_PER_FORWARD


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "focalnet_tpu_torch")):
        fail("focalnet_tpu_torch/ is not beside this script: run it from a checkout")
    sys.path.insert(0, ROOT)
    from focalnet_tpu_torch.data import native_loader
    from focalnet_tpu_torch.data.png import read_png, write_png
    from focalnet_tpu_torch.main import main as cli_main
    from focalnet_tpu_torch.models import build_net
    from focalnet_tpu_torch.ops import _build
    from focalnet_tpu_torch.ops.fma_passes import SOURCE as SOURCE_FMA
    from focalnet_tpu_torch.ops.fma_passes import build as build_fma
    from focalnet_tpu_torch.ops.fma_passes import fma_passes_cuda, fma_passes_ref
    from focalnet_tpu_torch.ops.scan_bwd_ref import selective_scan_bwd_ref
    from focalnet_tpu_torch.ops.selective_scan import selective_scan
    from focalnet_tpu_torch.benchmarks.scan_bwd_split import BASELINE_COMMITS, baseline_source
    from focalnet_tpu_torch.ops.scan_bwd_ref import chunk_states_ref
    from focalnet_tpu_torch.ops.selective_scan_cuda import (
        SOURCE,
        SOURCE_BWD,
        bind_bwd,
        bind_fwd,
        build,
        build_bwd,
        bwd_tile_channels,
        fwd_launched_tile,
        fwd_tile_channels,
        selective_scan_bwd_cuda,
        selective_scan_cuda,
    )
    from focalnet_tpu_torch.utils import save_checkpoint
    from focalnet_tpu_torch.utils.device import nvidia_smi as smi

    counters = (selective_scan_cuda, selective_scan_bwd_cuda)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    emit(phase="device", nvidia_smi=card, kind=kind, count=count, sms=sms,
         max_sm_clock_mhz=clock_mhz, torch=torch.__version__, cuda=torch.version.cuda,
         triton=has_triton, cuda_home=os.environ.get("CUDA_HOME"),
         nvcc=_build.find_nvcc(), python=sys.version.split()[0])
    if "--sp_only" in sys.argv[1:]:
        run_sp_only(cli_main, build_net, save_checkpoint, card)
        print(card, flush=True)
        emit(ok=True, device={"platform": "gpu", "kind": kind, "count": count})
        return

    # 2. build from the checkout's sources: one nvcc per kernel, in parallel
    def timed_build(fn):
        t0 = time.perf_counter()
        lib = fn()
        return time.perf_counter() - t0, lib

    # K1 and K2 before the channel tiles, for their times beside the kernels'
    # (not committed: from the checkout's history, or put under
    # _build/baseline/ beforehand)
    base_src = {k: baseline_source(k) for k in ("fwd", "bwd")}
    builds = [(SOURCE, _build.CSRC_DIR, build), (SOURCE_BWD, _build.CSRC_DIR, build_bwd),
              (SOURCE_FMA, _build.CSRC_DIR, build_fma)]
    for k, path in base_src.items():
        if path:
            d, src = os.path.split(path)
            bind = bind_fwd if k == "fwd" else bind_bwd
            builds.append((src, d, lambda d=d, src=src, bind=bind: bind(_build.load_library(src, d))))
    prebuilt = [os.path.exists(_build.library_path(src, d)) for src, d, _ in builds]
    with ThreadPoolExecutor(len(builds) + 1) as ex:
        # the native data loader (host C++, g++) beside the kernels
        loader_build = ex.submit(timed_build, native_loader.get_lib)
        futures = [ex.submit(timed_build, fn) for _, _, fn in builds]
        results = [f.result() for f in futures]
        loader_secs, _ = loader_build.result()
    flags = native_loader.link_flags()
    emit(phase="build", source=os.path.relpath(native_loader.SOURCE, ROOT), seconds=loader_secs,
         compiler=_build.find_cxx(), flags=list(_build.CXX_FLAGS) + flags,
         library=os.path.relpath(_build.host_library_path(native_loader.SOURCE, flags), ROOT),
         codecs=native_loader.build_info())
    for (src, d, _), pre, (secs, _) in zip(builds, prebuilt, results):
        lib_path = _build.library_path(src, d)
        with open(lib_path + ".log") as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        emit(phase="build", source=os.path.relpath(os.path.join(d, src), ROOT),
             seconds=secs, prebuilt=pre, library=os.path.relpath(lib_path, ROOT), ptxas=ptxas)
    built = {os.path.join(d, src): lib for (src, d, _), (_, lib) in zip(builds, results)}
    baselines = {k: built.get(path) for k, path in base_src.items()}
    for k, path in base_src.items():
        emit(phase="baseline", kernel=k, commit=BASELINE_COMMITS[k], built=path is not None,
             note=None if path else "no history and no copy under _build/baseline/: "
             f"the {k} kernel is timed alone")

    # 3. kernels vs plain, and times
    worst, timing = phase_kernel(selective_scan, selective_scan_cuda, chunk_states_ref,
                                 fwd_tile_channels, fwd_launched_tile, baselines["fwd"],
                                 clock_mhz, sms)
    worst_eval, timing_eval = phase_kernel_eval(selective_scan, selective_scan_cuda,
                                                fwd_tile_channels, fwd_launched_tile,
                                                clock_mhz, sms)
    worst = max(worst, worst_eval)
    worst_bwd, timing_bwd = phase_kernel_bwd(
        selective_scan, selective_scan_cuda, selective_scan_bwd_cuda,
        selective_scan_bwd_ref, bwd_tile_channels, baselines["bwd"], clock_mhz, sms)

    worst_new, worst_bwd_new, timing_new = phase_kernel_new_lengths(
        selective_scan, selective_scan_cuda, selective_scan_bwd_cuda, selective_scan_bwd_ref,
        chunk_states_ref, fwd_tile_channels, fwd_launched_tile, clock_mhz, sms)
    worst, worst_bwd = max(worst, worst_new), max(worst_bwd, worst_bwd_new)

    worst_fma, timing_fma = phase_kernel_probe(fma_passes_cuda, fma_passes_ref)

    worst_seg, worst_seg_bwd, timing_seg = phase_kernel_segment(
        selective_scan, selective_scan_cuda, selective_scan_bwd_cuda, selective_scan_bwd_ref,
        chunk_states_ref, clock_mhz, sms)

    worst_tp, worst_tp_bwd, timing_tp = phase_kernel_tp(
        selective_scan, selective_scan_cuda, selective_scan_bwd_cuda, selective_scan_bwd_ref,
        clock_mhz, sms)

    timing_mamba = phase_kernel_mamba(selective_scan, selective_scan_cuda,
                                      selective_scan_bwd_cuda, selective_scan_bwd_ref,
                                      clock_mhz, sms)
    worst = max([worst] + [t[4] for (k, _), t in timing_mamba.items() if k == "fwd"])
    worst_bwd = max([worst_bwd] + [t[4] for (k, _), t in timing_mamba.items() if k == "bwd"])

    # 4. the FMA-rate probe's path, with launch counts
    peak_tflops = 2 * FMA_LANES_PER_SM * sms * clock_mhz * 1e6 / 1e12
    probe_launches, jax_pair, wide = phase_vpu_probe(
        counters + (fma_passes_cuda,), fma_passes_cuda, selective_scan_bwd_cuda,
        selective_scan_cuda, peak_tflops)

    # 5. serve at full width through the CLI
    rng = np.random.default_rng(1234)
    with tempfile.TemporaryDirectory() as tmp:
        model = build_net("1mlp_g2", device="cuda",
                          generator=torch.Generator().manual_seed(1234))
        ckpt = os.path.join(tmp, "model.pkl")
        save_checkpoint(ckpt, model.state_dict())
        requests = []
        for i, (h, w) in enumerate([(256, 256), (256, 256), (250, 310), (300, 400)]):
            path = os.path.join(tmp, f"req{i}_{h}x{w}.png")
            write_png(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            requests.append((path, (h, w)))
        for mode, reqs, extra, forwards in (
            ("whole_image", requests[:3], [], 3),
            ("tile_256", requests[3:], ["--tile", "256"], 1 + 4),  # warm-up + 4 tiles
        ):
            out_dir = os.path.join(tmp, mode)
            selective_scan_bwd_cuda.launches = 0
            lines, launches, seconds, expected = serve_run(
                cli_main, ckpt, reqs, out_dir, extra, selective_scan_cuda, forwards)
            for ln, (_, (h, w)) in zip(lines, reqs):
                img = read_png(ln.split("\t")[1])
                if img.shape != (h, w, 3):
                    fail(f"{mode}: answer {ln} has shape {img.shape}, want {(h, w, 3)}")
            emit(phase="serve", mode=mode, requests=len(reqs), answers=lines,
                 launches=launches, expected_launches=expected,
                 launches_bwd=selective_scan_bwd_cuda.launches, seconds=seconds)
            if launches != expected or selective_scan_bwd_cuda.launches:
                fail(f"{mode}: {launches} forward and {selective_scan_bwd_cuda.launches} "
                     f"backward kernel launches, expected {expected} and 0")
            if mode == "whole_image":
                serve_launches = launches

        # 6. whole forward, kernel vs plain scan, on the card: 256x256, and
        # 480x640 (SOTS-indoor's 460x620 padded: the eval slice's shape)
        plain = build_net("1mlp_g2", device="cuda", scan_backend="chunked")
        plain.load_state_dict(model.state_dict(), strict=True)
        phase_forward("forward_256", "profile", model, plain, (256, 256), rng,
                      selective_scan_cuda, card, smi, reps=20, plain_reps=20)
        fwd640_launches = phase_forward("forward_640", "profile_640", model, plain, (480, 640),
                                        rng, selective_scan_cuda, card, smi, reps=10,
                                        plain_reps=3)
        del model, plain
        torch.cuda.empty_cache()

        # 6b. --mode test (SOTS-indoor protocol) and --mode infer through the CLI
        test_avg_time, test_launches, test_per_image = phase_test_cli(cli_main, counters, tmp,
                                                                      ckpt, card)
        infer_launches = phase_infer_cli(cli_main, counters, tmp, ckpt, rng)

        # 7. whole gradient and train step at batch 4, 256x256
        step_ms = phase_grad(build_net, counters, card)

        # 8. train through the CLI, then resume
        train_launches = phase_train_cli(cli_main, counters, tmp)

        # 8a. the native loader against its plain versions, timed; then one
        # epoch of --mode train at RESIDE-ITS's image size through it
        its_root, _ = phase_loader(tmp, card)
        its_launches = phase_train_its_cli(cli_main, counters, its_root, tmp, step_ms, card)

        # 8b. sequence parallelism, --mesh_shape 1,2: --mode test and train
        sp_test_launches, sp_test_time = phase_sp_test_cli(cli_main, tmp, ckpt,
                                                           test_per_image, card)
        sp_launches = phase_sp_train(build_net, cli_main, tmp, card)

        # 8c. the rest of parallelism: the mesh commands that run without a
        # mesh, data parallelism with sharded --mode infer, dp x sp and the
        # channel-split scan (two and four ranks sharing the card)
        infer_src = os.path.join(tmp, "infer_in")
        phase_mesh_free_cli(cli_main, tmp, ckpt, test_per_image, card,
                            os.path.join(infer_src, "img4_250x310.png"),
                            os.path.join(tmp, "infer_serve"))
        dp_launches = phase_dp(build_net, cli_main, tmp, card, infer_src, INFER_SIZES,
                               os.path.join(tmp, "infer_batch1"))
        tp_launches = phase_dpsp_tp(build_net, cli_main, tmp, card)

        # 9. the other three presets: forwards, train steps, and through the CLI
        preset_launches = phase_presets(build_net, counters, card, smi, rng)
        phase_preset_cli(cli_main, counters, tmp)

        # 10. the bf16 recipe: forwards, the step, memory, and --mode train
        phase_bf16(build_net, counters, card, smi, rng)
        phase_bf16_train_cli(cli_main, counters, tmp)

        # 10b. the SS2D variants and MambaSS2D (Mamba1D's scan: 384 channels
        # in one group) at full width
        variant_launches = phase_variants(build_net, counters, card, smi, rng)
        mamba_fwd_launches, mamba_step_launches = phase_mamba(counters, card)

        # 11. TF32 off (the port's setting) against on, measured
        phase_tf32(build_net, card)

    print(card, flush=True)
    entries = []
    for name, src, line, t, err, launches, tile_of in (
        ("selective_scan_fwd", SOURCE, 347, timing, worst, train_launches[0], fwd_tile_channels),
        ("selective_scan_bwd", SOURCE_BWD, 421, timing_bwd, worst_bwd, train_launches[1],
         bwd_tile_channels),
    ):
        ms, plain_ms, b, by, base_ms = t[(1, PATH_LS[0], False)]
        ms4, plain_ms4, b4, _, base_ms4 = t[(TRAIN_BATCH, PATH_LS[0], False)]
        entries.append(dict(
            name=name, route="cuda", source=f"focalnet_tpu_torch/ops/csrc/{src}",
            replaces=f"focalnet_tpu/ops/pallas_scan.py:{line}",
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, library_ms=None,
            shape=f"B=1 D=192 N=16 L={PATH_LS[0]} fp32, forward direction",
            ms_b4_l16384=ms4, plain_ms_b4_l16384=plain_ms4, bound_ms_b4_l16384=b4,
            baseline_ms=base_ms, baseline_ms_b4_l16384=base_ms4,
            tile_channels=tile_of(1, 192), tile_channels_b4=tile_of(TRAIN_BATCH, 192),
        ))
    for e, n in zip(entries, its_launches):
        e["launches_train_its_cli"] = n
    entries[0]["launches_serve_3_requests"] = serve_launches
    entries[0]["launches_forward_640"] = fwd640_launches
    entries[0]["launches_test_cli"] = test_launches
    entries[0]["launches_infer_cli_batch1"] = infer_launches
    entries[0]["eval_lengths"] = [
        dict(batch=b, L=L, reverse=rev, ms=t[0], plain_ms=t[1], bound_ms=t[2], bound_by=t[3])
        for (b, L, rev), t in sorted(timing_eval.items())]
    entries[0]["test_cli_average_time_s"] = test_avg_time
    entries[0]["launches_forward_256_by_preset"] = preset_launches
    for e, which in zip(entries, ("fwd", "bwd")):
        e["new_lengths_and_bf16"] = [
            dict(batch=b, L=L, reverse=rev, dtype=dt, ms=t[0], plain_ms=t[1], bound_ms=t[2],
                 bound_by=t[3])
            for (k, b, L, rev, dt), t in sorted(timing_new.items()) if k == which]
    entries[0]["launches_vpu_probe"] = probe_launches["selective_scan_cuda"]
    entries[0]["launches_variant_forward_256"] = variant_launches
    entries[0]["launches_mamba_forward"] = mamba_fwd_launches[0]
    for e, which, n in zip(entries, ("fwd", "bwd"), mamba_step_launches):
        e["launches_mamba_step"] = n
        e["mamba_d384_g1_l16384"] = [
            dict(batch=b, ms=t[0], plain_ms=t[1], bound_ms=t[2], bound_by=t[3],
                 max_abs_err=t[4])
            for (k, b), t in sorted(timing_mamba.items()) if k == which]
    for e, n in zip(entries, dp_launches):
        e["launches_dp_step_per_rank"] = n
    for name, src, line, err, launches, which in (
        ("selective_scan_fwd_segment", SOURCE, 347, worst_seg, sp_launches[0], "fwd"),
        ("selective_scan_bwd_segment", SOURCE_BWD, 421, worst_seg_bwd, sp_launches[1], "bwd"),
    ):
        ms, dense_ms, plain_ms, b, by = timing_seg[(which, TRAIN_BATCH, SP_LS[TRAIN_BATCH][0])]
        entries.append(dict(
            name=name, route="cuda", source=f"focalnet_tpu_torch/ops/csrc/{src}",
            replaces=f"focalnet_tpu/ops/pallas_scan.py:{line}", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            library_ms=None,
            shape=f"B={TRAIN_BATCH} D={SP_DIM} G={SP_GROUPS} N=16 L={SP_LS[TRAIN_BATCH][0]} "
                  "fp32, forward direction, with chunk states (a rank's call in the "
                  f"--mesh_shape {SP_MESH} train step)",
            dense_ms=dense_ms, launches_per_rank_note="rank 0 of --mode train --mesh_shape "
            f"{SP_MESH}, 3 steps",
            lengths=[dict(batch=k[1], L=k[2], ms=t[0], dense_ms=t[1], plain_ms=t[2],
                          bound_ms=t[3], bound_by=t[4])
                     for k, t in sorted(timing_seg.items()) if k[0] == which],
        ))
    entries[-2]["launches_sp_test_cli"] = sp_test_launches
    entries[-2]["sp_test_cli_average_time_s"] = sp_test_time
    for name, src, line, err, launches, which in (
        ("selective_scan_fwd_tp", SOURCE, 347, worst_tp, tp_launches[0], "fwd"),
        ("selective_scan_bwd_tp", SOURCE_BWD, 421, worst_tp_bwd, tp_launches[1], "bwd"),
    ):
        ms, _, plain_ms, b, by = timing_tp[("sub_group", which, PATH_LS[0])]
        entries.append(dict(
            name=name, route="cuda", source=f"focalnet_tpu_torch/ops/csrc/{src}",
            replaces=f"focalnet_tpu/ops/pallas_scan.py:{line}", launches=launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            library_ms=None,
            shape=f"B={TRAIN_BATCH} D=2x96 G={TP_SUB_GROUPS} N=16 L={PATH_LS[0]} fp32, forward "
                  "direction" + (", with y_accum" if which == "fwd" else "")
                  + " (a sub-group shard of the channel-split scan)",
            launches_per_rank_note="rank 0's first step on the (data, model) = (2, 2) mesh",
            shards=[dict(shard=k[0], L=k[2], ms=t[0], plain_launch_ms=t[1], plain_ms=t[2],
                         bound_ms=t[3], bound_by=t[4])
                    for k, t in sorted(timing_tp.items()) if k[1] == which],
        ))
    P = 8 * PROBE_PATH_LOOPS[1]
    ms, plain_ms, b, by = timing_fma[P]
    entries.append(dict(
        name="fma_passes", route="cuda", source=f"focalnet_tpu_torch/ops/csrc/{SOURCE_FMA}",
        replaces="benchmarks/vpu_probe.py:42", launches=probe_launches["fma_passes_cuda"],
        max_abs_err=worst_fma, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
        library_ms=None, shape=f"B=4 D=192 L=16384 fp32, P={P} passes",
        probe_fma_tflops=wide["probe_fma_tflops"],
        probe_fma_tflops_jax_pair=jax_pair["probe_fma_tflops"],
        peak_fma_tflops=peak_tflops,
    ))
    emit(kernels=entries)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": count})


if __name__ == "__main__":
    main()
