"""Denoising requests: a closed loop of one client, which sends its next image
when the last came back, as ``--mode serve`` and ``--mode infer`` go through
photographs one by one.

A request is one noisy uint8 image of ``hw`` from a pool of ``pool`` images
made from the seed (held in host memory and cycled): a clean scene of
``data.scenes`` with Gaussian noise of std ``sigma``/255 added from the seed,
quantised to uint8.  It is padded to a multiple of ``factor``
(``evaluation.metrics.pad_to_multiple``; 1 for MambaIR, which pads to
nothing), denoised by ``evaluation.infer.u8_forward`` (uint8 upload, x / 255
on the card), and its output copied to the host, cropped and clipped to [0,
1].  Its latency runs from the hand-over of the uint8 image to the clipped
result in host memory.

The check: a reservoir sample of ``sample`` requests of the window, drawn
from the seed, each against the plain reference's output
(``reference/mambair.py``) for its image; the number compared is the
largest absolute difference of a pixel.

Traced, besides the stretch of ``traced`` requests that ``trace.traced``
reads: from a profile of ``spans`` requests of its own, the device time per
request of the kernels launched inside the model's ``mambair.ss2d`` and
``mambair.cab`` ranges (``trace.py`` leaves such ranges out).  Where the
program has no such ranges they read nothing.

Mix parameters: ``hw``, ``pool``, ``sigma``, ``factor``, ``sample``,
``traced``, ``spans``.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np

from portbench import counts_mambair, data, harness, trace, weights_mambair
from portbench.traffic import common
from portbench.traffic.dehaze import _ref_pad

RANGES = ("mambair.ss2d", "mambair.cab")


def noisy_pool(seed: int, mix: dict):
    """(clean, noisy): ``pool`` uint8 scenes of ``hw`` and their noisy
    versions."""
    clean, _ = data.scenes(seed, mix["pool"], 1, mix["hw"])
    noise = data.rng(seed, 3).normal(0.0, mix["sigma"], clean.shape)
    return clean, np.clip(np.round(clean + noise), 0, 255).astype(np.uint8)


def check_config(model_cfg, cfg: dict) -> None:
    """The model built must be the configuration's file: every size the
    file states."""
    ss2d = model_cfg.embed_dim, model_cfg.ssm_ratio
    got = {"embed_dim": model_cfg.embed_dim, "depths": list(model_cfg.depths),
           "ssm_d_state": model_cfg.ssm_d_state, "ssm_ratio": model_cfg.ssm_ratio,
           "d_inner": int(ss2d[1] * ss2d[0]), "dt_rank": -(-ss2d[0] // 16),
           "compress_ratio": model_cfg.compress_ratio,
           "squeeze_factor": model_cfg.squeeze_factor, "img_range": model_cfg.img_range,
           "rgb_mean": list(model_cfg.rgb_mean)}
    wrong = {k: (v, cfg[k]) for k, v in got.items() if k in cfg and v != cfg[k]}
    if wrong:
        raise ValueError(f"the model built differs from the configuration: {wrong}")


def build(cfg: dict, seed: int, dev, control=None):
    """The program's model of ``cfg`` on ``dev`` with the weights of the
    seed (``weights_mambair.make``), and those weights: the preset with every
    size of its config that the file states, then the file's overrides;
    overrides that the preset's config lacks (another model's sizes) are
    left out.  The shapes come from the program's ``build_net`` on the meta
    device; the network is then made on ``dev`` and the weights drawn there
    loaded into it, with no draw on the host that they would replace."""
    import torch

    from focalnet_tpu_torch.configs import PRESETS
    from focalnet_tpu_torch.models import build_net, model_class

    fields = {f.name for f in dataclasses.fields(PRESETS[cfg["preset"]])}
    sizes = {k: v for k, v in {**cfg, **cfg.get("overrides", {})}.items() if k in fields}
    meta = build_net(cfg["preset"], device="meta", **sizes)
    check_config(meta.cfg, cfg)
    state = weights_mambair.make({k: tuple(v.shape) for k, v in meta.state_dict().items()},
                                 common.weight_seed(seed), dev)
    with torch.device(dev):
        model = model_class(cfg["preset"])(meta.cfg)
    model.load_state_dict(state)
    model.eval()
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif control is None:
        common.fp32_only()
    else:
        raise ValueError(f"no control {control!r}")
    return model, state


def range_device_ms(stretch, n: int, sync) -> dict:
    """{range: device ms per request} of the kernels that ran inside each of
    ``RANGES`` on the card over ``n`` requests: within the range's spans on
    the device's timeline, which cover the kernels launched inside it (K1's
    too, whose launch no operator of PyTorch's holds); a range that ran
    nothing on the card is left out."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stretch(n)
        sync()
    spans, kernels = {r: [] for r in RANGES}, []
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        span = (float(e.time_range.start), float(e.time_range.end))
        if e.name in RANGES:
            spans[e.name].append(span)
        elif not getattr(e, "is_user_annotation", False) and \
                not e.name.startswith(trace.COPY_PREFIXES):
            kernels.append(span)
    out = {}
    for r, sp in spans.items():
        sp = trace.union(sp)
        starts = [a for a, _ in sp]
        us = 0.0
        for s, e in kernels:
            i = bisect.bisect_right(starts, (s + e) / 2) - 1
            if i >= 0 and (s + e) / 2 <= sp[i][1]:
                us += e - s
        if us > 0:
            out[r] = us / 1e3 / n
    return out


def run(run, seconds, device="cuda", control=None, fault=None, t_start=None):
    import torch

    from focalnet_tpu_torch.evaluation.infer import u8_forward
    from focalnet_tpu_torch.evaluation.metrics import pad_to_multiple

    mix, cfg = run.cell.mix, run.cell.config
    if fault not in (None, "answer"):
        raise ValueError(f"the denoise mix has no fault {fault!r}")
    dev = torch.device(device)
    t0 = time.perf_counter()
    _, noisy = noisy_pool(run.seed, mix)
    pool = list(noisy)
    run.phases["data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, state = build(cfg, run.seed, dev, control)
    run.phases["build"] = time.perf_counter() - t0
    fwd = u8_forward(model, dev)
    h, w = mix["hw"]
    pick = data.rng(run.seed, 2)
    sample = []  # reservoir: (request index, pool index, output)

    def request(i: int, keep: bool = True) -> int:
        img = pool[i % len(pool)]
        t0 = time.perf_counter()
        run.attempted += 1
        try:
            padded, _ = pad_to_multiple(img[None], mix["factor"])
            pred = fwd(padded)[0].cpu().numpy()
            out = np.clip(pred[:h, :w], 0.0, 1.0)
        except Exception as e:  # counted against the attempts; the run goes on
            run.failed += 1
            print(f"request {i} failed: {type(e).__name__}: {e}", flush=True)
            return 0
        run.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        if fault == "answer":  # an answer altered where it is produced
            out[h // 2, w // 2, 0] += 1.0 / 255.0
        if keep:
            n = i + 1
            if len(sample) < mix["sample"]:
                sample.append((i, i % len(pool), out))
            elif pick.random() < mix["sample"] / n:
                sample[int(pick.integers(len(sample)))] = (i, i % len(pool), out)
        return 1

    sync = common.syncer(dev)
    t0 = time.perf_counter()
    for k in range(2):  # the cell's one shape, twice
        request(k, keep=False)
    sync()
    run.phases["warm"] = time.perf_counter() - t0
    run.attempted = run.failed = 0
    run.latencies_ms.clear()
    common.reset_peak(run, dev)
    sync()
    run.setup_s = time.perf_counter() - t_start
    nxt = harness.window(run, request, seconds, sync)
    run.window_peak_bytes = common.peak(run, dev)
    run.spans = {}  # the per-layer numbers of the traced run, for the readers
    if run.trace_on:
        lat, counted = len(run.latencies_ms), (run.attempted, run.failed)  # the window's

        def stretch(n):
            nonlocal nxt
            for _ in range(n):
                request(nxt, keep=False)
                nxt += 1

        t0 = time.perf_counter()
        run.trace, run.labels = trace.traced(stretch, mix["traced"], sync, labelled=1)
        if dev.type == "cuda":
            run.spans.update(range_device_ms(stretch, mix["spans"], sync))
        run.phases["trace"] = time.perf_counter() - t0
        run.attempted, run.failed = counted
        del run.latencies_ms[lat:]
        common.peak(run, dev)
    hw_pad = tuple(-(-x // mix["factor"]) * mix["factor"] for x in mix["hw"])
    run.bounds_s = {"k1": counts_mambair.scan_bound_s(cfg, hw_pad, 1)}
    run.flops_per_image = counts_mambair.model_flops(cfg, hw_pad, 1)
    del model, fwd
    common.free(dev)

    t0 = time.perf_counter()
    # the check: the sampled answers against the reference's
    from portbench.reference import mambair as ref

    common.fp32_only()
    params = {k: v.to(dev) for k, v in state.items()}
    gap = 0.0
    with torch.no_grad():
        for _, k, out in sample:
            x = torch.from_numpy(_ref_pad(pool[k], mix["factor"])[None]).to(dev).float() / 255.0
            want = ref.forward(params, x, cfg)[0, :h, :w].clamp(0, 1).cpu().numpy()
            gap = max(gap, float(np.abs(out - want).max()))
    run.numbers = {"out_gap": gap if sample else float("inf")}
    run.phases["check"] = time.perf_counter() - t0
