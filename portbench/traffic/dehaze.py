"""Dehazing requests: a closed loop of one client, which sends its next
image when the last came back, as ``--mode serve``, ``--mode test`` and
``--mode infer`` go through images one by one.

A request is one hazy uint8 image of ``hw`` from a pool of ``pool`` images
made from the seed (held in host memory and cycled), reflect-padded to a
multiple of ``factor`` (``evaluation.metrics.pad_to_multiple``), dehazed
by ``evaluation.infer.u8_forward`` (uint8 upload, x / 255 on the card),
and its full-scale output copied to the host, cropped and clipped to [0, 1]:
serve's path.  Its latency runs from the hand-over of the uint8 image to
the clipped result in host memory.

The check: a reservoir sample of ``sample`` requests of the window, drawn
from the seed, each against the plain reference's output for its image;
the number compared is the largest absolute difference of a pixel.

Mix parameters: ``hw``, ``pool``, ``factor``, ``sample``, ``traced``
(requests in the traced stretch).
"""

from __future__ import annotations

import time

import numpy as np

from portbench import counts, data, harness, trace
from portbench.traffic import common


def _ref_pad(img: np.ndarray, factor: int) -> np.ndarray:
    """Reflect-pad (H, W, 3) on the bottom and right up to multiples of
    ``factor`` (the published test script's padding)."""
    h, w = img.shape[:2]
    H, W = -(-h // factor) * factor, -(-w // factor) * factor
    return np.pad(img, ((0, H - h), (0, W - w), (0, 0)), mode="reflect")


def run(run, seconds, device="cuda", control=None, fault=None, t_start=None):
    import torch

    from focalnet_tpu_torch.evaluation.infer import u8_forward
    from focalnet_tpu_torch.evaluation.metrics import pad_to_multiple

    mix, cfg = run.cell.mix, run.cell.config
    if fault not in (None, "answer"):
        raise ValueError(f"the dehaze mix has no fault {fault!r}")
    dev = torch.device(device)
    t0 = time.perf_counter()
    _, hazy = data.scenes(run.seed, mix["pool"], 1, mix["hw"])
    pool = list(hazy[:, 0])
    run.phases["data"] = time.perf_counter() - t0
    model, state = common.build(cfg, run.seed, dev, control)
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
    for k in range(2):  # the cell's one shape, twice
        request(k, keep=False)
    run.attempted = run.failed = 0
    run.latencies_ms.clear()
    common.reset_peak(run, dev)
    sync()
    run.setup_s = time.perf_counter() - t_start
    nxt = harness.window(run, request, seconds, sync)
    run.window_peak_bytes = common.peak(run, dev)
    if run.trace_on:
        lat, counted = len(run.latencies_ms), (run.attempted, run.failed)  # the window's

        def stretch(n):
            nonlocal nxt
            for _ in range(n):
                request(nxt, keep=False)
                nxt += 1

        t0 = time.perf_counter()
        run.trace, run.labels = trace.traced(stretch, mix["traced"], sync, labelled=2)
        run.phases["trace"] = time.perf_counter() - t0
        run.attempted, run.failed = counted
        del run.latencies_ms[lat:]
        common.peak(run, dev)
    shape_cfg = common.shape_cfg(cfg)
    hw_pad = tuple(-(-x // mix["factor"]) * mix["factor"] for x in mix["hw"])
    run.bounds_s = {k: counts.scan_bound_s(shape_cfg, hw_pad, 1, k) for k in ("k1",)}
    del model, fwd
    common.free(dev)

    t0 = time.perf_counter()
    # the check: the sampled answers against the reference's
    from portbench.reference import model as ref

    common.fp32_only()
    params = {k: v.to(dev) for k, v in state.items()}
    gap = 0.0
    with torch.no_grad():
        for _, k, out in sample:
            x = torch.from_numpy(_ref_pad(pool[k], mix["factor"])[None]).to(dev).float() / 255.0
            want = ref.forward(params, x, shape_cfg)[2][0, :h, :w].clamp(0, 1).cpu().numpy()
            gap = max(gap, float(np.abs(out - want).max()))
    run.numbers = {"out_gap": gap if sample else float("inf")}
    run.phases["check"] = time.perf_counter() - t0
    run.flops_per_image = counts.model_flops(state, shape_cfg, hw_pad, 1)
