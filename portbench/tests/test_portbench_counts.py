"""The yardstick's arithmetic against the bounds and FLOP counts recorded
for the port's kernels and models (PERF.md, section 6; the port's
``utils/flops.py``)."""

import json
import os

import pytest
import torch

from portbench import counts
from portbench.traffic import common

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ms(call):
    return counts.bound_s(*call) * 1e3


@pytest.mark.parametrize("got, want", [
    (lambda: ms(counts.k1_call(16384, 1)), 0.01204),                      # exponentials
    (lambda: ms(counts.k1_call(16384, 1, accum=True)), 0.01565),          # bytes
    (lambda: ms(counts.k1_call(16384, 4, chunk_states=True)), 0.04852),
    (lambda: ms(counts.k1_call(76800, 1)), 0.05642),
    (lambda: ms(counts.k1_call(256, 1)), 0.000190),
    (lambda: ms(counts.k2_call(16384, 4)), 0.08108),
    (lambda: ms(counts.k2_call(16384, 1)), 0.02028),
    (lambda: ms(counts.k2_call(256, 4)), 0.001275),
])
def test_kernel_bounds_are_the_recorded_ones(got, want):
    assert got() == pytest.approx(want, rel=2e-3)


def _cfg(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name, matmul_conv, scan", [("1mlp_g2", 1.97e9, 0.60e9),
                                                     ("1mlp", 2.43e9, 0.75e9)])
def test_model_flops_at_64(name, matmul_conv, scan):
    from focalnet_tpu_torch.models import build_net
    from focalnet_tpu_torch.utils.flops import mimounet_scan_flops, model_flops

    cfg = _cfg(name)
    shapes = common.shapes(cfg)
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    got = counts.counted_flops(meta, common.shape_cfg(cfg), (64, 64), 1)
    assert got == pytest.approx(matmul_conv, rel=5e-3)
    assert counts.scan_flops(common.shape_cfg(cfg), (64, 64), 1) == pytest.approx(scan, rel=5e-3)
    # the port's own count of the same forward
    model = build_net(cfg["preset"], device="meta")
    assert got == model_flops(model, torch.empty(1, 64, 64, 3, device="meta"))
    assert counts.scan_flops(common.shape_cfg(cfg), (64, 64), 1) == \
        mimounet_scan_flops(model.cfg, (64, 64))


def test_forward_flops_scale_with_pixels():
    cfg = common.shape_cfg(_cfg("1mlp_g2"))
    meta = {k: torch.empty(s, device="meta") for k, s in common.shapes(_cfg("1mlp_g2")).items()}
    fwd = counts.model_flops(meta, cfg, (64, 64), 1)
    assert counts.model_flops(meta, cfg, (128, 128), 1) == pytest.approx(4 * fwd, rel=1e-6)
    assert counts.model_flops(meta, cfg, (64, 64), 2) == pytest.approx(2 * fwd, rel=1e-6)


def test_scan_calls_of_a_forward():
    calls = counts.scan_calls(common.shape_cfg(_cfg("1mlp")), (480, 640), 1)
    assert len(calls) == 96 and {k for k, *_ in calls} == {"k1"}
    assert sorted({L for _, L, *_ in calls}) == [1200, 4800, 19200, 76800]
    g2 = counts.scan_calls(common.shape_cfg(_cfg("1mlp_g2")), (480, 640), 1)
    assert sorted({L for _, L, *_ in g2}) == [4800, 19200, 76800] and len(g2) == 48
