"""The plain reference: its blocked scan against the step-by-step
recurrence, and the port's forward against it at a small size, on the CPU."""

import json
import os

import pytest
import torch

from portbench.reference import model as ref_model
from portbench.reference import scan as ref_scan
from portbench.traffic import common
from portbench import weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan_inputs(b=2, d=6, n=4, L=37, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa: E731
    return (r(b, d, L), r(b, d, L) * 0.5, -torch.rand(d, n, generator=g, dtype=torch.float64) * 4,
            r(b, n, L), r(b, n, L), r(d), r(d) * 0.1)


@pytest.mark.parametrize("reverse", [False, True])
def test_blocked_scan_is_the_recurrence(monkeypatch, reverse):
    monkeypatch.setattr(ref_scan, "BLOCK_ELEMS", 2 * 6 * 4 * 8)  # blocks of 8 items
    ins = _scan_inputs()
    y = ref_scan.selective_scan(*ins, reverse=reverse)
    flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
    u, delta, A, B, C, D, bias = ins
    want = flip(ref_scan.selective_scan_steps(flip(u), flip(delta), A, flip(B), flip(C), D, bias))
    torch.testing.assert_close(y, want, rtol=1e-10, atol=1e-10)


def _tiny(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(overrides={"vssg_dim": 16, "ssm_d_state": 4}, vssg_dim=16, ssm_d_state=4)
    return cfg


@pytest.mark.parametrize("name", ["1mlp_g2", "1mlp"])
def test_port_forward_matches_reference(name):
    cfg = _tiny(name)
    model, state = common.build(cfg, 3, torch.device("cpu"))
    x = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x)
        want = ref_model.forward(state, x, common.shape_cfg(cfg))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_weights_follow_the_laws():
    cfg = _tiny("1mlp")
    shapes = common.shapes(cfg)
    w = weights.make(shapes, 5, "cpu")
    assert {k: tuple(v.shape) for k, v in w.items()} == shapes
    assert all(torch.equal(w[k], v) for k, v in weights.make(shapes, 5, "cpu").items())
    assert not torch.equal(w["SCM1.main.0.main.0.weight"],
                           weights.make(shapes, 6, "cpu")["SCM1.main.0.main.0.weight"])
    fc = w["Encoder.0.layers.0.layers.0.seq_global.blocks.0.mlp.fc1.weight"]
    assert fc.abs().max() <= 0.04 and 0.012 < fc.std() < 0.02
    conv = w["feat_extract.1.main.0.weight"]  # fan_in 32 * 9
    assert conv.abs().max() <= 288 ** -0.5
    a = w["Encoder.0.layers.0.layers.0.seq_local.blocks.1.op.A_logs"]
    torch.testing.assert_close(a[0], torch.log(torch.arange(1.0, 5.0)))
    dt = torch.nn.functional.softplus(w["Decoder.2.layers.0.layers.0.seq_global.blocks.0.op.dt_projs_bias"])
    assert dt.min() >= 1e-4 and dt.max() <= 0.1 + 1e-6
