"""The MambaIR cell's yardstick and harness on the CPU: its FLOPs against
``FlopCounterMode``, its scans' least times, the cell resolved by name and
run at a toy size, correct, and incorrect under the planted fault; the
reference free of the program."""

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, counts_mambair, harness
from portbench import run as runner
from portbench.reference import mambair as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "mambair-dn-cbsd68"
TOY = dict(embed_dim=60, depths=[2, 2], d_inner=120, dt_rank=4)


def _config():
    return harness.resolve(CELL).config


def test_counted_flops_are_flop_counter_modes():
    """The closed form against ``FlopCounterMode`` over the reference and over
    the port at a small size: convolutions by their groups (the depthwise 3x3
    at D_i 9 a pixel, as ``counts.py`` corrects its backward), the channel
    attention once an image."""
    from focalnet_tpu_torch.models import build_net
    from focalnet_tpu_torch.utils.flops import model_flops

    cfg = dict(_config(), **TOY)
    model = build_net("mambair_dn", device="meta", embed_dim=60, depths=(2, 2))
    meta = {k: torch.empty(v.shape, device="meta") for k, v in model.state_dict().items()}
    for hw, batch in (((13, 19), 1), ((24, 16), 2)):
        x = torch.empty(batch, *hw, 3, device="meta")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            ref.forward(meta, x, cfg)
        want = counter.get_total_flops()
        assert counts_mambair.counted_flops(cfg, hw, batch) == want == model_flops(model, x)


def test_scans_of_a_published_forward():
    cfg = _config()
    assert len(counts_mambair.scan_calls(cfg, (321, 481), 1)) == 4 * 30  # the cell's 5 groups
    cfg = dict(cfg, depths=cfg["published"]["depths"])
    calls = counts_mambair.scan_calls(cfg, (321, 481), 1)
    assert len(calls) == 144 and {L for L, *_ in calls} == {154401}
    assert sum(kw.get("accum", False) for *_, kw in calls) == 72
    plain = counts.bound_s(*counts.k1_call(154401, dim=360, N=16)) * 1e3
    accum = counts.bound_s(*counts.k1_call(154401, dim=360, N=16, accum=True)) * 1e3
    assert plain == pytest.approx(0.2127, rel=1e-3) and accum == pytest.approx(0.2714, rel=1e-3)
    total = counts_mambair.scan_bound_s(cfg, (321, 481), 1)
    assert total == pytest.approx(72 * (plain + accum) / 1e3)
    assert counts_mambair.counted_flops(cfg, (321, 481), 1) == pytest.approx(5.888e12, rel=1e-3)
    assert counts_mambair.scan_flops(cfg, (321, 481), 1) == pytest.approx(1.1606e12, rel=1e-3)


def _toy(**mix):
    cell = harness.resolve(CELL)
    cell.config.update(**TOY)
    cell.mix.update(hw=[13, 19], pool=3, sample=2, traced=1, **mix)
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_at_a_toy_size(trace):
    cell = _toy()
    assert cell.config["preset"] == "mambair_dn" and cell.mix["kind"] == "denoise"
    args = types.SimpleNamespace(workload=CELL, seed=2**31 + 5, seconds=0.5, trace=trace,
                                 control=None, fault=None)
    run, result = runner.execute(args, cell=cell, device="cpu", t_start=time.perf_counter())
    assert result["correct"] is True, result["check"]
    assert result["check"]["out_gap"]["value"] < 1e-5 and run.iters >= 2
    names = set(result["metrics"])
    if trace:
        assert {"mfu.dehaze", "idle_share.dehaze"} <= names
    else:
        assert {"dehaze_images_per_s", "setup_s"} <= names


def test_an_altered_answer_reads_incorrect():
    args = types.SimpleNamespace(workload=CELL, seed=2**31 + 6, seconds=0.3, trace=0,
                                 control=None, fault="answer")
    result = runner.execute(args, cell=_toy(), device="cpu", t_start=time.perf_counter())[1]
    assert result["correct"] is False
    assert result["check"]["out_gap"]["value"] >= 1 / 255 - 1e-6


def test_the_noisy_pool_is_the_seeds():
    from portbench.traffic import denoise

    mix = dict(harness.resolve(CELL).mix, hw=[21, 33], pool=2)
    clean, noisy = denoise.noisy_pool(2**31 + 9, mix)
    again = denoise.noisy_pool(2**31 + 9, mix)[1]
    assert noisy.dtype == clean.dtype == "uint8" and noisy.shape == (2, 21, 33, 3)
    assert (noisy == again).all()
    sigma = (noisy.astype(float) - clean).std()
    assert 20 < sigma < 26  # 25 less what the clipping at 0 and 255 takes


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.mambair; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert not set(eval(out.stdout)) & {"focalnet_tpu_torch", "focalnet_tpu", "jax", "jaxlib",
                                         "flax"}


def test_the_configuration_is_the_published_one():
    with open(os.path.join(ROOT, "portbench", "configs", "mambair_colordn.json")) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == ["depths"] and cfg["depths"] == [6] * 5  # whole groups of 6 cut
    pub = cfg["published"]
    assert (cfg["embed_dim"], cfg["ssm_d_state"], cfg["ssm_ratio"]) == \
        (pub["embed_dim"], pub["d_state"], pub["mlp_ratio"]) == (180, 16, 2.0)
    assert pub["depths"] == [6] * 6
    assert (cfg["d_inner"], cfg["dt_rank"], cfg["compress_ratio"], cfg["squeeze_factor"],
            cfg["img_range"]) == (360, 12, 3, 30, 1.0)
