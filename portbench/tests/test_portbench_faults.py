"""The check fails what it must.  On the CPU, at a small size, the rest of a
run (no look for a card) with the timed path broken underneath reads
``correct`` false: an answer altered where it is produced.  On the card, at each cell's own size, the
control (the program with TF32 on) reads false and the program true."""

import json
import os
import subprocess
import sys
import time
import types

import pytest

from portbench import harness
from portbench import run as runner

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = harness.benchmark()


def _tiny(name):
    cell = harness.resolve(name, BENCH)
    cell.config.update(overrides={"vssg_dim": 16, "ssm_d_state": 4}, vssg_dim=16, ssm_d_state=4)
    cell.mix.update(hw=[46, 62], pool=3, sample=2, traced=1)
    return cell


def _run(cell, fault=None, seed=2**31 + 11):
    args = types.SimpleNamespace(workload=cell.name, seed=seed, seconds=0.5, trace=0,
                                 control=None, fault=fault)
    return runner.execute(args, cell=cell, device="cpu", t_start=time.perf_counter())[1]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_an_altered_answer_reads_incorrect(name):
    assert _run(_tiny(name))["correct"] is True
    result = _run(_tiny(name), "answer")
    assert result["correct"] is False, result["check"]


def _card(n):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_control_reads_incorrect_on_the_card(name):
    cell = harness.resolve(name, BENCH)
    _card(cell.chips)
    for seed, control in ((2**31 + 101, None), (2**31 + 102, "tf32"), (2**31 + 103, "tf32"),
                          (2**31 + 104, "tf32")):
        cmd = [sys.executable, "portbench/run.py", "--workload", name, "--seed", str(seed),
               "--seconds", "3", "--trace", "0"] + (["--control", control] if control else [])
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is (control is None), result["check"]
