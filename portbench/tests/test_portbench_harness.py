"""The harness on the CPU: cells resolved by name from files alone, inputs
the same for the same seed, no run without a card, nothing of JAX loaded,
and the reference free of the program."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import data, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = harness.benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(name):
    cell = harness.resolve(name, BENCH)
    module = harness.kind(cell.mix)
    assert callable(module.run)
    assert cell.config["preset"] and cell.limits
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names


def test_contract_shapes_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(c["reduced"]) <= set(json.load(f))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "g2-dehaze-512", "config": "1mlp_g2",
                               "traffic": "dehaze-512", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "g2-dehaze-640" in m.get("workloads", []):
            m["workloads"].append("g2-dehaze-512")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = dict(harness.resolve("g2-dehaze-640", BENCH).mix, hw=[512, 512])
    (tmp_path / "portbench" / "traffic" / "dehaze-512.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "workloads" / "g2-dehaze-512.json").write_text(json.dumps(
        {"config": "1mlp_g2", "traffic": "dehaze-512", "chips": 1, "limits": {"out_gap": 1.0}}))
    code = ("from portbench import harness; c = harness.resolve('g2-dehaze-512'); "
            "print(c.mix['hw'], harness.kind(c.mix).__name__, len(c.per_layer))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:3] == ["[512,", "512]", "portbench.traffic.dehaze"]


def test_inputs_are_the_seeds():
    a = data.scenes(2**31 + 17, 3, 2, (46, 62))
    b = data.scenes(2**31 + 17, 3, 2, (46, 62))
    c = data.scenes(2**31 + 18, 3, 2, (46, 62))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    assert a[0].shape == c[0].shape == (3, 46, 62, 3) and a[1].shape == (3, 2, 46, 62, 3)


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "g2-dehaze-640",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "g2-dehaze-640",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


GUARD = """
import json, sys, time, types
sys.path.insert(0, {root!r})
import torch
from portbench import harness, run
bench = harness.benchmark()
for w in bench["workloads"]:
    cell = harness.resolve(w["name"], bench)
    cell.config.update(overrides={{"vssg_dim": 16, "ssm_d_state": 4}}, vssg_dim=16, ssm_d_state=4)
    cell.mix.update(hw=[46, 62], pool=2, sample=1, traced=1)
    args = types.SimpleNamespace(workload=w["name"], seed=3, seconds=0.2, trace=1, control=None, fault=None)
    run.execute(args, cell=cell, device="cpu", t_start=time.perf_counter())
import portbench.reference.model
print(json.dumps(sorted(sys.modules)))
"""


def test_a_rehearsed_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", GUARD.format(root=ROOT)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert not tops & {"jax", "jaxlib", "flax", "focalnet_tpu"}
    assert "focalnet_tpu_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.model, "
            "portbench.reference.scan; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout))
    assert not tops & {"focalnet_tpu_torch", "focalnet_tpu", "jax", "jaxlib", "flax"}


PLANTED = """
import sys
sys.path[:0] = [{stub!r}, {copy!r}, {root!r}]
from portbench import harness, run
cell = harness.resolve("g2-dehaze-640")
cell.config.update(overrides={{"vssg_dim": 16, "ssm_d_state": 4}}, vssg_dim=16, ssm_d_state=4)
cell.mix.update(hw=[46, 62], pool=2, sample=1, traced=1)
run.main(["--workload", "g2-dehaze-640", "--seed", "3", "--seconds", "0.2", "--trace", "0"],
         cell=cell, device="cpu")
"""


@pytest.mark.parametrize("planted", [False, True])
def test_a_metric_that_loads_jax_stops_the_result(tmp_path, planted):
    """A metric's reader loads after the window: a JAX it imports is found
    all the same, and no result is printed."""
    copy = tmp_path / "copy"
    shutil.copytree(os.path.join(ROOT, "portbench"), copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    if planted:
        reader = copy / "portbench" / "metrics" / "peak_mem_gib.py"
        reader.write_text("import jax  # noqa: F401\n" + reader.read_text())
    code = PLANTED.format(stub=str(tmp_path / "stub"), copy=str(copy), root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    if planted:
        assert out.returncode != 0 and out.stdout.strip() == "", out.stdout[-2000:]
        assert "jax" in out.stderr.splitlines()[-1]
    else:
        assert out.returncode == 0, out.stderr[-3000:]
        assert "correct" in json.loads(out.stdout.strip().splitlines()[-1])
