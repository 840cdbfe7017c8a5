"""The harness: a cell resolved by name from the benchmark's files, the
measured window, and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
sits in a file of its own, found by the name that ``BENCHMARK.json`` gives:

- ``workloads/<cell>.json``: the cell's configuration, traffic mix and
  chips, and the limits of the numbers its check compares;
- ``configs/<config>.json``: the preset and overrides of the program, and
  the sizes the yardstick counts with (checked against the model built);
- ``traffic/<mix>.json``: the mix's parameters, whose ``kind`` names the
  module ``traffic/<kind>.py`` that drives it;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of one
  metric from the run's record (None: nothing to read, and the metric is
  left out of the line).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "focalnet_tpu")


def _load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # configs/<config>.json
    mix: dict                    # traffic/<traffic>.json
    limits: Dict[str, float]     # the check's numbers and their limits
    end_to_end: List[dict]       # BENCHMARK.json's metrics of this cell
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench if bench is not None else benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    spec = _load_json("workloads", f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return Cell(name=name, chips=entry["chips"], config=_load_json("configs", f"{entry['config']}.json"),
                mix=_load_json("traffic", f"{entry['traffic']}.json"), limits=spec["limits"],
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def kind(mix: dict):
    """The module that drives a traffic mix: ``traffic/<kind>.py``."""
    return importlib.import_module(f"portbench.traffic.{mix['kind']}")


def reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: Cell
    seed: int
    trace_on: bool
    chips: int = 1
    setup_s: float = 0.0
    window_s: float = 0.0
    images: int = 0                      # images completed in the window
    iters: int = 0                       # requests or steps in the window
    attempted: int = 0
    failed: int = 0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    trace: Any = None                    # trace.Trace of the traced stretch
    labels: Any = None                   # trace.Trace with the host's activity
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)  # s, stderr only
    flops_per_image: float = 0.0
    bounds_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # per iteration
    window_peak_bytes: int = 0
    memory_peak_bytes: int = 0
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)
    readings: Dict[str, Any] = dataclasses.field(default_factory=dict)  # the check's details


def window(run: Run, step: Callable[[int], int], seconds: float, sync: Callable,
           start: int = 0) -> int:
    """Call ``step(i)`` (it returns the images it completed) from ``i =
    start`` until ``seconds`` have passed, then wait for the card: the
    window is all of that time and all of that work.  Returns the next i."""
    i, t0 = start, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        run.images += step(i)
        i += 1
    sync()
    run.window_s = time.perf_counter() - t0
    run.iters = i - start
    return i


def loaded_forbidden() -> List[str]:
    """Modules of the JAX package or of JAX that this process holds,
    compared by top-level name."""
    return sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)


def metric_values(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {m['name']} read {value}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(run: Run) -> Dict[str, dict]:
    """Each number the check compared beside its limit."""
    missing = sorted(set(run.cell.limits) - set(run.numbers))
    if missing:
        raise RuntimeError(f"the check gave no {missing}")
    return {k: {"value": run.numbers[k], "limit": run.cell.limits[k]} for k in run.cell.limits}


def is_correct(run: Run, checks: Dict[str, dict]) -> bool:
    return run.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
