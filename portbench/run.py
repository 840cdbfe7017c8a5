"""Run one cell of the benchmark of ``focalnet_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program.  It builds the cell's
model from the seed, loads the kernels (built into the program's
``_build`` directory at a checkout's first run), warms the cell's own
shapes, measures for ``--seconds``, checks what the window produced against
the plain fp32 reference in ``portbench/reference``, and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``, then ``check``: each compared number beside its
limit (also the last lines of standard error).

It exits with another code than 0, printing no result, where there is no
CUDA card or fewer than the cell asks for, where the program is missing,
and where the process holds JAX or the JAX package when the window has
closed.  ``--control tf32`` and ``--fault <name>`` (tests and the reading
of limits only) run the program with TF32 on, or with a fault planted
under the timed path.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--fault", default=None)
    return ap.parse_args(argv)


def card(chips: int):
    """The device record, or raises where the cards are missing."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this benchmark measures the card and does not fall "
                         "back to the CPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def execute(args, cell=None, device="cuda", t_start=None):
    """Run the cell; returns (Run, result dict).  ``device="cpu"`` (tests
    only) skips the look for a card."""
    cell = cell or harness.resolve(args.workload)
    dev = card(cell.chips) if device == "cuda" else {"platform": "cpu", "kind": "cpu",
                                                    "count": 1}
    run = harness.Run(cell=cell, seed=args.seed, trace_on=bool(args.trace), chips=cell.chips)
    harness.kind(cell.mix).run(run, args.seconds, device=device, control=args.control,
                              fault=args.fault, t_start=T_START if t_start is None else t_start)
    metrics = cell.per_layer if args.trace else cell.end_to_end
    checks = harness.verdict(run)
    dev["memory_peak_bytes"] = run.memory_peak_bytes
    result = {"correct": harness.is_correct(run, checks), "attempted": run.attempted,
              "failed": run.failed, "metrics": harness.metric_values(run, metrics),
              "device": dev}
    if args.trace:
        from portbench import trace

        dev["busy_s"] = trace.busy_s(run.trace)
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(run.trace),
                               "idle_gaps": trace.idle_gaps(run.labels or run.trace)}
    result["check"] = checks
    return run, result


def main(argv=None, cell=None, device="cuda"):
    """``cell`` and ``device="cpu"`` for tests only, as in :func:`execute`."""
    args = parse(argv)
    run, result = execute(args, cell=cell, device=device)
    # after every reader and the trace's have run: what they load counts too
    forbidden = harness.loaded_forbidden()
    if forbidden:
        raise SystemExit(f"the process holds {', '.join(forbidden[:10])}: the benchmark "
                         "measures the port alone")
    phases = " ".join(f"{k} {v:.2f}" for k, v in run.phases.items())
    print(f"seconds: setup {run.setup_s:.2f} window {run.window_s:.2f} {phases}; "
          f"correct {result['correct']} attempted {run.attempted} failed {run.failed}",
          file=sys.stderr)
    if run.readings:
        print(f"check details {json.dumps(run.readings)}", file=sys.stderr)
    for k, c in result["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
