"""Read the numbers that a cell's check compares, over many seeds, in one
process: the program as it runs, the control (the program with TF32 on)
and the planted faults, each on a short window.  The limits in
``workloads/<cell>.json`` were set from these readings (``PERF.md``).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --modes sound,tf32,answer [--seconds 1]

Prints one JSON line a reading: cell, seed, mode, the numbers, seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="sound,tf32")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            run = harness.Run(cell=cell, seed=seed, trace_on=False, chips=cell.chips)
            t0 = time.perf_counter()
            harness.kind(cell.mix).run(run, args.seconds, control="tf32" if mode == "tf32" else None,
                                      fault=None if mode in ("sound", "tf32") else mode,
                                      t_start=t0)
            print(json.dumps({"cell": cell.name, "seed": seed, "mode": mode, "numbers": run.numbers,
                              "readings": run.readings,
                              "iters": run.iters, "seconds": time.perf_counter() - t0,
                              "phases": run.phases}), flush=True)


if __name__ == "__main__":
    main()
