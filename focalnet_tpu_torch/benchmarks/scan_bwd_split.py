"""Where the time of the selective-scan backward kernel (K2) goes: the
kernel built as it is and with parts of its work taken out, each timed by
its profiled device time on the same inputs.

The variants are text edits of a copy of a K2 source, built under
``focalnet_tpu_torch/_build/variants/``; the source itself is not changed.
They match the channel-per-block design (one block per (batch, channel),
stage A staging the group's B and C rows, stage E adding each block's dB and
dC rows with fp32 atomics), which :data:`BASELINE_COMMIT` holds:

- ``full``: as it is;
- ``no_atomics``: stage E adds nothing (its rows are still computed);
- ``no_bc``: stage A stages zeros for B and C instead of reading them;
- ``neither``: both taken out.

``full`` runs first and last, so that the spread of one variant is seen.
Each variant's result is wrong by design: only its time is read.

``--compare FILE ...`` instead times whole K2 sources of any design as they
are, in turns with the checkout's own K2 (``csrc/selective_scan_bwd.cu``
first and last), on the same inputs, and gives each one's largest
difference from the checkout's gradients relative to their scale.

Usage (on the card):
    python -m focalnet_tpu_torch.benchmarks.scan_bwd_split [--source FILE] \\
        [--B 4] [--D 192] [--N 16] [--L 16384,1024] [--reverse]
    python -m focalnet_tpu_torch.benchmarks.scan_bwd_split --compare FILE ... \\
        [--B 4] [--L 16384,4096]

Without ``--source`` it takes K2 as of :data:`BASELINE_COMMIT`
(:func:`baseline_source`).  Prints the card's ``nvidia-smi`` line, one JSON
line per (L, variant) and one summary line per L.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess

import torch

from focalnet_tpu_torch.ops._build import BUILD_DIR, load_library
from focalnet_tpu_torch.ops.selective_scan_cuda import (
    SOURCE_BWD,
    bind_bwd,
    build_bwd,
    launch_bwd,
    selective_scan_cuda,
)

# the last commit whose K2 is the channel-per-block design
BASELINE_COMMIT = "675b4f89fff365779119b07d5010f5f95f792f10"
BASELINE_DIR = os.path.join(BUILD_DIR, "baseline")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ATOMICS = ("        atomicAdd(dB + off, s_B[m][sidx(e)]);\n"
            "        atomicAdd(dC + off, s_C[m][sidx(e)]);\n")
_BC_LOADS = ("      s_B[m][sidx(e)] = p < L ? to_f(Bm[off]) : 0.f;\n"
             "      s_C[m][sidx(e)] = p < L ? to_f(Cm[off]) : 0.f;\n")
_BC_ZEROS = "      s_B[m][sidx(e)] = 0.f;\n      s_C[m][sidx(e)] = 0.f;\n"
VARIANTS = {
    "full": (),
    "no_atomics": ((_ATOMICS, ""),),
    "no_bc": ((_BC_LOADS, _BC_ZEROS),),
    "neither": ((_ATOMICS, ""), (_BC_LOADS, _BC_ZEROS)),
}


def baseline_source():
    """Path of K2's source as of :data:`BASELINE_COMMIT`: written under
    ``_build/baseline/`` by ``git show`` from the checkout's history, or a
    copy already there (a checkout without history gets one put there by
    whoever runs it).  None if neither exists."""
    path = os.path.join(BASELINE_DIR, SOURCE_BWD)
    try:
        src = subprocess.run(
            ["git", "-C", _REPO, "show",
             f"{BASELINE_COMMIT}:focalnet_tpu_torch/ops/csrc/{SOURCE_BWD}"],
            capture_output=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return path if os.path.exists(path) else None
    os.makedirs(BASELINE_DIR, exist_ok=True)
    with open(path, "wb") as f:
        f.write(src)
    return path


def build_variants(source: str):
    """{name: bound library} for :data:`VARIANTS` of ``source``."""
    with open(source) as f:
        text = f.read()
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, edits in VARIANTS.items():
        v = text
        for old, new in edits:
            if old not in v:
                raise ValueError(f"{source}: variant {name!r} does not apply "
                                 "(not the channel-per-block design)")
            v = v.replace(old, new)
        stem = f"selective_scan_bwd_{name}.cu"
        with open(os.path.join(out_dir, stem), "w") as f:
            f.write(v)
        libs[name] = bind_bwd(load_library(stem, out_dir))
    return libs


def split_inputs(B, D, N, L, seed=0):
    """Scan operands with the model's A and dt laws (softplus, D, bias), dy,
    and K1's chunk states for them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    dt = torch.exp(torch.rand(D, generator=g, device="cuda")
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    x = dict(u=r(B, D, L), delta=0.1 * r(B, D, L),
             A=-torch.arange(1.0, N + 1, device="cuda").expand(D, N).contiguous(),
             B=0.5 * r(B, 1, N, L), C=0.5 * r(B, 1, N, L),
             D=r(D), delta_bias=dt + torch.log(-torch.expm1(-dt)))
    return x, r(B, D, L)


def run(source, B=4, D=192, N=16, Ls=(16384, 1024), reverse=False):
    """Time every variant at each L; returns the summary rows."""
    from focalnet_tpu_torch.benchmarks.vpu_probe import device_ms
    from focalnet_tpu_torch.utils.device import nvidia_smi

    libs = build_variants(source)
    print(nvidia_smi("name,power.limit"), flush=True)
    rows = []
    order = list(VARIANTS) + ["full"]
    with torch.inference_mode():
        for L in Ls:
            x, dy = split_inputs(B, D, N, L)
            _, hchk = selective_scan_cuda(**x, delta_softplus=True, reverse=reverse,
                                          chunk_states=True)
            args = (*x.values(), dy, hchk, True, reverse)
            ms = {}
            for name in order:
                t = device_ms(lambda: launch_bwd(libs[name], *args), "selective_scan_bwd",
                              torch.device("cuda"))
                ms.setdefault(name, []).append(t)
                print(json.dumps(dict(L=L, variant=name, ms=t)), flush=True)
            full = min(ms["full"])
            row = dict(B=B, D=D, N=N, L=L, reverse=reverse, full_ms=ms["full"],
                       **{f"{k}_ms": ms[k][0] for k in VARIANTS if k != "full"},
                       **{f"{k}_share_of_full": ms[k][0] / full
                          for k in VARIANTS if k != "full"})
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def compare(sources, B=4, D=192, N=16, Ls=(16384, 4096), reverse=False):
    """Time each K2 source of ``sources`` (built as it is) in turns with the
    checkout's K2; returns one row per (L, source)."""
    from focalnet_tpu_torch.benchmarks.vpu_probe import device_ms
    from focalnet_tpu_torch.utils.device import nvidia_smi

    libs = {"checkout": build_bwd()}
    for path in sources:
        libs[path] = bind_bwd(load_library(os.path.basename(path), os.path.dirname(path)))
    print(nvidia_smi("name,power.limit"), flush=True)
    rows = []
    with torch.inference_mode():
        for L in Ls:
            x, dy = split_inputs(B, D, N, L)
            _, hchk = selective_scan_cuda(**x, delta_softplus=True, reverse=reverse,
                                          chunk_states=True)
            args = (*x.values(), dy, hchk, True, reverse)
            want = launch_bwd(libs["checkout"], *args)
            for name in list(libs) + ["checkout"]:
                got = launch_bwd(libs[name], *args)
                err = max(float((a - w).abs().max() / w.abs().max().clamp_min(1.0))
                          for a, w in zip(got, want))
                t = device_ms(lambda: launch_bwd(libs[name], *args), "selective_scan_bwd",
                              torch.device("cuda"))
                row = dict(B=B, D=D, N=N, L=L, reverse=reverse, source=name, ms=t,
                           max_rel_diff=err)
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source", default="", help="a K2 source of the channel-per-block "
                   "design; default: K2 as of BASELINE_COMMIT")
    p.add_argument("--B", type=int, default=4)
    p.add_argument("--D", type=int, default=192)
    p.add_argument("--N", type=int, default=16)
    p.add_argument("--L", type=str, default="16384,1024")
    p.add_argument("--reverse", action="store_true")
    p.add_argument("--compare", nargs="+", default=[], metavar="FILE",
                   help="K2 sources to time as they are beside the checkout's K2")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_bwd_split: needs a CUDA card")
    Ls = tuple(int(v) for v in a.L.split(","))
    if a.compare:
        return compare([os.path.abspath(f) for f in a.compare], a.B, a.D, a.N, Ls, a.reverse)
    source = a.source or baseline_source()
    if source is None:
        raise SystemExit(f"scan_bwd_split: no --source, and K2 of {BASELINE_COMMIT} is "
                         f"neither in the checkout's history nor in {BASELINE_DIR}")
    return run(source, a.B, a.D, a.N, Ls, a.reverse)


if __name__ == "__main__":
    main()
