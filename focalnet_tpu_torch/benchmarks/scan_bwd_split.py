"""Where the time of a selective-scan kernel goes: the forward kernel (K1,
``--kernel fwd``) or the backward kernel (K2, ``--kernel bwd``, the
default) as of its baseline commit, built as it is and with parts of its
work taken out, each timed by its profiled device time on the same inputs.

The variants are text edits of a copy of a kernel source, built under
``focalnet_tpu_torch/_build/variants/``; the source itself is not changed.
They match the channel-per-block designs (one block per (batch, channel),
stage A staging the group's B and C rows) that :data:`BASELINE_COMMITS`
holds.  K1's:

- ``full``: as it is;
- ``no_bc``: stage A stages zeros for B and C instead of loading them;
- ``no_ud``: stage A takes constants for u and delta instead of loading them;
- ``neither``: both taken out.

K2's (stage E adding each block's dB and dC rows with fp32 atomics):

- ``full``, ``no_atomics`` (stage E adds nothing; its rows are still
  computed), ``no_bc`` (as K1's), ``neither`` (both).

``full`` runs first and last, so that the spread of one variant is seen.
Each variant's result is wrong by design: only its time is read.

``--compare FILE ...`` instead times whole sources of the kernel, of any
design, as they are, and ``--derive EDIT ...`` builds of the checkout's own
source with the edits of :data:`DERIVED`: design alternatives (``tile=T``:
the launch takes a tile of T channels only; ``sync``: plain loads where the
kernel stages the next chunk with ``cp.async``) and, for K1, parts taken out
(``no_softplus``, ``no_sum``: step A without softplus, step C without the
sum over the N rows) or ``fast_exp`` (``__expf`` in step B); several edits
joined by ``+``.  Each is timed in turns with the checkout's kernel (first
and last), on the same inputs, with its largest difference from the
checkout's outputs relative to their scale.

Usage (on the card):
    python -m focalnet_tpu_torch.benchmarks.scan_bwd_split [--kernel fwd] \\
        [--source FILE] [--B 4] [--D 192] [--N 16] [--L 16384,1024] [--reverse] \\
        [--chunk_states]
    python -m focalnet_tpu_torch.benchmarks.scan_bwd_split [--kernel fwd] \\
        [--compare FILE ...] [--derive tile=2 tile=6+sync no_sum ...] \\
        [--B 4] [--L 16384,4096]

Without ``--source`` it takes the kernel as of its baseline commit
(:func:`baseline_source`).  ``--chunk_states`` has K1 write the chunk
states, as the train step's forward does (K2 always reads them).  Prints
the card's ``nvidia-smi`` line, one JSON line per (L, variant) and one
summary line per L.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from focalnet_tpu_torch.ops._build import BUILD_DIR, CSRC_DIR, load_library
from focalnet_tpu_torch.ops.selective_scan_cuda import (
    SOURCE,
    SOURCE_BWD,
    bind_bwd,
    bind_fwd,
    build,
    build_bwd,
    launch_bwd,
    launch_fwd,
    selective_scan_cuda,
)

# the last commits whose K1 and K2 are the channel-per-block designs
BASELINE_COMMITS = {"fwd": "4c16ed07fa9879fbcf273b5ddbf060a221ca7002",
                    "bwd": "675b4f89fff365779119b07d5010f5f95f792f10"}
BASELINE_DIR = os.path.join(BUILD_DIR, "baseline")
SOURCES = {"fwd": SOURCE, "bwd": SOURCE_BWD}
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ATOMICS = ("        atomicAdd(dB + off, s_B[m][sidx(e)]);\n"
            "        atomicAdd(dC + off, s_C[m][sidx(e)]);\n")
_BC_LOADS = {
    "bwd": ("      s_B[m][sidx(e)] = p < L ? to_f(Bm[off]) : 0.f;\n"
            "      s_C[m][sidx(e)] = p < L ? to_f(Cm[off]) : 0.f;\n"),
    "fwd": ("      s_B[m][sidx(e)] = p < L ? to_f(B_rows[off]) : 0.f;\n"
            "      s_C[m][sidx(e)] = p < L ? to_f(C_rows[off]) : 0.f;\n"),
}
_BC_ZEROS = "      s_B[m][sidx(e)] = 0.f;\n      s_C[m][sidx(e)] = 0.f;\n"
_UD_LOADS = ("        uv = to_f(u_row[p]);\n"
             "        dt = to_f(dl_row[p]) + bias_d;\n")
_UD_CONSTANTS = "        uv = 1.f;\n        dt = bias_d;\n"
VARIANTS = {
    "fwd": {
        "full": (),
        "no_bc": ((_BC_LOADS["fwd"], _BC_ZEROS),),
        "no_ud": ((_UD_LOADS, _UD_CONSTANTS),),
        "neither": ((_BC_LOADS["fwd"], _BC_ZEROS), (_UD_LOADS, _UD_CONSTANTS)),
    },
    "bwd": {
        "full": (),
        "no_atomics": ((_ATOMICS, ""),),
        "no_bc": ((_BC_LOADS["bwd"], _BC_ZEROS),),
        "neither": ((_ATOMICS, ""), (_BC_LOADS["bwd"], _BC_ZEROS)),
    },
}
# edits of the checkout's own sources: name -> (text, replacement with {} for
# the edit's value)
DERIVED = {
    "fwd": {
        "tile": ("constexpr int kFwdTiles[] = {1, 2, 3, 4, 6};",
                 "constexpr int kFwdTiles[] = {{{}}};"),
        "sync": ("const int vec = L % 8 == 0 &&", "const int vec = 0 && L % 8 == 0 &&"),
        # parts taken out (wrong results, times only): softplus in step A,
        # the N-row sum in step C; and fast-math exponentials in step B
        "no_softplus": ("        if (softplus) dt = dt <= 20.f ? log1pf(expf(dt)) : dt;\n", ""),
        "no_sum": ("if (m < N) acc[m & 1] += rows", "if (m < 0) acc[m & 1] += rows"),
        "fast_exp": ("a[t][i] = expf(", "a[t][i] = __expf("),
    },
    "bwd": {
        "tile": ("constexpr int kTiles[] = {1, 2, 3, 4, 6};", "constexpr int kTiles[] = {{{}}};"),
        "sync": ("const int vec_in = L % 8 == 0 &&", "const int vec_in = 0 && L % 8 == 0 &&"),
    },
}


def baseline_source(kernel: str = "bwd"):
    """Path of the kernel's source (``kernel`` "fwd" or "bwd") as of its
    :data:`BASELINE_COMMITS` entry: written under ``_build/baseline/`` by
    ``git show`` from the checkout's history, or a copy already there (a
    checkout without history gets one put there by whoever runs it).  None
    if neither exists."""
    path = os.path.join(BASELINE_DIR, SOURCES[kernel])
    try:
        src = subprocess.run(
            ["git", "-C", _REPO, "show",
             f"{BASELINE_COMMITS[kernel]}:focalnet_tpu_torch/ops/csrc/{SOURCES[kernel]}"],
            capture_output=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return path if os.path.exists(path) else None
    os.makedirs(BASELINE_DIR, exist_ok=True)
    with open(path, "wb") as f:
        f.write(src)
    return path


def _bind(kernel):
    return bind_fwd if kernel == "fwd" else bind_bwd


def build_edited(kernel: str, source: str, edits: dict):
    """{name: bound library} for each name's list of (text, replacement)
    edits of ``source``, built in parallel; raises if an edit does not
    apply."""
    with open(source) as f:
        text = f.read()
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    stems = {}
    for name, changes in edits.items():
        v = text
        for old, new in changes:
            if old not in v:
                raise ValueError(f"{source}: edit {name!r} does not apply ({old.strip()!r} "
                                 "is not in it)")
            v = v.replace(old, new)
        stem = f"{os.path.splitext(SOURCES[kernel])[0]}_{name.replace('=', '').replace('+', '_')}.cu"
        with open(os.path.join(out_dir, stem), "w") as f:
            f.write(v)
        stems[name] = stem
    with ThreadPoolExecutor(max(1, len(stems))) as ex:
        libs = dict(zip(stems, ex.map(lambda s: load_library(s, out_dir), stems.values())))
    return {name: _bind(kernel)(lib) for name, lib in libs.items()}


def derived_edits(kernel: str, spec: str):
    """The (text, replacement) list of a ``--derive`` spec such as
    ``tile=6+sync`` or ``no_sum``."""
    changes = []
    for part in spec.split("+"):
        key, _, value = part.partition("=")
        if key not in DERIVED[kernel]:
            raise ValueError(f"--derive {spec}: {key!r} is not one of {sorted(DERIVED[kernel])}")
        old, new = DERIVED[kernel][key]
        changes.append((old, new.format(value)))
    return changes


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


def _caller(kernel, B, D, N, L, reverse, chunk_states):
    """(a function of a bound library that launches it once on this call's
    inputs and returns its outputs as a tuple, the profiler's name pattern)"""
    x, dy = split_inputs(B, D, N, L)
    if kernel == "fwd":
        def call(lib):
            out = launch_fwd(lib, **x, delta_softplus=True, reverse=reverse,
                             chunk_states=chunk_states)
            return out if chunk_states else (out,)
        return call, "selective_scan_fwd"
    _, hchk = selective_scan_cuda(**x, delta_softplus=True, reverse=reverse, chunk_states=True)
    args = (*x.values(), dy, hchk, True, reverse)
    return (lambda lib: launch_bwd(lib, *args)), "selective_scan_bwd"


def run(source, kernel="bwd", B=4, D=192, N=16, Ls=(16384, 1024), reverse=False,
        chunk_states=False):
    """Time every variant of ``source`` at each L; returns the summary rows."""
    from focalnet_tpu_torch.benchmarks.vpu_probe import device_ms
    from focalnet_tpu_torch.utils.device import nvidia_smi

    variants = VARIANTS[kernel]
    libs = build_edited(kernel, source, variants)
    print(nvidia_smi("name,power.limit"), flush=True)
    rows = []
    order = list(variants) + ["full"]
    with torch.inference_mode():
        for L in Ls:
            call, pattern = _caller(kernel, B, D, N, L, reverse, chunk_states)
            ms = {}
            for name in order:
                t = device_ms(lambda: call(libs[name]), pattern, torch.device("cuda"), per_call=1)
                ms.setdefault(name, []).append(t)
                print(json.dumps(dict(kernel=kernel, B=B, L=L, variant=name, ms=t)), flush=True)
            full = min(ms["full"])
            row = dict(kernel=kernel, B=B, D=D, N=N, L=L, reverse=reverse,
                       chunk_states=chunk_states or kernel == "bwd", full_ms=ms["full"],
                       **{f"{k}_ms": ms[k][0] for k in variants if k != "full"},
                       **{f"{k}_share_of_full": ms[k][0] / full
                          for k in variants if k != "full"})
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def compare(sources, kernel="bwd", derive=(), B=4, D=192, N=16, Ls=(16384, 4096),
            reverse=False, chunk_states=False):
    """Time each source of ``sources`` (built as it is) and each ``derive``
    spec (a build of the checkout's source with those edits) in turns with
    the checkout's kernel; returns one row per (L, build)."""
    from focalnet_tpu_torch.benchmarks.vpu_probe import device_ms
    from focalnet_tpu_torch.utils.device import nvidia_smi

    libs = {"checkout": build() if kernel == "fwd" else build_bwd()}
    for path in sources:
        libs[path] = _bind(kernel)(load_library(os.path.basename(path), os.path.dirname(path)))
    checkout_src = os.path.join(CSRC_DIR, SOURCES[kernel])
    libs.update(build_edited(kernel, checkout_src,
                             {spec: derived_edits(kernel, spec) for spec in derive}))
    print(nvidia_smi("name,power.limit"), flush=True)
    rows = []
    with torch.inference_mode():
        for L in Ls:
            call, pattern = _caller(kernel, B, D, N, L, reverse, chunk_states)
            want = call(libs["checkout"])
            for name in list(libs) + ["checkout"]:
                got = call(libs[name])
                err = max(float((a.float() - w.float()).abs().max()
                                / w.float().abs().max().clamp_min(1.0))
                          for a, w in zip(got, want) if w is not None)
                t = device_ms(lambda: call(libs[name]), pattern, torch.device("cuda"), per_call=1)
                row = dict(kernel=kernel, B=B, D=D, N=N, L=L, reverse=reverse, source=name,
                           ms=t, max_rel_diff=err)
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=("fwd", "bwd"), default="bwd")
    p.add_argument("--source", default="", help="a source of the channel-per-block "
                   "design; default: the kernel as of its baseline commit")
    p.add_argument("--B", type=int, default=4)
    p.add_argument("--D", type=int, default=192)
    p.add_argument("--N", type=int, default=16)
    p.add_argument("--L", type=str, default="16384,1024")
    p.add_argument("--reverse", action="store_true")
    p.add_argument("--chunk_states", action="store_true",
                   help="K1 also writes the chunk states (the train step's call)")
    p.add_argument("--compare", nargs="+", default=[], metavar="FILE",
                   help="sources of the kernel to time as they are beside the checkout's")
    p.add_argument("--derive", nargs="+", default=[], metavar="EDIT",
                   help="builds of the checkout's source with these edits, timed beside it")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_bwd_split: needs a CUDA card")
    Ls = tuple(int(v) for v in a.L.split(","))
    if a.compare or a.derive:
        return compare([os.path.abspath(f) for f in a.compare], a.kernel, a.derive, a.B, a.D,
                       a.N, Ls, a.reverse, a.chunk_states)
    source = a.source or baseline_source(a.kernel)
    if source is None:
        raise SystemExit(f"scan_bwd_split: no --source, and the {a.kernel} kernel of "
                         f"{BASELINE_COMMITS[a.kernel]} is neither in the checkout's "
                         f"history nor in {BASELINE_DIR}")
    return run(source, a.kernel, a.B, a.D, a.N, Ls, a.reverse, a.chunk_states)


if __name__ == "__main__":
    main()
