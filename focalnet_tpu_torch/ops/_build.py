"""Build the port's CUDA sources with nvcc into shared libraries with a plain C
interface, loaded with ctypes.

Each source under ``ops/csrc`` becomes ``_build/lib<stem>_<hash>.so``; the
hash covers the source, the headers of ``ops/csrc`` (every build may include
them) and the flags, so a changed source or header is rebuilt at its next
use and an unchanged one is loaded as it is.  Nothing is built when a
module is imported: the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# sm_90a (not sm_90): Hopper's wgmma/setmaxnreg exist only for that target;
# -Xptxas -v reports registers, shared memory and spills into the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, then ``/usr/local/cuda``, then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def library_path(source: str, csrc_dir: str = CSRC_DIR) -> str:
    """Where the library built from ``<csrc_dir>/<source>`` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [os.path.join(csrc_dir, source)] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def load_library(source: str, csrc_dir: str = CSRC_DIR) -> ctypes.CDLL:
    """Build ``<csrc_dir>/<source>`` (by default a source of ``ops/csrc``)
    unless its current build exists, then load it.

    Raises with nvcc's output when the build fails.  The compiler's report
    (``-Xptxas -v``) is kept beside the library as ``<lib>.log``."""
    out = library_path(source, csrc_dir)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(csrc_dir, source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return ctypes.CDLL(out)
