"""Build the port's CUDA sources with nvcc, and its host C++ sources with
g++, into shared libraries with a plain C interface, loaded with ctypes.

Each source under ``ops/csrc`` becomes ``_build/lib<stem>_<hash>.so``; the
hash covers the source, the headers of ``ops/csrc`` (every build may include
them) and the flags, so a changed source or header is rebuilt at its next
use and an unchanged one is loaded as it is.  A host source
(:func:`load_host_library`, e.g. ``data/csrc/loader.cpp``) is hashed with
its flags and the CPU that ``-march=native`` targets.  Nothing is built when a module is imported: the first call
that needs a library builds it.
"""

from __future__ import annotations

import ctypes
import functools
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

# host C++: the JAX package's loader flags, plus what a shared library needs
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")


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
        _compile([find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", f"{out}.{os.getpid()}.tmp",
                  os.path.join(csrc_dir, source)], out)
    return ctypes.CDLL(out)


def find_cxx() -> str:
    """The host C++ compiler: ``CXX``, else ``g++``, on ``PATH`` or as a path."""
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: set CXX or put g++ on PATH")
    return path


def _compile(cmd, out: str) -> None:
    """Run a compiler command that writes ``<out>.<pid>.tmp`` (``cmd`` names
    it), then move it to ``out`` at once: a concurrent build of the same
    library sees all of it or nothing.  Raises with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(f"{out}.{os.getpid()}.tmp", out)


@functools.cache
def _host_target(cxx: str) -> str:
    """The target options ``-march=native`` turns on for ``cxx`` here: a
    library built on another CPU hashes to another name."""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    return proc.stdout


def host_library_path(source: str, flags=()) -> str:
    """Where the library built from the host C++ file ``source`` with the
    extra ``flags`` (defines, libraries to link) lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + tuple(flags)).encode())
    digest.update(_host_target(find_cxx()).encode())
    with open(source, "rb") as f:
        digest.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def load_host_library(source: str, flags=()) -> ctypes.CDLL:
    """Build the host C++ file ``source`` with ``g++ CXX_FLAGS ... flags``
    unless its current build exists, then load it.  Raises with the
    compiler's output when the build fails."""
    out = host_library_path(source, flags)
    if not os.path.exists(out):
        _compile([find_cxx(), *CXX_FLAGS, "-o", f"{out}.{os.getpid()}.tmp", source, *flags], out)
    return ctypes.CDLL(out)
