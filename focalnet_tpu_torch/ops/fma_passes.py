"""The fp32 FMA-rate probe's kernel (``csrc/fma_passes.cu``) and its plain
version.

The kernel replaces ``benchmarks/vpu_probe.py::make_pass_kernel.<locals>.body``:
P = 8 * n_loop dependent passes ``acc = acc * c_i + x`` over every element,
starting from ``acc = x``, with c_i = fp32(1 + 1e-6 * (i + 1)).
``fma_passes_cuda.launches`` counts the kernels launched: one for a
contiguous aligned size that is a multiple of 4, two with a ragged tail,
none for an empty tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from focalnet_tpu_torch.ops._build import load_library

SOURCE = "fma_passes.cu"
UNROLL = 8  # passes per loop iteration, one multiplier each
# Python floats, rounded to fp32 where they meet an fp32 tensor
MULTIPLIERS = tuple(1.0 + 1e-6 * (i + 1) for i in range(UNROLL))


@functools.cache
def build() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel's library."""
    lib = load_library(SOURCE)
    fn = lib.focalnet_fma_passes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    lib.focalnet_fma_passes_error_string.argtypes = [ctypes.c_int]
    lib.focalnet_fma_passes_error_string.restype = ctypes.c_char_p
    return lib


def fma_passes_ref(x: torch.Tensor, n_loop: int) -> torch.Tensor:
    """The plain version, in x's dtype: the product and the sum of each pass
    are rounded apart (the kernel fuses them into one FMA).  The multipliers
    are the fp32 ones in every dtype, so a float64 ``x`` gives the kernel's
    function with (nearly) no rounding."""
    cs = [torch.tensor(c, dtype=torch.float32).to(x.dtype) for c in MULTIPLIERS]
    acc = x
    for _ in range(n_loop):
        for c in cs:
            acc = acc * c + x
    return acc


def fma_passes_cuda(x: torch.Tensor, n_loop: int) -> torch.Tensor:
    """The kernel on a contiguous fp32 CUDA tensor of any shape; a new
    tensor of x's shape.  Launches on the current stream (no
    synchronisation); raises on any other tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"fma_passes_cuda: x must be on a CUDA device, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"fma_passes_cuda: x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fma_passes_cuda: x must be contiguous")
    if n_loop < 0:
        raise ValueError(f"fma_passes_cuda: n_loop must be >= 0, got {n_loop}")
    y = torch.empty_like(x)
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        rc = build().focalnet_fma_passes(
            x.data_ptr(), y.data_ptr(), x.numel(), n_loop,
            torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(launched))
    if rc != 0:
        msg = build().focalnet_fma_passes_error_string(rc).decode()
        raise RuntimeError(f"fma_passes launch failed: {msg} ({rc})")
    fma_passes_cuda.launches += launched.value
    return y


fma_passes_cuda.launches = 0


def fma_passes(x: torch.Tensor, n_loop: int) -> torch.Tensor:
    """P = 8 * n_loop passes over ``x``: the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fma_passes_ref(x, n_loop)
    return fma_passes_cuda(x, n_loop)
