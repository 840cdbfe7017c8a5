"""Wrappers of the Hopper selective-scan kernels (``csrc/selective_scan_fwd.cu``
and ``csrc/selective_scan_bwd.cu``).

The forward kernel replaces ``focalnet_tpu/ops/pallas_scan.py::_fwd_kernel``,
the backward kernel ``::_bwd_kernel``.  They take plain L-contiguous
operands; the TPU kernels' chunk interleave has no counterpart.
``selective_scan_cuda.launches`` and ``selective_scan_bwd_cuda.launches``
count the kernels' launches, and their ``segment_launches`` those that take
the segment API.  Both kernels take the segment API (the TPU
kernels' ``with_state`` branch): the forward seeds its state from ``h0`` and
writes the state that leaves the scan, ``h_last``; the backward seeds its
adjoint carry from ``dh_last`` and writes the carry it ends with, ``dh0``.
Without them the launch is the one it always was (the C entry points
without ``_state``).  Gradients go through
:func:`focalnet_tpu_torch.ops.selective_scan`, which pairs the two kernels in
an autograd Function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from focalnet_tpu_torch.ops._build import load_library
from focalnet_tpu_torch.ops.scan_bwd_ref import (
    KERNEL_CHUNK,
    chunk_states_ref,
    selective_scan_bwd_ref,
)

SOURCE = "selective_scan_fwd.cu"
SOURCE_BWD = "selective_scan_bwd.cu"
_DTYPES = (torch.float32, torch.bfloat16)


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from a forward-kernel
    source (this one, or another version of it for a comparison)."""
    fn = lib.focalnet_selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.focalnet_selective_scan_max_dstate.argtypes = []
    lib.focalnet_selective_scan_max_dstate.restype = ctypes.c_int
    lib.focalnet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.focalnet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def build() -> ctypes.CDLL:
    """Build (at first use) and bind the forward kernel's library."""
    lib = bind_fwd(load_library(SOURCE))
    lib.focalnet_selective_scan_fwd_tile.argtypes = [ctypes.c_int] * 6
    lib.focalnet_selective_scan_fwd_tile.restype = ctypes.c_int
    lib.focalnet_selective_scan_fwd_last_tile.argtypes = []
    lib.focalnet_selective_scan_fwd_last_tile.restype = ctypes.c_int
    fn = lib.focalnet_selective_scan_fwd_state
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from a backward-kernel
    source (this one, or another version of it for a comparison)."""
    fn = lib.focalnet_selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.focalnet_selective_scan_bwd_max_dstate.argtypes = []
    lib.focalnet_selective_scan_bwd_max_dstate.restype = ctypes.c_int
    lib.focalnet_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.focalnet_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def build_bwd() -> ctypes.CDLL:
    """Build (at first use) and bind the backward kernel's library."""
    lib = bind_bwd(load_library(SOURCE_BWD))
    lib.focalnet_selective_scan_bwd_tile.argtypes = [ctypes.c_int] * 5
    lib.focalnet_selective_scan_bwd_tile.restype = ctypes.c_int
    fn = lib.focalnet_selective_scan_bwd_state
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fwd_tile_channels(batch: int, dim: int, groups: int = 1, dstate: int = 16,
                      dtype=torch.float32, out_dtype=torch.float32) -> int:
    """The channels one block of the forward kernel takes for operands of
    these widths on the current CUDA device, as its launch chooses them
    (``csrc/scan_common.cuh``, ``tile_channels``)."""
    t = build().focalnet_selective_scan_fwd_tile(
        batch, dim, groups, dstate, int(dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16))
    if t <= 0:
        msg = build().focalnet_cuda_error_string(-t).decode()
        raise RuntimeError(f"selective_scan_fwd: no tile for these widths: {msg} ({-t})")
    return t


def fwd_launched_tile() -> int:
    """The tile of channels that the forward kernel's last launch took."""
    return build().focalnet_selective_scan_fwd_last_tile()


def bwd_tile_channels(batch: int, dim: int, groups: int = 1, dstate: int = 16,
                      dtype=torch.float32) -> int:
    """The channels one block of the backward kernel takes for operands of
    these widths on the current CUDA device, as its launch chooses them
    (``csrc/scan_common.cuh``, ``tile_channels``)."""
    t = build_bwd().focalnet_selective_scan_bwd_tile(
        batch, dim, groups, dstate, int(dtype == torch.bfloat16))
    if t <= 0:
        msg = build_bwd().focalnet_scan_bwd_error_string(-t).decode()
        raise RuntimeError(f"selective_scan_bwd: no tile for these widths: {msg} ({-t})")
    return t


def _check(cond, msg):
    if not cond:
        raise ValueError(f"selective_scan_cuda: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_operands(u, delta, A, B, C, D, delta_bias, max_dstate):
    """Shape, dtype, device and layout checks shared by both kernels;
    returns (batch, dim, G, N, L)."""
    _check(u.device.type == "cuda", f"tensors must be on a CUDA device, got {u.device}")
    _check(u.dim() == 3 and delta.shape == u.shape, "u and delta must both be (batch, dim, L)")
    batch, dim, L = u.shape
    _check(B.dim() == 4 and C.shape == B.shape, "B and C must both be (batch, G, N, L)")
    _, G, N, _ = B.shape
    _check(B.shape[0] == batch and B.shape[3] == L and dim % G == 0,
           f"B/C {tuple(B.shape)} do not match u {tuple(u.shape)}")
    _check(A.shape == (dim, N), f"A must be (dim, N) = {(dim, N)}, got {tuple(A.shape)}")
    _check(N <= max_dstate, f"N = {N} states exceed the kernel's limit")
    _check(u.dtype in _DTYPES and delta.dtype == B.dtype == C.dtype == u.dtype,
           "u, delta, B, C must share one dtype, float32 or bfloat16")
    _check(A.dtype == torch.float32, "A must be float32")
    for name, t in (("D", D), ("delta_bias", delta_bias)):
        _check(t is None or (t.shape == (dim,) and t.dtype == torch.float32),
               f"{name} must be a float32 (dim,) vector or None")
    for t in (u, delta, A, B, C, D, delta_bias):
        _check(t is None or (t.device == u.device and t.is_contiguous()),
               "every tensor must be contiguous and on u's device")
    return batch, dim, G, N, L


def _check_state(name, t, u, batch, dim, N):
    _check(t is None or (t.shape == (batch, dim, N) and t.dtype == torch.float32
                         and t.device == u.device and t.is_contiguous()),
           f"{name} must be a contiguous float32 {(batch, dim, N)} tensor on u's device")


def selective_scan_cuda(u, delta, A, B, C, D=None, delta_bias=None,
                        delta_softplus=False, reverse=False, y_accum=None,
                        out_dtype=torch.float32, chunk_states=False, h0=None,
                        return_state=False):
    """Selective scan forward: u, delta (batch, dim, L); A (dim, N) fp32;
    B, C (batch, G, N, L) with dim % G == 0; D, delta_bias (dim,) fp32 or
    None; ``y_accum`` (y's shape and ``out_dtype``) is added in fp32 before
    the cast.  ``reverse`` scans right to left.  Inputs fp32 or bf16, output
    fp32 or bf16; any L.  ``chunk_states=True`` also returns the fp32 state
    entering each 256-item chunk, (batch, dim, n_chunks, N), which the
    backward kernel takes.  ``h0`` (batch, dim, N) fp32 seeds the state;
    ``return_state=True`` also returns the state after the last item scanned,
    h_last (batch, dim, N) fp32.  Returns y, then h_last (``return_state``),
    then the chunk states (``chunk_states``).

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation); where an input needs a gradient, the call goes through
    the autograd Function of :func:`..selective_scan.selective_scan`.  A CPU
    tensor takes the plain chunked scan."""
    from focalnet_tpu_torch.ops.selective_scan import selective_scan

    kw = dict(D=D, delta_bias=delta_bias, delta_softplus=delta_softplus,
              out_dtype=out_dtype, reverse=reverse, y_accum=y_accum, h0=h0,
              return_state=return_state)
    if u.device.type == "cpu":
        out = selective_scan(u, delta, A, B, C, backend="chunked", **kw)
        if not chunk_states:
            return out
        hchk = chunk_states_ref(u, delta, A, B, delta_bias, delta_softplus, reverse, h0=h0)
        return (*out, hchk) if return_state else (out, hchk)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, delta, A, B, C, D, delta_bias, y_accum, h0)
    ):
        _check(not chunk_states, "chunk_states is for the backward kernel's "
               "caller, which runs without autograd")
        return selective_scan(u, delta, A, B, C, backend="cuda", **kw)
    out = launch_fwd(build(), u, delta, A, B, C, D, delta_bias, delta_softplus, reverse,
                     y_accum, out_dtype, chunk_states, h0, return_state)
    selective_scan_cuda.launches += 1
    if h0 is not None or return_state:
        selective_scan_cuda.segment_launches += 1
    return out


selective_scan_cuda.launches = 0
selective_scan_cuda.segment_launches = 0


def launch_fwd(lib, u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=False,
               reverse=False, y_accum=None, out_dtype=torch.float32, chunk_states=False,
               h0=None, return_state=False):
    """Check the operands of :func:`selective_scan_cuda` on the card,
    allocate y (and h_last, and the chunk states) and launch the kernel of
    ``lib`` (a library bound by :func:`bind_fwd`; with ``h0`` or
    ``return_state``, by :func:`build`) once on the current stream; raises
    if the launch fails.  Counts nothing: the wrapper does."""
    batch, dim, G, N, L = _check_operands(
        u, delta, A, B, C, D, delta_bias, lib.focalnet_selective_scan_max_dstate())
    _check(out_dtype in _DTYPES, f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    _check(y_accum is None or (y_accum.shape == u.shape and y_accum.dtype == out_dtype
                               and y_accum.device == u.device and y_accum.is_contiguous()),
           "y_accum must be contiguous, on u's device, with y's shape and out_dtype")

    _check_state("h0", h0, u, batch, dim, N)

    y = torch.empty(u.shape, dtype=out_dtype, device=u.device)
    hchk = h_last = None
    if chunk_states:
        n_chunks = -(-L // KERNEL_CHUNK)
        hchk = torch.empty(batch, dim, n_chunks, N, dtype=torch.float32, device=u.device)
    if return_state:
        h_last = torch.empty(batch, dim, N, dtype=torch.float32, device=u.device)
    ptrs = [_ptr(u), _ptr(delta), _ptr(A), _ptr(B), _ptr(C), _ptr(D), _ptr(delta_bias),
            _ptr(y_accum), _ptr(y), _ptr(hchk)]
    launch = lib.focalnet_selective_scan_fwd
    if h0 is not None or return_state:
        launch = lib.focalnet_selective_scan_fwd_state
        ptrs += [_ptr(h0), _ptr(h_last)]
    with torch.cuda.device(u.device):
        rc = launch(
            *ptrs, batch, dim, G, N, L, int(delta_softplus), int(reverse),
            int(u.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.focalnet_cuda_error_string(rc).decode()
        raise RuntimeError(f"selective_scan_fwd launch failed: {msg} ({rc})")
    out = (y,) + ((h_last,) if return_state else ()) + ((hchk,) if chunk_states else ())
    return out if len(out) > 1 else y


def selective_scan_bwd_cuda(u, delta, A, B, C, D, delta_bias, dy, hchk,
                            delta_softplus=False, reverse=False, dh_last=None,
                            with_state=False):
    """Selective scan backward: the gradients of ``sum(y * dy)`` with respect
    to (u, delta, A, B, C, D, delta_bias), for the operands of
    :func:`selective_scan_cuda` and the chunk states it returned with
    ``chunk_states=True``.  du and ddelta come back in the input dtype, dA,
    dB, dC, dD and dbias in fp32 (dD / dbias None when D / delta_bias are).
    dy (batch, dim, L) may be fp32 or bf16; the kernel reads it in fp32.
    ``with_state=True`` is the segment API's backward: ``dh_last`` (batch,
    dim, N; None: zeros), the cotangent of the forward's h_last, seeds the
    adjoint, and ``dh0``, the cotangent of its h0 (batch, dim, N) fp32, comes
    back as an eighth value.  The forward's h0 needs no passing: it is the
    first chunk state.

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation); a CPU tensor takes the plain adjoint
    (:func:`.scan_bwd_ref.selective_scan_bwd_ref`), which needs no chunk
    states (the first of them is its h0)."""
    if u.device.type == "cpu":
        h0 = None
        if with_state and hchk is not None:
            h0 = hchk[:, :, -1 if reverse else 0]
        return selective_scan_bwd_ref(u, delta, A, B, C, D, delta_bias, dy,
                                      delta_softplus, reverse, h0=h0, dh_last=dh_last,
                                      with_state=with_state)
    grads = launch_bwd(build_bwd(), u, delta, A, B, C, D, delta_bias, dy, hchk,
                       delta_softplus, reverse, dh_last, with_state)
    selective_scan_bwd_cuda.launches += 1
    if with_state:
        selective_scan_bwd_cuda.segment_launches += 1
    return grads


selective_scan_bwd_cuda.launches = 0
selective_scan_bwd_cuda.segment_launches = 0


def launch_bwd(lib, u, delta, A, B, C, D, delta_bias, dy, hchk,
               delta_softplus=False, reverse=False, dh_last=None, with_state=False):
    """Check the operands of :func:`selective_scan_bwd_cuda` on the card,
    allocate the gradients and launch the kernel of ``lib`` (a library bound
    by :func:`bind_bwd`; with ``with_state``, by :func:`build_bwd`) once on
    the current stream; raises if the launch fails.  Counts nothing: the
    wrapper does."""
    batch, dim, G, N, L = _check_operands(
        u, delta, A, B, C, D, delta_bias, lib.focalnet_selective_scan_bwd_max_dstate())
    _check(dy.shape == u.shape and dy.dtype in _DTYPES and dy.device == u.device,
           "dy must have y's shape, a float32 or bfloat16 dtype and u's device")
    n_chunks = -(-L // KERNEL_CHUNK)
    _check(hchk is not None and hchk.shape == (batch, dim, n_chunks, N)
           and hchk.dtype == torch.float32 and hchk.device == u.device
           and hchk.is_contiguous(),
           f"hchk must be the forward's fp32 chunk states {(batch, dim, n_chunks, N)}")
    dy = dy.float().contiguous()
    _check(with_state or dh_last is None, "dh_last needs with_state=True")
    if dh_last is not None:
        dh_last = dh_last.float().contiguous()
    _check_state("dh_last", dh_last, u, batch, dim, N)

    du = torch.empty_like(u)
    ddelta = torch.empty_like(delta)
    f32 = dict(dtype=torch.float32, device=u.device)
    dA = torch.zeros(dim, N, **f32)
    dB = torch.zeros(batch, G, N, L, **f32)
    dC = torch.zeros(batch, G, N, L, **f32)
    dD = None if D is None else torch.zeros(dim, **f32)
    dbias = None if delta_bias is None else torch.zeros(dim, **f32)
    ptrs = [_ptr(u), _ptr(delta), _ptr(A), _ptr(B), _ptr(C), _ptr(D), _ptr(delta_bias),
            _ptr(hchk), _ptr(dy), _ptr(du), _ptr(ddelta), _ptr(dA), _ptr(dB), _ptr(dC),
            _ptr(dD), _ptr(dbias)]
    launch, dh0 = lib.focalnet_selective_scan_bwd, None
    if with_state:
        launch = lib.focalnet_selective_scan_bwd_state
        dh0 = torch.empty(batch, dim, N, **f32)
        ptrs += [_ptr(dh_last), _ptr(dh0)]
    with torch.cuda.device(u.device):
        rc = launch(
            *ptrs, batch, dim, G, N, L, int(delta_softplus), int(reverse),
            int(u.dtype == torch.bfloat16), torch.cuda.current_stream(u.device).cuda_stream,
        )
    if rc != 0:
        msg = lib.focalnet_scan_bwd_error_string(rc).decode()
        raise RuntimeError(f"selective_scan_bwd launch failed: {msg} ({rc})")
    grads = (du, ddelta, dA, dB, dC, dD, dbias)
    return grads + (dh0,) if with_state else grads
