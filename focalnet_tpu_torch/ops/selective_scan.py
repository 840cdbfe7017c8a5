"""Backend dispatcher for the selective scan (``focalnet_tpu/ops/selective_scan.py``).

- ``"cuda"``    — the Hopper kernels (:mod:`.selective_scan_cuda`); CUDA tensors only.
- ``"chunked"`` — plain chunked scan, the kernels' plain version.
- ``"ref"``     — sequential oracle.
- ``"auto"``    — ``cuda`` for CUDA tensors, ``chunked`` for CPU tensors.

Where an input needs a gradient, ``cuda`` and ``chunked`` go through
:class:`SelectiveScanFn` (``focalnet_tpu/ops/pallas_scan.py::_scan_core``'s
custom VJP): on ``cuda`` the forward kernel, saving its chunk states, and the
backward kernel; on ``chunked`` the plain forward and the plain adjoint
(:mod:`.scan_bwd_ref`).  ``ref`` differentiates the oracle with autograd.

On the plain backends ``reverse`` is flip / scan / flip and ``y_accum`` a
plain add; the kernels do both natively.
"""

from __future__ import annotations

import torch

from focalnet_tpu_torch.ops.scan_bwd_ref import selective_scan_bwd_ref
from focalnet_tpu_torch.ops.scan_chunked import selective_scan_chunked
from focalnet_tpu_torch.ops.scan_ref import selective_scan_ref
from focalnet_tpu_torch.ops.selective_scan_cuda import (
    selective_scan_bwd_cuda,
    selective_scan_cuda,
)

BACKENDS = ("auto", "cuda", "chunked", "ref")
_PLAIN = {"chunked": selective_scan_chunked, "ref": selective_scan_ref}


def _plain_scan(backend, u, delta, A, B, C, D, delta_bias, delta_softplus,
                out_dtype, reverse, y_accum):
    flip = (lambda x: torch.flip(x, dims=(-1,))) if reverse else (lambda x: x)
    y = flip(_PLAIN[backend](
        flip(u), flip(delta), A, flip(B), flip(C), D=D, delta_bias=delta_bias,
        delta_softplus=delta_softplus, out_dtype=out_dtype,
    ))
    return y if y_accum is None else y + y_accum


class SelectiveScanFn(torch.autograd.Function):
    """The scan with its explicit backward: the kernel pair on CUDA tensors
    (``kernel=True``), the plain chunked forward and plain adjoint otherwise.
    The gradient of ``y_accum`` is ``dy`` itself (y = scan + y_accum)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, y_accum, delta_softplus,
                reverse, out_dtype, kernel):
        if kernel:
            y, hchk = selective_scan_cuda(
                u, delta, A, B, C, D=D, delta_bias=delta_bias,
                delta_softplus=delta_softplus, reverse=reverse, y_accum=y_accum,
                out_dtype=out_dtype, chunk_states=True)
        else:
            y = _plain_scan("chunked", u, delta, A, B, C, D, delta_bias,
                            delta_softplus, out_dtype, reverse, y_accum)
            hchk = None
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, hchk)
        ctx.flags = (delta_softplus, reverse, kernel)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, delta, A, B, C, D, delta_bias, hchk = ctx.saved_tensors
        delta_softplus, reverse, kernel = ctx.flags
        needs = ctx.needs_input_grad
        grads = [None] * 7
        if any(needs[:7]):
            if kernel:
                out = selective_scan_bwd_cuda(u, delta, A, B, C, D, delta_bias, dy,
                                              hchk, delta_softplus, reverse)
            else:
                out = selective_scan_bwd_ref(u, delta, A, B, C, D, delta_bias, dy,
                                             delta_softplus, reverse)
            inputs = (u, delta, A, B, C, D, delta_bias)
            grads = [g.to(x.dtype) if need else None
                     for g, x, need in zip(out, inputs, needs[:7])]
        return (*grads, dy if needs[7] else None, None, None, None, None)


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus=False, out_dtype=None, backend="auto",
                   reverse=False, y_accum=None):
    """Selective scan with the oracle's canonical shapes
    (:mod:`focalnet_tpu_torch.ops.scan_ref`).  ``out_dtype=None`` means fp32
    (the "oflex" contract).  ``reverse=True`` scans right to left;
    ``y_accum`` (y's shape) is added into y.  On the meta device only y's
    shape and dtype are formed, whatever the backend."""
    out_dtype = out_dtype or torch.float32
    if u.is_meta:  # shapes only (a FLOP count): y has u's shape
        return torch.empty(u.shape, dtype=out_dtype, device=u.device)
    if backend == "auto":
        backend = "cuda" if u.is_cuda else "chunked"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "cuda" and not u.is_cuda:
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {u.device}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, delta, A, B, C, D, delta_bias, y_accum))
    if needs_grad and backend in ("cuda", "chunked"):
        return SelectiveScanFn.apply(u, delta, A, B, C, D, delta_bias, y_accum,
                                     delta_softplus, reverse, out_dtype,
                                     backend == "cuda")
    if backend == "cuda":
        return selective_scan_cuda(
            u, delta, A, B, C, D=D, delta_bias=delta_bias,
            delta_softplus=delta_softplus, reverse=reverse, y_accum=y_accum,
            out_dtype=out_dtype,
        )
    return _plain_scan(backend, u, delta, A, B, C, D, delta_bias,
                       delta_softplus, out_dtype, reverse, y_accum)
