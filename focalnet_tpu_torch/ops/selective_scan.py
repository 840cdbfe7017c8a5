"""Backend dispatcher for the selective scan (``focalnet_tpu/ops/selective_scan.py``).

- ``"cuda"``    — the Hopper kernels (:mod:`.selective_scan_cuda`); CUDA tensors only.
- ``"chunked"`` — plain chunked scan, the kernels' plain version.
- ``"ref"``     — sequential oracle.
- ``"assoc"``   — vectorised oracle, one pair scan over all of L
  (:func:`.scan_ref.selective_scan_assoc`).
- ``"matrix"``  — the chunk-matrix (tril-mask) form
  (:mod:`.scan_matrix`).
- ``"auto"``    — ``cuda`` for CUDA tensors, ``chunked`` for CPU tensors.

Where an input needs a gradient, ``cuda`` and ``chunked`` go through
:class:`SelectiveScanFn` (``focalnet_tpu/ops/pallas_scan.py::_scan_core``'s
custom VJP): on ``cuda`` the forward kernel, saving its chunk states, and the
backward kernel; on ``chunked`` the plain forward and the plain adjoint
(:mod:`.scan_bwd_ref`).  ``ref``, ``assoc`` and ``matrix`` differentiate
their plain ops with autograd.

On the plain backends ``reverse`` is flip / scan / flip and ``y_accum`` a
plain add; the kernels do both natively.

The segment API (``h0=``, ``return_state=True``, as in the JAX dispatcher)
seeds the scan's state and returns the state that leaves it, both plain
(batch, dim, N) fp32 in either direction; its backward takes the leaving
state's cotangent and returns the seed's.  The sequence-sharded scan
(:mod:`focalnet_tpu_torch.parallel.seq_scan`) runs on it.
"""

from __future__ import annotations

import torch

from focalnet_tpu_torch.ops.scan_bwd_ref import selective_scan_bwd_ref
from focalnet_tpu_torch.ops.scan_chunked import selective_scan_chunked
from focalnet_tpu_torch.ops.scan_matrix import selective_scan_matrix
from focalnet_tpu_torch.ops.scan_ref import selective_scan_assoc, selective_scan_ref
from focalnet_tpu_torch.ops.selective_scan_cuda import (
    selective_scan_bwd_cuda,
    selective_scan_cuda,
)

BACKENDS = ("auto", "cuda", "chunked", "assoc", "ref", "matrix")
_PLAIN = {"chunked": selective_scan_chunked, "assoc": selective_scan_assoc,
          "ref": selective_scan_ref, "matrix": selective_scan_matrix}


def _plain_scan(backend, u, delta, A, B, C, D=None, delta_bias=None,
                delta_softplus=False, out_dtype=torch.float32, reverse=False,
                y_accum=None, h0=None, return_state=False):
    flip = (lambda x: torch.flip(x, dims=(-1,))) if reverse else (lambda x: x)
    out = _PLAIN[backend](
        flip(u), flip(delta), A, flip(B), flip(C), D=D, delta_bias=delta_bias,
        delta_softplus=delta_softplus, out_dtype=out_dtype, h0=h0,
        return_last_state=return_state,
    )
    y, h_last = out if return_state else (out, None)
    y = flip(y) if y_accum is None else flip(y) + y_accum
    return (y, h_last) if return_state else y  # the states are not flipped


class SelectiveScanFn(torch.autograd.Function):
    """The scan with its explicit backward: the kernel pair on CUDA tensors
    (``kernel=True``), the plain chunked forward and plain adjoint otherwise.
    The gradient of ``y_accum`` is ``dy`` itself (y = scan + y_accum).  With
    ``h0`` or ``return_state`` the forward also returns ``h_last`` and the
    backward passes its cotangent in and returns ``h0``'s."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, y_accum, h0, delta_softplus,
                reverse, out_dtype, kernel, return_state):
        kw = dict(D=D, delta_bias=delta_bias, delta_softplus=delta_softplus,
                  reverse=reverse, y_accum=y_accum, out_dtype=out_dtype, h0=h0,
                  return_state=return_state)
        if kernel:
            out = selective_scan_cuda(u, delta, A, B, C, chunk_states=True, **kw)
            y, h_last, hchk = out[0], out[1] if return_state else None, out[-1]
        else:
            out = _plain_scan("chunked", u, delta, A, B, C, **kw)
            (y, h_last), hchk = out if return_state else (out, None), None
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias, h0, hchk)
        ctx.flags = (delta_softplus, reverse, kernel, return_state)
        return (y, h_last) if return_state else y

    @staticmethod
    def backward(ctx, dy, dh_last=None):
        u, delta, A, B, C, D, delta_bias, h0, hchk = ctx.saved_tensors
        delta_softplus, reverse, kernel, return_state = ctx.flags
        with_state = h0 is not None or return_state
        needs = ctx.needs_input_grad
        grads, dh0 = [None] * 7, None
        if any(needs[:7]) or needs[8]:
            if kernel:
                out = selective_scan_bwd_cuda(u, delta, A, B, C, D, delta_bias, dy,
                                              hchk, delta_softplus, reverse,
                                              dh_last=dh_last, with_state=with_state)
            else:
                out = selective_scan_bwd_ref(u, delta, A, B, C, D, delta_bias, dy,
                                             delta_softplus, reverse, h0=h0,
                                             dh_last=dh_last, with_state=with_state)
            inputs = (u, delta, A, B, C, D, delta_bias)
            grads = [g.to(x.dtype) if need else None
                     for g, x, need in zip(out, inputs, needs[:7])]
            dh0 = out[7].to(h0.dtype) if needs[8] else None
        return (*grads, dy if needs[7] else None, dh0, None, None, None, None, None)


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus=False, out_dtype=None, backend="auto",
                   reverse=False, y_accum=None, h0=None, return_state=False):
    """Selective scan with the oracle's canonical shapes
    (:mod:`focalnet_tpu_torch.ops.scan_ref`).  ``out_dtype=None`` means fp32
    (the "oflex" contract).  ``reverse=True`` scans right to left;
    ``y_accum`` (y's shape) is added into y.  ``h0`` (batch, dim, N) seeds
    the recurrence; ``return_state=True`` returns ``(y, h_last)``, h_last
    the fp32 state after the last item scanned (item L-1, or item 0 under
    ``reverse``).  On the meta device only the outputs' shapes and dtypes
    are formed, whatever the backend."""
    out_dtype = out_dtype or torch.float32
    if u.is_meta:  # shapes only (a FLOP count): y has u's shape
        y = torch.empty(u.shape, dtype=out_dtype, device=u.device)
        if return_state:
            return y, torch.empty(*u.shape[:2], A.shape[1], device=u.device)
        return y
    if backend == "auto":
        backend = "cuda" if u.is_cuda else "chunked"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "cuda" and not u.is_cuda:
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {u.device}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, delta, A, B, C, D, delta_bias, y_accum, h0))
    if needs_grad and backend in ("cuda", "chunked"):
        return SelectiveScanFn.apply(u, delta, A, B, C, D, delta_bias, y_accum, h0,
                                     delta_softplus, reverse, out_dtype,
                                     backend == "cuda", return_state)
    if backend == "cuda":
        return selective_scan_cuda(
            u, delta, A, B, C, D=D, delta_bias=delta_bias,
            delta_softplus=delta_softplus, reverse=reverse, y_accum=y_accum,
            out_dtype=out_dtype, h0=h0, return_state=return_state,
        )
    return _plain_scan(backend, u, delta, A, B, C, D, delta_bias,
                       delta_softplus, out_dtype, reverse, y_accum, h0, return_state)
