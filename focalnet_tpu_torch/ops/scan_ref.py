"""Selective-scan oracles in plain PyTorch (``focalnet_tpu/ops/scan_ref.py``).

The Mamba S6 recurrence, for each (batch, channel) pair with per-step ``dt``
and state size N:

    h_i = exp(dt_i * A) * h_{i-1} + dt_i * B_i * u_i        (h in R^N)
    y_i = <C_i, h_i> + D * u_i

fp32 state regardless of input dtype, optional ``delta_bias`` added before an
optional softplus, optional ``D`` skip, fp32 output by default (the "oflex"
contract).  Canonical shapes (G = number of B/C groups, dim % G == 0):

    u, delta : (batch, dim, L)
    A        : (dim, N)
    B, C     : (batch, G, N, L)
    D        : (dim,) or None
    delta_bias : (dim,) or None

Two oracles, as in the JAX module: :func:`selective_scan_ref`, one step at a
time, and :func:`selective_scan_assoc`, a parallel prefix scan over the
(a, b) pairs of the whole sequence (the ``assoc`` backend).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _prepare(u, delta, A, B, C, D, delta_bias, delta_softplus):
    """Common input canonicalization: fp32 compute, delta bias/softplus."""
    u = u.float()
    delta = delta.float()
    A = A.float()
    B = B.float()
    C = C.float()
    if B.dim() == 3:  # (batch, N, L) -> single group
        B = B[:, None]
    if C.dim() == 3:
        C = C[:, None]
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, :, None]
    if delta_softplus:
        delta = F.softplus(delta)
    if D is not None:
        D = D.float()
    return u, delta, A, B, C, D


def _expand_groups(BC, dim):
    """(batch, G, N, L) -> (batch, dim, N, L) by repeating each group."""
    return torch.repeat_interleave(BC, dim // BC.shape[1], dim=1)


def _pair_scan(a, b):
    """Inclusive (a, b) pair scan along the last axis over the monoid
    ``(a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2)`` (Hillis-Steele doubling,
    the stable tree order of ``jax.lax.associative_scan``)."""
    T = a.shape[-1]
    shift = 1
    while shift < T:
        a_prev = F.pad(a[..., :-shift], (shift, 0), value=1.0)
        b_prev = F.pad(b[..., :-shift], (shift, 0), value=0.0)
        b = a * b_prev + b
        a = a * a_prev
        shift *= 2
    return a, b


def selective_scan_ref(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, out_dtype=torch.float32, h0=None,
                       return_last_state=False):
    """Sequential oracle: one Python step per position.  Tests and small
    shapes only.  ``h0`` (batch, dim, N) seeds the recurrence instead of
    zeros; ``return_last_state=True`` also returns the state after the last
    position, (batch, dim, N) fp32 (the segment API)."""
    u, delta, A, B, C, D = _prepare(u, delta, A, B, C, D, delta_bias, delta_softplus)
    batch, dim, L = u.shape
    Bx = _expand_groups(B, dim)  # (batch, dim, N, L)
    Cx = _expand_groups(C, dim)
    dA = torch.exp(delta[:, :, None, :] * A[None, :, :, None])  # (batch, dim, N, L)
    dBu = delta[:, :, None, :] * Bx * u[:, :, None, :]
    h = (torch.zeros(batch, dim, A.shape[1], dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(L):
        h = dA[..., i] * h + dBu[..., i]
        ys.append((h * Cx[..., i]).sum(-1))
    y = torch.stack(ys, dim=-1)
    if D is not None:
        y = y + u * D[None, :, None]
    return (y.to(out_dtype), h) if return_last_state else y.to(out_dtype)


def selective_scan_assoc(u, delta, A, B, C, D=None, delta_bias=None,
                         delta_softplus=False, out_dtype=torch.float32, h0=None,
                         return_last_state=False):
    """Vectorised oracle: one pair scan over all L positions
    (``selective_scan_assoc`` of the JAX module, ``lax.associative_scan``
    there).  It holds (batch, dim, N, L) intermediates: tests and small
    shapes only.  ``h0`` enters every position through the scanned decay
    (``h_i += a_0 ... a_i h0``); ``return_last_state=True`` also returns
    ``h[..., -1]``."""
    u, delta, A, B, C, D = _prepare(u, delta, A, B, C, D, delta_bias, delta_softplus)
    dim = u.shape[1]
    a = torch.exp(delta[:, :, None, :] * A[None, :, :, None])  # (batch, dim, N, L)
    b = delta[:, :, None, :] * _expand_groups(B, dim) * u[:, :, None, :]
    a_scan, h = _pair_scan(a, b)
    if h0 is not None:
        h = h + a_scan * h0.float()[..., None]
    y = (h * _expand_groups(C, dim)).sum(2)
    if D is not None:
        y = y + u * D[None, :, None]
    return (y.to(out_dtype), h[..., -1]) if return_last_state else y.to(out_dtype)
