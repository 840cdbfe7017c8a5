"""Chunked selective scan in plain PyTorch (``focalnet_tpu/ops/scan_chunked.py``).

This is the plain version of the CUDA kernel in ``ops/csrc``: the CPU path
runs it, and ``chip_smoke.py`` holds the kernel against it on the card.
Within a chunk the pairs ``(a_i, b_i) = (exp(dt_i A), dt_i B_i u_i)`` are
scanned over the monoid

    (a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2)   [left-to-right composition]

(every ``a`` lies in (0, 1] when A < 0, so no intermediate overflows); across
chunks only the carried state ``h`` (batch, dim, N) passes.  The tail past L
is padded with dt = 0, i.e. with the monoid's identity (a=1, b=0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from focalnet_tpu_torch.ops.scan_ref import _expand_groups, _pair_scan, _prepare


def scan_states(a, b, chunk=64, h0=None):
    """Every state of the recurrence ``h_i = a_i h_{i-1} + b_i`` (h_{-1} = 0,
    or ``h0`` of shape (...)) along the last axis of ``a``, ``b`` (..., L): a
    pair scan within chunks of ``chunk`` items, the carried state across
    them."""
    L = a.shape[-1]
    pad = (-L) % chunk
    a = F.pad(a, (0, pad), value=1.0)  # the monoid's identity
    b = F.pad(b, (0, pad))
    lead, n_chunks = a.shape[:-1], (L + pad) // chunk
    a_s, b_s = _pair_scan(a.reshape(*lead, n_chunks, chunk),
                          b.reshape(*lead, n_chunks, chunk))
    h = torch.zeros(lead, dtype=b.dtype, device=b.device) if h0 is None else h0
    prefixes = []
    for c in range(n_chunks):
        prefixes.append(h)
        h = b_s[..., c, -1] + a_s[..., c, -1] * h
    h_in = torch.stack(prefixes, dim=-1)[..., None]  # (..., n_chunks, 1)
    return (b_s + a_s * h_in).reshape(*lead, -1)[..., :L]


def selective_scan_chunked(u, delta, A, B, C, D=None, delta_bias=None,
                           delta_softplus=False, out_dtype=torch.float32,
                           chunk=64, h0=None, return_last_state=False):
    """Chunked selective scan: pair scan within chunks, carried state across.

    Shapes as in :mod:`focalnet_tpu_torch.ops.scan_ref`, ``h0`` and
    ``return_last_state`` (the segment API) too."""
    u, delta, A, B, C, D = _prepare(u, delta, A, B, C, D, delta_bias, delta_softplus)
    dim = u.shape[1]
    dA = torch.exp(delta[:, :, None, :] * A[None, :, :, None])  # (batch, dim, N, L)
    dBu = delta[:, :, None, :] * _expand_groups(B, dim) * u[:, :, None, :]
    hs = scan_states(dA, dBu, chunk, None if h0 is None else h0.float())
    y = (hs * _expand_groups(C, dim)).sum(2)
    if D is not None:
        y = y + u * D[None, :, None]
    return (y.to(out_dtype), hs[..., -1]) if return_last_state else y.to(out_dtype)
