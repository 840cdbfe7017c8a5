"""Chunk-matrix ("tril-mask") selective scan in plain PyTorch
(``focalnet_tpu/ops/scan_matrix.py``).

Per chunk of T items the intra-chunk outputs are dense masked products
instead of a scan (per batch row and channel d):

    s_l   = cumsum(dt)_l                       (inclusive)
    w     = exp(A[d, n] (s_l - s_mid))         (decay to the chunk's midpoint)
    M[l, r] = sum_n  C_l[n] w[l, n] B_r[n] / w[r, n]
    y1[l]   = sum_{r <= l}  M[l, r] (dt u)[r]
    y0[l]   = sum_n  C_l[n] w[l, n] exp(A s_mid)[n] h0[n]
    h_out   = w[-1] (exp(A s_mid) h0 + sum_l B_l[n] (dt u)[l] / w[l, n])

with the state carried across chunks.  The exponents are centred on the
chunk's midpoint as in the JAX module, so the factors ``w`` and ``1/w``
stay finite while ``max|A| * (a chunk's sum of dt) < ~160``; the masked
(r > l) entries are selected away, never multiplied by zero.  Ragged L is
padded with dt = 0, the recurrence's identity.  Every product is a plain
``torch`` einsum in fp32: the JAX package runs this form outside any Pallas
kernel, and so does the port (the ``matrix`` backend of the dispatcher).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from focalnet_tpu_torch.ops.scan_ref import _expand_groups, _prepare

DEF_MATRIX_CHUNK = 64  # the JAX module's default


def selective_scan_matrix(u, delta, A, B, C, D=None, delta_bias=None,
                          delta_softplus=False, out_dtype=torch.float32,
                          chunk=DEF_MATRIX_CHUNK, h0=None, return_last_state=False):
    """Tril-mask matrix-form selective scan; shapes as in
    :mod:`.scan_ref`, ``h0`` and ``return_last_state`` too.  ``chunk < 1``
    takes the whole sequence as one chunk."""
    u, delta, A, B, C, D = _prepare(u, delta, A, B, C, D, delta_bias, delta_softplus)
    batch, dim, L = u.shape
    if chunk < 1:
        chunk = L
    pad = (-L) % chunk
    if pad:  # dt = 0 pads: w extends flat, dt u = 0
        u, delta, B, C = (F.pad(t, (0, pad)) for t in (u, delta, B, C))
    Bx, Cx = _expand_groups(B, dim), _expand_groups(C, dim)  # (batch, dim, N, Lp)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=u.device).tril()
    h = (torch.zeros(batch, dim, A.shape[1], device=u.device) if h0 is None
         else h0.float())
    ys = []
    for c0 in range(0, L + pad, chunk):
        cu, cdt = u[..., c0:c0 + chunk], delta[..., c0:c0 + chunk]
        ck, cq = Bx[..., c0:c0 + chunk], Cx[..., c0:c0 + chunk]
        s = torch.cumsum(cdt, dim=-1)  # (batch, dim, T)
        s_mid = s[..., chunk // 2, None]  # (batch, dim, 1)
        w = torch.exp(A[None, :, :, None] * (s - s_mid)[:, :, None, :])  # (batch, dim, N, T)
        w_mid = torch.exp(A[None] * s_mid)  # (batch, dim, N)
        v = cu * cdt
        k_div_w, q_mul_w = ck / w, cq * w
        M = torch.einsum("bdnl,bdnr->bdlr", q_mul_w, k_div_w)
        y1 = torch.einsum("bdlr,bdr->bdl", torch.where(mask, M, torch.zeros_like(M)), v)
        h1 = w[..., -1] * torch.einsum("bdnr,bdr->bdn", k_div_w, v)
        h_eff = w_mid * h
        ys.append(y1 + torch.einsum("bdnl,bdn->bdl", q_mul_w, h_eff))
        h = w[..., -1] * h_eff + h1
    y = torch.cat(ys, dim=-1)[..., :L]
    if D is not None:
        y = y + u[..., :L] * D[None, :, None]
    return (y.to(out_dtype), h) if return_last_state else y.to(out_dtype)
