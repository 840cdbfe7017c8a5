"""Sequence-sharded selective scan over a ``torch.distributed`` group
(counterpart of ``focalnet_tpu/parallel/seq_scan.py``).

The operands arrive whole on every rank of a ``seq`` row (replicated
activations, as those ranks run the model's other layers on the same
inputs; under a ``(data, seq)`` mesh each row holds its data index's rows
of the batch).  Each of the ``M`` ranks of the row takes one contiguous
``L / M`` block and:

1. runs the scan kernel on its block through the segment API, which gives
   its output from a zero state and its leaving state ``h_last``; its total
   decay ``a_prod = exp(A * sum(dt))`` has a closed form;
2. all-gathers the ``(batch, dim, N)`` aggregates ``(a_prod, h_last)`` and
   folds those of the ranks before it (after it, under ``reverse``) into
   the state entering its block, ``h_prefix``;
3. adds the prefix's share, ``y_i += C_i . (exp(A cumsum(dt)_i) h_prefix)``
   (the suffix sum under ``reverse``), computed in blocks of L so that no
   ``(batch, dim, N, L / M)`` tensor is kept for the backward;
4. all-gathers the blocks' outputs into the whole ``y``.

Gradients: each pair of collectives is an autograd Function of its own.
The block taken from a replicated operand gets the all-gather of the
blocks' gradients (every rank's layers before the scan need the whole
gradient); a replicated parameter (``A``, ``D``, the dt bias) the sum over
ranks; the gathered output gives each rank its own block of ``dy``, with
no reduction, since ``dy`` is the same on every rank of the row; and the
gathered aggregates the sum over the row of their cotangents, each rank's ``h_last``
feeding the prefixes of the ranks after it.  That sum is the ``dh_last``
with which the backward kernel's segment API starts.  The TPU layout
(``pre_interleaved``) has no counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from focalnet_tpu_torch.ops.selective_scan import selective_scan
from focalnet_tpu_torch.parallel.mesh import (
    GatherShards,
    Mesh,
    SumOverAxis,
    TakeShard,
    all_gather,
    all_reduce,
)

# elements of one (batch, dim, N, block) tensor of the prefix correction
CORRECTION_BLOCK_ELEMS = 1 << 24


class _GatherAggregates(torch.autograd.Function):
    """Each rank's aggregate -> those of every rank of its ``axis`` row,
    stacked (M, ...); backward: the cotangents summed over the row, this
    rank's row."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return all_gather(x.contiguous(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return all_reduce(g.contiguous(), mesh, axis)[mesh.axis_index(axis)], None, None


def _fold_prefix(a_all, h_all, idx, ndev, reverse):
    """The state entering rank ``idx``'s block: the aggregates of the ranks
    before it in scan order (after it, under ``reverse``) composed from a
    zero state, crossing rank i mapping h to ``a_i h + h_i``.  The other
    ranks' aggregates enter as the identity (a = 1, h = 0) times a mask,
    as JAX's ``where`` does, so that every rank's graph holds both
    gathers and every rank joins their collectives in the backward."""
    h = torch.zeros_like(h_all[0])
    for i in (range(ndev - 1, -1, -1) if reverse else range(ndev)):
        take = float(i > idx if reverse else i < idx)
        h = (a_all[i] * take + (1.0 - take)) * h + h_all[i] * take
    return h


class _PrefixCorrection(torch.autograd.Function):
    """``corr[b, d, l] = sum_n C[b, g(d), n, l] exp(A[d, n] cdt[b, d, l])
    h[b, d, n]``, with ``cdt`` the cumulative sum of ``dt`` along l (from
    the right under ``reverse``), in blocks of l; the backward recomputes
    the blocks and keeps only ``cdt`` (batch, dim, L)."""

    @staticmethod
    def forward(ctx, dt, C, A, h, reverse):
        cdt = torch.cumsum(dt, dim=-1)
        if reverse:
            cdt = dt.sum(-1, keepdim=True) - cdt + dt
        ctx.save_for_backward(cdt, C, A, h)
        ctx.reverse = reverse
        out = torch.empty_like(dt)
        for sl, P, Cb, h5, _ in _blocks(cdt, C, A, h):
            b, G, Dp, N, lb = P.shape
            out[..., sl] = (P * Cb * h5).sum(3).reshape(b, G * Dp, lb)
        return out

    @staticmethod
    def backward(ctx, g):
        cdt, C, A, h = ctx.saved_tensors
        b, dim, L = cdt.shape
        G, N = C.shape[1], A.shape[1]
        dC = torch.zeros(b, G, N, L, dtype=torch.float32, device=cdt.device)
        dh = torch.zeros(b, G, dim // G, N, dtype=torch.float32, device=cdt.device)
        dA = torch.zeros(G, dim // G, N, dtype=torch.float32, device=cdt.device)
        dcdt = torch.empty_like(cdt)
        for sl, P, Cb, h5, A5 in _blocks(cdt, C, A, h):
            g5 = g[..., sl].reshape(b, G, dim // G, 1, -1).float()
            gP = g5 * P
            dC[..., sl] = (gP * h5).sum(2)
            gPC = gP * Cb
            dh += gPC.sum(-1)
            w = gPC * h5
            dcdt[..., sl] = (w * A5).sum(3).reshape(b, dim, -1)
            dA += (w * cdt[..., sl].reshape(b, G, dim // G, 1, -1)).sum((0, 4))
        # cdt_l = sum_{k <= l} dt_k (k >= l under reverse)
        if ctx.reverse:
            ddt = torch.cumsum(dcdt, dim=-1)
        else:
            ddt = torch.flip(torch.cumsum(torch.flip(dcdt, (-1,)), dim=-1), (-1,))
        return (ddt, dC.to(C.dtype), dA.reshape(dim, N), dh.reshape(b, dim, N).to(h.dtype),
                None)


def _blocks(cdt, C, A, h):
    """Blocks of l for :class:`_PrefixCorrection`: (slice, exp(A cdt)
    (b, G, D/G, N, lb), C (b, G, 1, N, lb), h (b, G, D/G, N, 1), A (G, D/G, N, 1))."""
    b, dim, L = cdt.shape
    G, N = C.shape[1], A.shape[1]
    Dp = dim // G
    A5 = A.float().reshape(G, Dp, N, 1)
    h5 = h.float().reshape(b, G, Dp, N, 1)
    step = max(1, CORRECTION_BLOCK_ELEMS // (b * dim * N))
    for l0 in range(0, L, step):
        sl = slice(l0, min(l0 + step, L))
        P = torch.exp(A5 * cdt[..., sl].reshape(b, G, Dp, 1, -1))
        yield sl, P, C[:, :, None, :, sl].float(), h5, A5


def selective_scan_seq_sharded(u, delta, A, B, C, D=None, delta_bias=None,
                               delta_softplus=False, *, mesh: Mesh, axis: str = "seq",
                               out_dtype=torch.float32, backend="auto", reverse=False):
    """Selective scan with L sharded over ``mesh``'s ``axis``.

    Shapes as in :mod:`focalnet_tpu_torch.ops.scan_ref`, whole on every rank
    of this rank's ``axis`` row (``L`` a multiple of the axis size); returns
    the whole ``y`` (batch, dim, L) in ``out_dtype`` on every rank.
    ``reverse`` scans right to left: the prefix folds the ranks to the
    right.  Every collective runs over this rank's row of ``axis``, so under
    a ``(data, seq)`` mesh each data index scans its own rows of the batch
    (JAX's ``batch_axis``)."""
    if B.dim() == 3:
        B = B[:, None]
    if C.dim() == 3:
        C = C[:, None]
    ndev, idx = mesh.shape[axis], mesh.axis_index(axis)
    L = u.shape[-1]
    if L % ndev:
        raise ValueError(f"L={L} not divisible by {axis}={ndev}")
    take = lambda t: TakeShard.apply(t, mesh, axis, -1, 1)
    rep = lambda t: None if t is None else SumOverAxis.apply(t, mesh, axis)
    u_l, delta_l, B_l, C_l = take(u), take(delta), take(B), take(C)
    A_r, D_r, bias_r = rep(A), rep(D), rep(delta_bias)

    y_local, h_last = selective_scan(
        u_l, delta_l, A_r, B_l, C_l, D=D_r, delta_bias=bias_r,
        delta_softplus=delta_softplus, out_dtype=torch.float32, backend=backend,
        reverse=reverse, return_state=True)

    dt = delta_l.float()
    if bias_r is not None:
        dt = dt + bias_r.float()[None, :, None]
    if delta_softplus:
        dt = F.softplus(dt)
    A32 = A_r.float()
    a_prod = torch.exp(A32[None] * dt.sum(-1)[..., None])
    a_all = _GatherAggregates.apply(a_prod, mesh, axis)  # (ndev, batch, dim, N)
    h_all = _GatherAggregates.apply(h_last, mesh, axis)
    h_prefix = _fold_prefix(a_all, h_all, idx, ndev, reverse)
    y_local = y_local + _PrefixCorrection.apply(dt, C_l, A32, h_prefix, reverse)
    return GatherShards.apply(y_local, mesh, axis, -1, 1).to(out_dtype)
