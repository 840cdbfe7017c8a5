"""The selective scan in plain fp32 PyTorch, computed in blocks of L.

For each (row, channel) pair, with dt = softplus(delta + bias) and a state
of N values:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t
    y_t = <C_t, h_t> + D u_t

Shapes: u, delta (b, d, L); A (d, N); B, C (b, N, L) (one group); D, bias
(d,).  The scan runs over blocks of L whose (b, d, N, T) intermediates
hold at most ``BLOCK_ELEMS`` values; within a block the pairs
(exp(dt A), dt B u) are scanned by doubling, and the state passes from block
to block.  Forward only: the benchmark's check runs under ``no_grad``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK_ELEMS = 1 << 24


def _block_len(rows: int, L: int) -> int:
    t = 1
    while t * 2 <= L and rows * t * 2 <= BLOCK_ELEMS:
        t *= 2
    return t


def _pair_scan(a, x):
    """Inclusive scan of h_t = a_t h_{t-1} + x_t along the last axis (h_{-1} = 0)."""
    T, s = a.shape[-1], 1
    while s < T:
        x = torch.cat([x[..., :s], a[..., s:] * x[..., :-s] + x[..., s:]], dim=-1)
        a = torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], dim=-1)
        s *= 2
    return x


def _block(u, dt, A, B, C, h0):
    """y (without the D term) and the last state of one block."""
    a = torch.exp(dt[:, :, None, :] * A[None, :, :, None])
    x = (dt * u)[:, :, None, :] * B[:, None, :, :]
    x = torch.cat([x[..., :1] + a[..., :1] * h0[..., None], x[..., 1:]], dim=-1)
    h = _pair_scan(a, x)
    return (h * C[:, None, :, :]).sum(2), h[..., -1]


def selective_scan(u, delta, A, B, C, D, bias, reverse=False):
    """The scan of the module docstring, right to left under ``reverse``;
    fp32 in and out.  On the meta device y only depends on every input by
    elementwise operations, which count no FLOPs."""
    if u.is_meta:
        return (u + delta + (B.sum(1) + C.sum(1))[:, None] + A.sum()
                + (D + bias)[None, :, None])
    if reverse:
        flip = lambda t: t.flip(-1)  # noqa: E731
        return flip(selective_scan(flip(u), flip(delta), A, flip(B), flip(C), D, bias))
    b, d, L = u.shape
    T = _block_len(b * d * A.shape[1], L)
    h = torch.zeros(b, d, A.shape[1], dtype=torch.float32, device=u.device)
    ys = []
    for s in range(0, L, T):
        dt = F.softplus(delta[..., s:s + T] + bias[None, :, None])
        y, h = _block(u[..., s:s + T], dt, A, B[..., s:s + T], C[..., s:s + T], h)
        ys.append(y)
    return torch.cat(ys, dim=-1) + D[None, :, None] * u


def selective_scan_steps(u, delta, A, B, C, D, bias):
    """The same recurrence one position at a time: the check of the blocked
    form in the tests (small shapes only)."""
    dt = F.softplus(delta + bias[None, :, None])
    h = torch.zeros(*u.shape[:2], A.shape[1], dtype=torch.float32, device=u.device)
    ys = []
    for t in range(u.shape[-1]):
        h = torch.exp(dt[..., t, None] * A) * h + (dt[..., t] * u[..., t])[..., None] * B[:, None, :, t]
        ys.append((h * C[:, None, :, t]).sum(-1))
    return torch.stack(ys, dim=-1) + D[None, :, None] * u
