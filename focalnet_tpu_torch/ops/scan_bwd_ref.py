"""Plain PyTorch backward of the selective scan: the plain version of the
Hopper backward kernel ``csrc/selective_scan_bwd.cu`` (counterpart of
``focalnet_tpu/ops/pallas_scan.py::_scan_vjp_bwd``).

The explicit adjoint of the recurrence of :mod:`.scan_ref`, per (batch,
channel d) and state n, with ``a_i = exp(dt_i A)`` and ``dt = softplus(delta
+ bias)``:

    G_i    = C_i dy_i + a_{i+1} G_{i+1}           (G_L = 0; right to left)
    du_i   = dt_i sum_n G_i B_i + D dy_i
    ddt_i  = u_i sum_n G_i B_i + sum_n G_i h_{i-1} a_i A
    ddelta = ddt * sigmoid(delta + bias)          (ddt without softplus)
    dA     = sum_{batch, i} G_i h_{i-1} a_i dt_i
    dB_i   = sum_{d in the group} G_i dt_i u_i,   dC_i = sum_{d in group} h_i dy_i
    dD     = sum_{batch, i} dy_i u_i,             dbias = sum_{batch, i} ddelta_i

With the segment API the forward scan starts from ``h0`` and ``dh_last``,
the cotangent of the state after the last item, enters the adjoint as
``G_{L-1} += dh_last``; the cotangent of ``h0`` is ``dh0 = a_0 G_0``.

``reverse`` is flip / adjoint / flip; the states are not flipped.  Both scans run chunked
(:func:`.scan_chunked.scan_states`), so memory stays a few (batch, dim, N, L)
tensors: this is what the CPU path and the plain whole-model gradient on the
card run, where autograd through the chunked scan would keep every doubling
step of every scan alive.  The chip run and the tests hold the kernel
against it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from focalnet_tpu_torch.ops.scan_chunked import scan_states
from focalnet_tpu_torch.ops.scan_ref import _expand_groups, _prepare

KERNEL_CHUNK = 256  # items per chunk of the CUDA kernels (their chunk states)


def _flip(t):
    return None if t is None else torch.flip(t, dims=(-1,))


def selective_scan_bwd_ref(u, delta, A, B, C, D, delta_bias, dy,
                           delta_softplus=False, reverse=False, h0=None,
                           dh_last=None, with_state=False):
    """Gradients of ``sum(y * dy)`` for ``y = selective_scan(u, delta, A, B, C,
    D, delta_bias, delta_softplus, reverse=reverse)`` (shapes of
    :mod:`.scan_ref`).  Returns ``(du, ddelta, dA, dB, dC, dD, dbias)``: du
    and ddelta in the dtypes of u and delta, the rest fp32; dD / dbias are
    None when D / delta_bias are.

    ``with_state=True`` is the segment API's adjoint: the scan started from
    ``h0`` (batch, dim, N; None: zeros), ``sum(h_last * dh_last)`` joins the
    loss (None: nothing), and ``dh0`` (batch, dim, N) fp32 comes back as an
    eighth value."""
    if reverse:
        out = selective_scan_bwd_ref(
            _flip(u), _flip(delta), A, _flip(B), _flip(C), D, delta_bias,
            _flip(dy), delta_softplus, False, h0, dh_last, with_state)
        du, ddelta, dA, dB, dC, dD, dbias = out[:7]
        return (_flip(du), _flip(ddelta), dA, _flip(dB), _flip(dC), dD, dbias) + out[7:]
    pre = delta.float()
    if delta_bias is not None:
        pre = pre + delta_bias.float()[None, :, None]
    uf, dt, Af, Bf, Cf, Df = _prepare(u, delta, A, B, C, D, delta_bias,
                                      delta_softplus)
    batch, dim, L = uf.shape
    G, N = Bf.shape[1], Af.shape[1]
    dyf = dy.float()
    Bx, Cx = _expand_groups(Bf, dim), _expand_groups(Cf, dim)

    a = torch.exp(dt[:, :, None, :] * Af[None, :, :, None])  # (batch, dim, N, L)
    h0 = None if h0 is None else h0.float()
    h = scan_states(a, dt[:, :, None, :] * Bx * uf[:, :, None, :], h0=h0)
    h_prev = (F.pad(h[..., :-1], (1, 0)) if h0 is None
              else torch.cat([h0[..., None], h[..., :-1]], dim=-1))
    a_next = F.pad(a[..., 1:], (0, 1), value=1.0)  # dh_last enters G_{L-1} whole
    Gs = _flip(scan_states(_flip(a_next), _flip(Cx * dyf[:, :, None, :]),
                           h0=None if dh_last is None else dh_last.float()))

    GB = (Gs * Bx).sum(2)
    Gha = Gs * h_prev * a
    du = dt * GB
    if Df is not None:
        du = du + Df[None, :, None] * dyf
    ddt = uf * GB + (Gha * Af[None, :, :, None]).sum(2)
    ddelta = ddt * torch.sigmoid(pre) if delta_softplus else ddt
    dA = (Gha * dt[:, :, None, :]).sum((0, 3))

    def group_sum(x):  # (batch, dim, N, L) -> (batch, G, N, L)
        return x.reshape(batch, G, dim // G, N, L).sum(2)

    dB = group_sum(Gs * (dt * uf)[:, :, None, :])
    dC = group_sum(h * dyf[:, :, None, :])
    dD = (dyf * uf).sum((0, 2)) if D is not None else None
    dbias = ddelta.sum((0, 2)) if delta_bias is not None else None
    grads = (du.to(u.dtype), ddelta.to(delta.dtype), dA, dB, dC, dD, dbias)
    return grads + (a[..., 0] * Gs[..., 0],) if with_state else grads


def chunk_states_ref(u, delta, A, B, delta_bias=None, delta_softplus=False,
                     reverse=False, chunk=KERNEL_CHUNK, h0=None):
    """The fp32 state entering each ``chunk``-item chunk of the forward kernel,
    (batch, dim, n_chunks, N): chunk c covers positions [c*chunk, (c+1)*chunk)
    in either direction; under ``reverse`` its state enters from the right.
    The scan starts from ``h0`` (batch, dim, N) when it is given."""
    uf, dt, Af, Bf, _, _ = _prepare(u, delta, A, B, B, None, delta_bias,
                                    delta_softplus)
    if reverse:
        uf, dt, Bf = _flip(uf), _flip(dt), _flip(Bf)
    dim, L = uf.shape[1], uf.shape[2]
    a = torch.exp(dt[:, :, None, :] * Af[None, :, :, None])
    h = scan_states(a, dt[:, :, None, :] * _expand_groups(Bf, dim) * uf[:, :, None, :],
                    h0=None if h0 is None else h0.float())
    # h[..., k]: the state after k items of the scan
    h = F.pad(h, (1, 0)) if h0 is None else torch.cat([h0.float()[..., None], h], dim=-1)
    n_chunks = -(-L // chunk)
    done = [max(L - (c + 1) * chunk, 0) if reverse else c * chunk
            for c in range(n_chunks)]
    return h[..., done].permute(0, 1, 3, 2).contiguous()
