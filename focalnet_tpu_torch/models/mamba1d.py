"""Mamba1D and MambaSS2D (counterpart of ``focalnet_tpu/models/mamba1d.py``).

``MambaSS2D`` is the bidirectional 1-D Mamba block over the flattened H W
sequence: in_proj -> x/z split -> depthwise conv -> SiLU -> a
:class:`Mamba1D` pass over the sequence (``mamba_fwd``) plus one over the
flipped sequence (``mamba_bwd``), flipped back and summed -> gate by SiLU(z)
-> out_proj.  No preset uses it.  The inner Mamba1D runs on the same
selective scan as SS2D, one direction and one B/C group: on the card, the
Hopper kernels.  At the model's width (``d_model`` 96) the inner block is 192
wide and expands to 384 scanned channels.

Everything computes in fp32, as the JAX modules (which take no ``dtype``).
Mamba1D's raw parameters keep the JAX module's names and layouts, which are
the names the JAX converter emits: ``conv1d_weight`` (K, D),
``conv1d_bias``, ``x_proj_weight`` (R + 2N, D), ``dt_proj_weight`` (D, R),
``dt_proj_bias``, ``A_logs`` (D, N), ``Ds``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from focalnet_tpu_torch.models.initializers import (
    a_log_init,
    dt_bias_init,
    torch_default,
    uniform_pm,
)
from focalnet_tpu_torch.models.layers import Conv2d, Linear
from focalnet_tpu_torch.models.ss2d import Dropout
from focalnet_tpu_torch.ops.selective_scan import selective_scan


def causal_conv1d(x, w, b=None):
    """Causal depthwise conv1d: x (B, L, D), taps w (K, D), optional bias
    (D,); left-padded by K - 1, so position t sees t - K + 1 .. t.  Returns
    (B, L, D)."""
    K, D = w.shape
    out = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), w.t()[:, None, :], groups=D)
    out = out.transpose(1, 2)
    return out if b is None else out + b


class Mamba1D(nn.Module):
    """One direction of Mamba (S6) on (B, L, d_model) sequences, the
    ``mamba_ssm.Mamba`` equivalent: in_proj -> causal conv1d -> SiLU -> the
    selective scan (``d_inner = expand * d_model`` channels, one B/C group)
    -> gate by SiLU(z) -> out_proj."""

    def __init__(self, d_model, d_state=16, expand=2, d_conv=4, dt_rank="auto",
                 conv_bias=True, bias=False, scan_backend="auto"):
        super().__init__()
        self.d_inner = D = expand * d_model
        self.d_state = N = d_state
        self.rank = R = math.ceil(d_model / 16) if dt_rank == "auto" else dt_rank
        self.scan_backend = scan_backend
        self.in_proj = Linear(d_model, 2 * D, bias=bias)
        self.conv1d_weight = nn.Parameter(torch.empty(d_conv, D))
        self.conv1d_bias = nn.Parameter(torch.empty(D)) if conv_bias else None
        self.x_proj_weight = nn.Parameter(torch.empty(R + 2 * N, D))
        self.dt_proj_weight = nn.Parameter(torch.empty(D, R))
        self.dt_proj_bias = nn.Parameter(torch.empty(D))
        self.A_logs = nn.Parameter(torch.empty(D, N))
        self.Ds = nn.Parameter(torch.empty(D))
        self.out_proj = Linear(D, d_model, bias=bias)

    @torch.no_grad()
    def reset_parameters_from(self, generator: torch.Generator) -> None:
        """The JAX module's laws: the conv taps and bias U(+-1/sqrt(K)),
        x_proj U(+-1/sqrt(d_inner)), dt_proj U(+-R^-0.5), the
        softplus-inverse dt bias, A_log = log(1..N), D = 1."""
        K = self.conv1d_weight.shape[0]
        torch_default(self.conv1d_weight, K, generator)
        if self.conv1d_bias is not None:
            torch_default(self.conv1d_bias, K, generator)
        uniform_pm(self.x_proj_weight, 1.0 / math.sqrt(self.d_inner), generator)
        uniform_pm(self.dt_proj_weight, self.rank ** -0.5, generator)
        dt_bias_init(self.dt_proj_bias, generator)
        a_log_init(self.A_logs, generator)
        self.Ds.fill_(1.0)

    def forward(self, x):
        """x: (B, L, d_model) -> (B, L, d_model)."""
        R, N = self.rank, self.d_state
        h, z = self.in_proj(x).chunk(2, dim=-1)
        h = F.silu(causal_conv1d(h, self.conv1d_weight, self.conv1d_bias))
        u = h.transpose(1, 2).contiguous()  # (B, D, L)
        dts, Bm, Cm = torch.split(torch.matmul(self.x_proj_weight, u), [R, N, N], dim=1)
        y = selective_scan(
            u, torch.matmul(self.dt_proj_weight, dts), -torch.exp(self.A_logs.float()),
            Bm[:, None].contiguous(), Cm[:, None].contiguous(), D=self.Ds,
            delta_bias=self.dt_proj_bias, delta_softplus=True, out_dtype=torch.float32,
            backend=self.scan_backend)
        return self.out_proj(y.transpose(1, 2).to(x.dtype) * F.silu(z))


class MambaSS2D(nn.Module):
    """Bidirectional 1-D Mamba over the flattened H W grid: the forward and
    the flipped pass (two :class:`Mamba1D`, ``d_model = d_inner``), summed,
    then gated.  The activation is SiLU (the JAX module's ``act`` field is
    read nowhere, and the port has none)."""

    def __init__(self, d_model, d_state=16, ssm_ratio=2.0, d_conv=3, conv_bias=True,
                 bias=False, dropout=0.0, scan_backend="auto"):
        super().__init__()
        self.d_inner = D = int(ssm_ratio * d_model)
        self.in_proj = Linear(d_model, 2 * D, bias=bias)
        self.conv2d = Conv2d(D, D, d_conv, padding=(d_conv - 1) // 2, groups=D,
                             bias=conv_bias)
        self.mamba_fwd = Mamba1D(D, d_state=d_state, scan_backend=scan_backend)
        self.mamba_bwd = Mamba1D(D, d_state=d_state, scan_backend=scan_backend)
        self.out_proj = Linear(D, d_model, bias=bias)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        """x: (B, H, W, d_model) -> (B, H, W, d_model)."""
        Bsz, H, W, _ = x.shape
        h, z = self.in_proj(x).chunk(2, dim=-1)
        h = F.silu(self.conv2d(h.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        seq = h.reshape(Bsz, H * W, self.d_inner)
        y = self.mamba_fwd(seq) + self.mamba_bwd(seq.flip(1)).flip(1)
        y = y.reshape(Bsz, H, W, self.d_inner) * F.silu(z)
        return self.dropout(self.out_proj(y))
