"""SS2D — the 2-D selective-scan operator (counterpart of ``focalnet_tpu/models/ss2d.py``).

in_proj -> x/z split -> depthwise 3x3 -> SiLU -> 4-direction selective scan
-> out_norm LayerNorm -> gate by z -> out_proj.  The dense path, the
sequence-parallel one (``seq_axis`` with a ``seq_mesh``) and the
channel-split one (``tp_axis`` with the mesh, passed as ``seq_mesh`` as in
the JAX module) are here.

Precision (the JAX module's ``dtype``, ``proj_dtype``, ``ssm_out_dtype``):
the activations arrive in the model's compute dtype and every product runs
in it; ``x_proj`` and ``dt_proj`` take their operands rounded to
``proj_dtype`` when it is set, sum in fp32 and round to the activation dtype;
A, D and the dt bias stay fp32; the scan takes u, delta, B and C in the
activation dtype and writes y, the ``y_accum`` chain and the raster sum in
``out_dtype`` (fp32 by default); ``out_norm`` computes in fp32 and rounds to
the activation dtype.

Directions (``x_proj_weight`` is (K=4, R+2N, d_inner), ``dt_projs_weight``
(4, d_inner, R); ``A_logs``, ``Ds`` and ``dt_projs_bias`` are k-major with
rows k*d_inner:(k+1)*d_inner): k = 0 row raster, 1 column raster, 2 row
raster reversed, 3 column raster reversed.  Per raster the projections run
once on the raster's own (B, D, L) operand, and the reversed direction is
the scan's ``reverse`` mode on the same operands with the forward
direction's output as ``y_accum``.  The sharded paths stack the two
rasters into one (B, 2 d_inner, L) operand with two B/C groups and make two
sharded calls, the forward pair and the reversed pair (JAX's stacked-pair
form): the sequence-parallel path adds their outputs; the channel-split one
gives the forward pair's shard to the reversed pair's kernel as its
``y_accum`` and gathers the channels once.

DropPath and Dropout under data parallelism (:func:`set_dropout_generator`
with ``data_shard``) draw the masks of the whole batch, as one process
would, and keep this rank's rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from focalnet_tpu_torch.models.initializers import (
    a_log_init,
    dt_bias_init,
    uniform_pm,
)
from focalnet_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, gelu_exact, silu
from focalnet_tpu_torch.ops.selective_scan import selective_scan

K_DIRS = 4

_ACTS = {
    "silu": silu,
    "gelu": gelu_exact,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
}


def parse_forward_type(forward_type: str):
    """Split a forward_type tag into (base, flags): the reference's suffix
    chain ``no32``, ``noz``, ``nozact``, then one of ``none``, ``dwconv3``,
    ``softmax``, ``sigmoid`` (default out-norm ``ln``)."""
    ft = forward_type
    flags = {}

    def strip(tag):
        nonlocal ft
        if ft.endswith(tag):
            ft = ft[: -len(tag)]
            return True
        return False

    flags["disable_force32"] = strip("no32")
    flags["disable_z"] = strip("noz")
    flags["disable_z_act"] = strip("nozact")
    if strip("none"):
        flags["out_norm"] = "none"
    elif strip("dwconv3"):
        flags["out_norm"] = "dwconv3"
    elif strip("softmax"):
        flags["out_norm"] = "softmax"
    elif strip("sigmoid"):
        flags["out_norm"] = "sigmoid"
    else:
        flags["out_norm"] = "ln"
    # force_fp32 per base tag: v1 always, v01/v2 unless no32, v3/v4 never
    flags["force_fp32"] = ft == "v1" or (
        ft in ("v01", "v2") and not flags["disable_force32"]
    )
    flags["base"] = ft
    return flags


class DropPath(nn.Module):
    """Per-sample stochastic depth; the identity in eval mode.

    In training mode the masks come from ``self.generator``, a
    ``torch.Generator`` on the device of x that :func:`set_dropout_generator`
    hands to every DropPath of a model (the JAX module draws from
    ``make_rng("droppath")``); without one it raises rather than draw from
    the global RNG."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None
        self.data_shard = (0, 1)

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise RuntimeError("DropPath in training mode needs a generator: "
                               "call set_dropout_generator(model, generator)")
        keep = 1.0 - self.rate
        mask = _draw((x.shape[0],) + (1,) * (x.dim() - 1), self.generator, x.device,
                     self.data_shard) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Elementwise dropout whose masks come from ``self.generator``, the
    ``torch.Generator`` that :func:`set_dropout_generator` hands it (the JAX
    module draws from ``make_rng("dropout")``); the identity, drawing
    nothing, at rate 0 and in eval mode.  Without a generator, training at a
    nonzero rate raises rather than draw from the global RNG.  No
    parameters or buffers: the state dict does not change."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None
        self.data_shard = (0, 1)

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training mode needs a generator: "
                               "call set_dropout_generator(model, generator)")
        keep = 1.0 - self.rate
        mask = _draw(tuple(x.shape), self.generator, x.device, self.data_shard) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def _draw(shape, generator, device, data_shard):
    """Uniform draws for this rank's ``shape[0]`` rows: those of a batch of
    ``shape[0] * n`` drawn whole, rows ``i * shape[0]`` on, for
    ``data_shard = (i, n)``; with (0, 1) one draw of ``shape``."""
    i, n = data_shard
    b = shape[0]
    return torch.rand((b * n,) + tuple(shape[1:]), generator=generator,
                      device=device)[i * b:(i + 1) * b]


def set_dropout_generator(model: nn.Module, generator: torch.Generator,
                          data_shard=(0, 1)) -> None:
    """Give every DropPath and Dropout of ``model`` the one ``generator``
    (on the device the model runs on) to draw its masks from.
    ``data_shard = (i, n)``: this rank is data index ``i`` of ``n`` and its
    batch the ``i``-th of ``n`` equal blocks of the whole, whose masks are
    drawn whole (the masks one process draws for the whole batch)."""
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = generator
            m.data_shard = tuple(data_shard)


class Mlp(nn.Module):
    """fc1 -> activation -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features, hidden_features, out_features=None,
                 act="gelu", drop=0.0):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features or in_features)
        self.act = _ACTS[act]
        self.drop = Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


class SS2D(nn.Module):
    """2-D selective scan operator on NHWC feature maps: the dense path, or
    with ``seq_mesh`` (a :class:`..parallel.Mesh`) the scans sharded over L
    along ``seq_axis`` or over the channels along ``tp_axis`` (one of the
    two)."""

    def __init__(self, d_model, d_state=16, ssm_ratio=2.0, dt_rank="auto",
                 act="silu", d_conv=3, conv_bias=True, dropout=0.0, bias=False,
                 dt_min=0.001, dt_max=0.1, dt_scale=1.0, dt_init_floor=1e-4,
                 initialize="v0", forward_type="v4", scan_backend="auto",
                 proj_dtype=None, out_dtype=None, seq_mesh=None, seq_axis=None,
                 tp_axis=None):
        super().__init__()
        if seq_mesh is not None and seq_axis is not None and tp_axis is not None:
            raise ValueError("seq_axis and tp_axis both shard the same scan call; pick one "
                             "(they compose with data_axis, not each other)")
        flags = parse_forward_type(forward_type)
        if flags["out_norm"] != "ln" or flags["disable_z"] or flags["disable_z_act"]:
            raise NotImplementedError(
                f"forward_type {forward_type!r}: only the LayerNorm out-norm with "
                "the activated z gate (v4 and its kin) is ported; see ROADMAP.md")
        if initialize != "v0" or d_conv <= 1:
            raise NotImplementedError(
                "only initialize='v0' with a depthwise conv (d_conv > 1) is ported")
        self.d_inner = D = int(ssm_ratio * d_model)
        self.d_state = N = d_state
        self.rank = R = math.ceil(d_model / 16) if dt_rank == "auto" else dt_rank
        self.act = _ACTS[act]
        self.scan_backend = scan_backend
        self.proj_dtype = proj_dtype  # None: the activations' dtype
        self.out_dtype = out_dtype or torch.float32
        self.dt_scale = dt_scale
        self.dt_range = (dt_min, dt_max, dt_init_floor)
        # the sharded scans' parallel.Mesh (not a module: it holds no
        # parameters, and the state dict does not change)
        self.seq_mesh, self.seq_axis, self.tp_axis = seq_mesh, seq_axis, tp_axis

        self.in_proj = Linear(d_model, 2 * D, bias=bias)
        self.conv2d = Conv2d(D, D, d_conv, padding=(d_conv - 1) // 2,
                             groups=D, bias=conv_bias)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * N, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, D))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * D, N))
        self.Ds = nn.Parameter(torch.empty(K_DIRS * D))
        self.out_norm = LayerNorm(D, eps=1e-5)
        self.out_proj = Linear(D, d_model, bias=bias)
        self.dropout = Dropout(dropout)

    @torch.no_grad()
    def reset_parameters_from(self, generator: torch.Generator) -> None:
        """The v0 laws of the raw parameter stacks."""
        uniform_pm(self.x_proj_weight, 1.0 / math.sqrt(self.d_inner), generator)
        uniform_pm(self.dt_projs_weight, self.dt_scale * self.rank ** -0.5, generator)
        dt_bias_init(self.dt_projs_bias, generator, *self.dt_range)
        a_log_init(self.A_logs, generator)
        self.Ds.fill_(1.0)

    def _project(self, w, t, dtype):
        """``w @ t`` as the JAX module's einsum: the operands rounded to
        ``proj_dtype`` when it is set, the products summed in fp32, the
        result rounded to ``dtype``."""
        if self.proj_dtype is not None:
            w, t = w.to(self.proj_dtype), t.to(self.proj_dtype)
        return torch.matmul(w.float(), t.float()).to(dtype)

    def _core(self, x):
        """4-direction scan of NCHW (B, D, H, W) -> normalised NHWC (B, H, W, D)
        in x's dtype."""
        Bsz, D, H, W = x.shape
        N, R, L = self.d_state, self.rank, H * W
        A = -torch.exp(self.A_logs.float())  # (4D, N), k-major rows
        Ds = self.Ds.float()
        bias = self.dt_projs_bias.reshape(-1).float()
        if self.seq_mesh is not None and (self.seq_axis or self.tp_axis) is not None:
            return self._core_sharded(x, A, Ds, bias)

        y = None
        for i, col in enumerate((False, True)):
            xr = (x.transpose(2, 3) if col else x).reshape(Bsz, D, L).contiguous()
            # one product gives dt/B/C of both directions of this raster
            w2 = torch.cat([self.x_proj_weight[i], self.x_proj_weight[i + 2]], dim=0)
            xd = self._project(w2, xr, x.dtype)  # (B, 2(R+2N), L)
            dts_f, Bs_f, Cs_f, dts_r, Bs_r, Cs_r = torch.split(
                xd, [R, N, N, R, N, N], dim=1)

            def dscan(dts, Bm, Cm, k, reverse, y_accum=None):
                rows = slice(k * D, (k + 1) * D)
                return selective_scan(
                    xr, self._project(self.dt_projs_weight[k], dts, x.dtype),
                    A[rows], Bm[:, None].contiguous(), Cm[:, None].contiguous(),
                    D=Ds[rows], delta_bias=bias[rows], delta_softplus=True,
                    out_dtype=self.out_dtype, backend=self.scan_backend,
                    reverse=reverse, y_accum=y_accum,
                )

            ys = dscan(dts_r, Bs_r, Cs_r, i + 2, True,
                       y_accum=dscan(dts_f, Bs_f, Cs_f, i, False))
            yr = ys.reshape(Bsz, D, W, H).transpose(2, 3) if col else ys.reshape(Bsz, D, H, W)
            y = yr if y is None else y + yr
        return self.out_norm(y.permute(0, 2, 3, 1).float()).to(x.dtype)

    def _core_sharded(self, x, A, Ds, bias):
        """``_core`` with every scan sharded across the mesh: the row and
        column rasters stacked into one (B, 2D, L) operand, G = 2 B/C groups,
        one call for the forward pair (k = 0, 1) and one reversed for the
        other (k = 2, 3).  Over ``seq_axis`` (L a multiple of its size) the
        two calls' outputs are added; over ``tp_axis`` the reversed pair's
        kernel adds the forward pair's channel shard (``y_accum``) and the
        channels are gathered once."""
        from focalnet_tpu_torch.parallel.seq_scan import selective_scan_seq_sharded
        from focalnet_tpu_torch.parallel.tp_scan import selective_scan_tp

        Bsz, D, H, W = x.shape
        N, R, L = self.d_state, self.rank, H * W
        x2 = torch.stack([x.reshape(Bsz, D, L), x.transpose(2, 3).reshape(Bsz, D, L)],
                         dim=1)  # (B, 2, D, L)
        u2 = x2.reshape(Bsz, 2 * D, L)

        def scan(k0, reverse, **kw):
            # dt, B, C of directions k0 (row) and k0 + 1 (column)
            ks = slice(k0, k0 + 2)
            xd = self._project(self.x_proj_weight[ks], x2, x.dtype)  # (B, 2, R+2N, L)
            dts, Bs, Cs = torch.split(xd, [R, N, N], dim=2)
            delta = self._project(self.dt_projs_weight[ks], dts, x.dtype)  # (B, 2, D, L)
            rows = slice(k0 * D, (k0 + 2) * D)
            sharded = (selective_scan_seq_sharded if self.tp_axis is None
                       else selective_scan_tp)
            return sharded(
                u2, delta.reshape(Bsz, 2 * D, L), A[rows], Bs.contiguous(), Cs.contiguous(),
                D=Ds[rows], delta_bias=bias[rows], delta_softplus=True, mesh=self.seq_mesh,
                axis=self.tp_axis or self.seq_axis, out_dtype=self.out_dtype,
                backend=self.scan_backend, reverse=reverse, **kw)

        if self.tp_axis is None:
            ys_f = scan(0, False)
            ys = scan(2, True) + ys_f
        else:
            ys = scan(2, True, y_accum=scan(0, False, gather=False))
        ys = ys.reshape(Bsz, 2, D, L)
        y = ys[:, 0].reshape(Bsz, D, H, W) + ys[:, 1].reshape(Bsz, D, W, H).transpose(2, 3)
        return self.out_norm(y.permute(0, 2, 3, 1).float()).to(x.dtype)

    def forward(self, x):
        """x: (B, H, W, d_model) -> (B, H, W, d_model)."""
        h, z = self.in_proj(x).chunk(2, dim=-1)
        z = self.act(z)
        h = self.act(self.conv2d(h.permute(0, 3, 1, 2)))
        y = self._core(h) * z
        return self.dropout(self.out_proj(y))
