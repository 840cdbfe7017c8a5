"""SS2D — the 2-D selective-scan operator (counterpart of ``focalnet_tpu/models/ss2d.py``).

in_proj -> x/z split -> depthwise 3x3 -> SiLU -> 4-direction selective scan
-> out_norm LayerNorm -> gate by z -> out_proj.  Every ``forward_type`` of
the JAX module's tag grammar is taken (:func:`parse_forward_type`): the
out-norms ``none``, ``dwconv3`` (a depthwise 3x3 conv named ``out_norm``),
``softmax`` (over the H W positions of each channel) and ``sigmoid``;
``noz`` (``in_proj`` d_inner wide, no gate) and ``nozact`` (the raw z
gates); ``force_fp32`` (base tags v1, and v01 / v2 without ``no32``).  So are
``initialize`` v0, v1 and v2 and ``d_conv <= 1`` (no depthwise conv, no
``conv2d`` keys).  The dense path, the
sequence-parallel one (``seq_axis`` with a ``seq_mesh``) and the
channel-split one (``tp_axis`` with the mesh, passed as ``seq_mesh`` as in
the JAX module) are here.

Precision (the JAX module's ``dtype``, ``proj_dtype``, ``ssm_out_dtype``):
the activations arrive in the model's compute dtype and every product runs
in it; ``x_proj`` and ``dt_proj`` take their operands rounded to
``proj_dtype`` when it is set, sum in fp32 and round to the activation dtype;
A, D and the dt bias stay fp32; the scan takes u, delta, B and C in the
activation dtype and writes y, the ``y_accum`` chain and the raster sum in
``out_dtype`` (fp32 by default); the out-norm follows (LayerNorm, dwconv3
and softmax in fp32), its result is rounded to the activation dtype, then
gated.  Under ``force_fp32`` u, delta, B and C, each first rounded to the
activation dtype, reach the scan widened to fp32, as in the JAX module: in
a bf16 model the kernels then take fp32 operands.

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
    normal,
    uniform,
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
        self.data_shard = None

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
        self.data_shard = None

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
    """Uniform draws for this rank's ``shape[0]`` rows: with ``data_shard =
    (start, total)`` rows ``start`` on of a batch of ``total`` rows drawn
    whole; with None one draw of ``shape``."""
    if data_shard is None:
        return torch.rand(shape, generator=generator, device=device)
    start, total = data_shard
    return torch.rand((total,) + tuple(shape[1:]), generator=generator,
                      device=device)[start:start + shape[0]]


def set_dropout_generator(model: nn.Module, generator: torch.Generator,
                          data_shard=None) -> None:
    """Give every DropPath and Dropout of ``model`` the one ``generator``
    (on the device the model runs on) to draw its masks from.
    ``data_shard = (start, total)``: this rank's rows are rows ``start`` on
    of a batch of ``total``, whose masks are drawn whole (the masks one
    process draws for the whole batch); None: the rank's batch is the whole."""
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = generator
            m.data_shard = None if data_shard is None else tuple(data_shard)


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
        self.out_norm_kind = flags["out_norm"]
        self.force_fp32 = flags["force_fp32"]
        self.disable_z, self.disable_z_act = flags["disable_z"], flags["disable_z_act"]
        self.initialize = initialize
        self.d_conv = d_conv
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

        self.in_proj = Linear(d_model, D if self.disable_z else 2 * D, bias=bias)
        if d_conv > 1:
            self.conv2d = Conv2d(D, D, d_conv, padding=(d_conv - 1) // 2,
                                 groups=D, bias=conv_bias)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, R + 2 * N, D))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, D, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, D))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS * D, N))
        self.Ds = nn.Parameter(torch.empty(K_DIRS * D))
        if self.out_norm_kind == "ln":
            self.out_norm = LayerNorm(D, eps=1e-5)
        elif self.out_norm_kind == "dwconv3":
            self.out_norm = Conv2d(D, D, 3, padding=1, groups=D, bias=False)
        self.out_proj = Linear(D, d_model, bias=bias)
        self.dropout = Dropout(dropout)

    @torch.no_grad()
    def reset_parameters_from(self, generator: torch.Generator) -> None:
        """The raw parameter stacks' laws by ``initialize``: v0 the
        reference's; v1 normal(1) for the dt weights and bias and A_log; any
        other tag v2 (as in the JAX module): U[0, 0.1) for the dt weights and
        bias, A_log zero.  x_proj U(+-1/sqrt(d_inner)) and D = 1 in all."""
        uniform_pm(self.x_proj_weight, 1.0 / math.sqrt(self.d_inner), generator)
        if self.initialize == "v0":
            uniform_pm(self.dt_projs_weight, self.dt_scale * self.rank ** -0.5, generator)
            dt_bias_init(self.dt_projs_bias, generator, *self.dt_range)
            a_log_init(self.A_logs, generator)
        elif self.initialize == "v1":
            for t in (self.dt_projs_weight, self.dt_projs_bias, self.A_logs):
                normal(t, 1.0, generator)
        else:
            for t in (self.dt_projs_weight, self.dt_projs_bias):
                uniform(t, 0.1, generator)
            self.A_logs.zero_()
        self.Ds.fill_(1.0)

    def _project(self, w, t, dtype):
        """``w @ t`` as the JAX module's einsum: the operands rounded to
        ``proj_dtype`` when it is set, the products summed in fp32, the
        result rounded to ``dtype``."""
        if self.proj_dtype is not None:
            w, t = w.to(self.proj_dtype), t.to(self.proj_dtype)
        return torch.matmul(w.float(), t.float()).to(dtype)

    def _scan_operands(self, *ts):
        """u, delta, B, C as the scan takes them: widened to fp32 under
        ``force_fp32`` (after their rounding to the activation dtype, as in
        the JAX module), else as they are."""
        return tuple(t.float() for t in ts) if self.force_fp32 else ts

    def _out_norm(self, y):
        """The tag's out-norm of the NCHW scan output y (B, D, H, W) ->
        NHWC (B, H, W, D): LayerNorm or the depthwise 3x3 conv in fp32, the
        softmax over the H W positions of each channel (in fp32), the
        sigmoid, or none."""
        kind = self.out_norm_kind
        if kind == "dwconv3":
            return self.out_norm(y.float()).permute(0, 2, 3, 1)
        if kind == "softmax":  # along the contiguous H W axis of NCHW
            Bsz, D, H, W = y.shape
            y = torch.softmax(y.float().reshape(Bsz, D, H * W), dim=-1).reshape(y.shape)
            return y.permute(0, 2, 3, 1)
        y = y.permute(0, 2, 3, 1)
        if kind == "ln":
            return self.out_norm(y.float())
        if kind == "sigmoid":
            return torch.sigmoid(y)
        return y

    def _core(self, x):
        """4-direction scan of NCHW (B, D, H, W) -> out-normed NHWC (B, H, W, D)
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

            u = xr.float() if self.force_fp32 else xr

            def dscan(dts, Bm, Cm, k, reverse, y_accum=None):
                rows = slice(k * D, (k + 1) * D)
                delta, Bm, Cm = self._scan_operands(
                    self._project(self.dt_projs_weight[k], dts, x.dtype), Bm, Cm)
                return selective_scan(
                    u, delta, A[rows], Bm[:, None].contiguous(), Cm[:, None].contiguous(),
                    D=Ds[rows], delta_bias=bias[rows], delta_softplus=True,
                    out_dtype=self.out_dtype, backend=self.scan_backend,
                    reverse=reverse, y_accum=y_accum,
                )

            ys = dscan(dts_r, Bs_r, Cs_r, i + 2, True,
                       y_accum=dscan(dts_f, Bs_f, Cs_f, i, False))
            yr = ys.reshape(Bsz, D, W, H).transpose(2, 3) if col else ys.reshape(Bsz, D, H, W)
            y = yr if y is None else y + yr
        return self._out_norm(y).to(x.dtype)

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
            u, delta, Bs, Cs = self._scan_operands(u2, delta.reshape(Bsz, 2 * D, L), Bs, Cs)
            sharded = (selective_scan_seq_sharded if self.tp_axis is None
                       else selective_scan_tp)
            return sharded(
                u, delta, A[rows], Bs.contiguous(), Cs.contiguous(),
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
        return self._out_norm(y).to(x.dtype)

    def forward(self, x):
        """x: (B, H, W, d_model) -> (B, H, W, d_model).  ``noz``: no gate;
        ``nozact``: the raw z gates; ``d_conv <= 1``: no depthwise conv
        before the activation."""
        h, z = self.in_proj(x), None
        if not self.disable_z:
            h, z = h.chunk(2, dim=-1)
            if not self.disable_z_act:
                z = self.act(z)
        h = h.permute(0, 3, 1, 2)
        if self.d_conv > 1:
            h = self.conv2d(h)
        y = self._core(self.act(h))
        if z is not None:
            y = y * z
        return self.dropout(self.out_proj(y))
