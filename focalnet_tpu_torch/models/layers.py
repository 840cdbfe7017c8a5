"""Conv building blocks (counterpart of ``focalnet_tpu/models/layers.py``).

NCHW, PyTorch's native conv layout; module names follow the reference
(``BasicConv.main.0`` is the conv and ``main.1`` its BatchNorm when
``norm=True``, ``SCM.main.4`` the InstanceNorm, ``FAM.merge``,
``ResBlock.main.{0,1}``, ``GhostModule.primary_conv.0`` and
``cheap_operation.0``).  No preset uses ``norm=True``, ``GhostModule`` or
:func:`pixel_shuffle`; they are here because the JAX package has them.

Precision follows the JAX package's ``dtype=``: parameters stay fp32 and
are cast at each use, and a bf16 model rounds where the JAX program rounds.
:class:`Conv2d`, :class:`ConvTranspose2d` and :class:`Linear` compute in
their input's dtype (the model casts its input once to ``compute_dtype``, so
every one of them runs in it): in bf16 the product is summed in fp32 and
rounded, then the bias is added and the sum rounded, as flax's layers do;
:class:`LayerNorm` and :class:`InstanceNorm2d` compute in fp32 and return
their input's dtype; in bf16 :func:`gelu_exact` and :func:`silu` are the
JAX functions' chains of primitives, each rounded.  In fp32 every one of
them is the single PyTorch operator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _add_bias(y, bias, dim):
    """y + bias along channel axis ``dim``, bias cast to y's dtype."""
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + bias.to(y.dtype).reshape(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype, the fp32 parameters cast at use."""

    def forward(self, x):
        if x.dtype == torch.float32 or self.bias is None:
            return self._conv_forward(x, self.weight.to(x.dtype), self.bias)
        return _add_bias(self._conv_forward(x, self.weight.to(x.dtype), None), self.bias, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype, the fp32 parameters cast at use."""

    def forward(self, x):
        fused = x.dtype == torch.float32 or self.bias is None
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias if fused else None,
                               self.stride, self.padding, self.output_padding, self.groups,
                               self.dilation)
        return y if fused else _add_bias(y, self.bias, 1)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype, the fp32 parameters cast at use."""

    def forward(self, x):
        if x.dtype == torch.float32 or self.bias is None:
            return F.linear(x, self.weight.to(x.dtype), self.bias)
        return _add_bias(F.linear(x, self.weight.to(x.dtype)), self.bias, -1)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in fp32 (flax's ``LayerNorm(dtype=float32)``),
    returned in its input's dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class InstanceNorm2d(nn.InstanceNorm2d):
    """Affine ``nn.InstanceNorm2d`` computed in fp32, returned in its input's dtype."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


def gelu_exact(x):
    """The exact (erf) GELU.  Below fp32, ``jax.nn.gelu(approximate=False)``'s
    primitives, each rounded to x's dtype: 0.5 x times erfc(-x c), with c
    the dtype's rounding of sqrt(1/2)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    c = torch.tensor(math.sqrt(0.5), dtype=x.dtype).item()
    return (0.5 * x) * torch.special.erfc(-x * c)


def silu(x):
    """x sigmoid(x).  Below fp32, ``jax.nn.silu``'s primitives, each rounded
    to x's dtype: x times 1 / (1 + exp(-x))."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


class GELU(nn.Module):
    """:func:`gelu_exact` as a module (``nn.GELU``'s slot in ``BasicConv.main``)."""

    def forward(self, x):
        return gelu_exact(x)


class BatchNorm2d(nn.BatchNorm2d):
    """flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)`` on NCHW, in fp32,
    returned in its input's dtype.  In training mode it normalises by the
    batch's mean and biased variance and moves the running statistics 0.1 of
    the way to them, the variance too being the biased one (flax's update;
    ``nn.BatchNorm2d`` moves it to the unbiased variance); in eval mode it
    normalises by the running statistics.  ``nn.BatchNorm2d``'s defaults, eps
    1e-5 and momentum 0.1, are flax's epsilon and momentum 0.9."""

    def forward(self, x):
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps).to(x.dtype)
        mean = xf.mean((0, 2, 3))
        var = xf.var((0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class BasicConv(nn.Module):
    """Conv2d, or the transposed k4 s2 p1 ConvTranspose2d, then with
    ``norm=True`` a :class:`BatchNorm2d` (and no conv bias), then optional
    GELU.  Padding k//2 as in the reference."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 bias=True, norm=False, act=True, transpose=False):
        super().__init__()
        bias = bias and not norm
        if transpose:
            conv = ConvTranspose2d(in_channels, out_channels, kernel_size,
                                   stride=stride, padding=kernel_size // 2 - 1, bias=bias)
        else:
            conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                             padding=kernel_size // 2, bias=bias)
        layers = [conv] + ([BatchNorm2d(out_channels)] if norm else [])
        self.main = nn.Sequential(*layers, *([GELU()] if act else []))

    def forward(self, x):
        return self.main(x)


class ResBlock(nn.Module):
    """conv3-GELU, conv3, plus the input: the ``baseline`` preset's stage block."""

    def __init__(self, channels):
        super().__init__()
        self.main = nn.Sequential(BasicConv(channels, channels, 3, act=True),
                                  BasicConv(channels, channels, 3, act=False))

    def forward(self, x):
        return self.main(x) + x


class GhostModule(nn.Module):
    """Ghost conv: a primary k x k conv to ``init_ch = ceil(oup / ratio)``
    channels, a cheap depthwise ``dw_size`` conv from each of them to
    ``ratio - 1`` more (``groups=init_ch``), both concatenated and cut to
    ``oup``.  No bias, BatchNorm or activation, as in the JAX module."""

    def __init__(self, inp, oup, kernel_size=1, ratio=2, dw_size=3, stride=1):
        super().__init__()
        self.oup = oup
        init_ch = math.ceil(oup / ratio)
        k = kernel_size
        self.primary_conv = nn.Sequential(
            Conv2d(inp, init_ch, k, stride=stride, padding=k // 2, bias=False))
        self.cheap_operation = nn.Sequential(
            Conv2d(init_ch, init_ch * (ratio - 1), dw_size, padding=dw_size // 2,
                   groups=init_ch, bias=False))

    def forward(self, x):
        x1 = self.primary_conv(x)
        return torch.cat([x1, self.cheap_operation(x1)], dim=1)[:, :self.oup]


def pixel_shuffle(x, r: int):
    """NCHW pixel shuffle, (B, C r r, H, W) -> (B, C, H r, W r), with
    PyTorch's channel order: out[c, h r + i, w r + j] = in[c r r + i r + j, h, w]
    (the JAX function's, on NHWC)."""
    return F.pixel_shuffle(x, r)


class SCM(nn.Module):
    """Shallow conv stem 3 -> C for the downscaled inputs, ending in affine
    InstanceNorm (two-pass variance, eps 1e-5)."""

    def __init__(self, out_channels):
        super().__init__()
        c = out_channels
        self.main = nn.Sequential(
            BasicConv(3, c // 4, 3, act=True),
            BasicConv(c // 4, c // 2, 1, act=True),
            BasicConv(c // 2, c // 2, 3, act=True),
            BasicConv(c // 2, c, 1, act=False),
            InstanceNorm2d(c, eps=1e-5, affine=True),
        )

    def forward(self, x):
        return self.main(x)


class FAM(nn.Module):
    """Feature fusion: concat + 3x3 merge conv."""

    def __init__(self, channels):
        super().__init__()
        self.merge = BasicConv(2 * channels, channels, 3, act=False)

    def forward(self, x1, x2):
        return self.merge(torch.cat([x1, x2], dim=1))


class Permute(nn.Module):
    """Parameter-free axis permutation (the reference's ``Permute``)."""

    def __init__(self, *dims):
        super().__init__()
        self.dims = dims

    def forward(self, x):
        return x.permute(*self.dims)


def nearest_down2(x):
    """F.interpolate(scale_factor=0.5) default (nearest) on NCHW: out[i] = in[2i]."""
    return x[:, :, ::2, ::2]
