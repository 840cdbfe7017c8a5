"""MambaIR's colour denoiser: a single-scale stack of residual state-space
groups (Guo et al., "MambaIR: A Simple Baseline for Image Restoration with
State-Space Model", ECCV 2024; ``basicsr/archs/mambair_arch.py``, ``upscale``
1, no upsampler).

    x' = (x - mean) * img_range
    f0 = conv_first(x')                               3x3, 3 -> C
    t  = patch_embed.norm(f0)                         LayerNorm over C
    t  = layers[i](t)                                 residual groups
    out = x' + conv_last(conv_after_body(norm(t)) + f0)
    return out / img_range + mean

A residual group is ``t + conv(blocks(t))`` (a 3x3 C -> C conv); a block
(MambaIR's ``VSSBlock``, :class:`RSSB` here) is

    x = skip_scale  * x + SS2D(ln_1(x))
    x = skip_scale2 * x + CAB(ln_2(x))

with SS2D the port's module (VMamba v0's operator at ``expand`` = MambaIR's
``mlp_ratio``) and CAB two 3x3 convs (C -> C / compress_ratio, GELU, back to
C) and a channel attention gate (global average pool, 1x1 C -> C /
squeeze_factor, ReLU, 1x1 back, sigmoid).  DropPath, an identity in eval,
is left out: the port serves and evaluates MambaIR, it does not train it.
Parameter names are MambaIR's own, so that a released checkpoint loads by
name.  NHWC in and out, as :class:`..mimounet.MIMOUNet`; convolutions run
NCHW.  fp32.

The forward marks the block's two branches and each group's conv with
``torch.profiler.record_function`` ranges ``mambair.ss2d``, ``mambair.cab``
and ``mambair.group_conv``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from focalnet_tpu_torch.configs import SCAN_BACKENDS, MambaIRConfig
from focalnet_tpu_torch.models.layers import GELU, Conv2d, LayerNorm
from focalnet_tpu_torch.models.ss2d import SS2D
from focalnet_tpu_torch.utils.flops import mambair_scan_flops


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


class ChannelAttention(nn.Module):
    """``x * sigmoid(conv(relu(conv(avgpool(x)))))`` on NCHW."""

    def __init__(self, num_feat: int, squeeze_factor: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            Conv2d(num_feat, num_feat // squeeze_factor, 1),
            nn.ReLU(),
            Conv2d(num_feat // squeeze_factor, num_feat, 1),
            nn.Sigmoid(),
        )

    def forward(self, x):
        return x * self.attention(x)


class CAB(nn.Module):
    """The convolutional channel-attention branch on NCHW."""

    def __init__(self, num_feat: int, compress_ratio: int, squeeze_factor: int):
        super().__init__()
        self.cab = nn.Sequential(
            Conv2d(num_feat, num_feat // compress_ratio, 3, padding=1),
            GELU(),
            Conv2d(num_feat // compress_ratio, num_feat, 3, padding=1),
            ChannelAttention(num_feat, squeeze_factor),
        )

    def forward(self, x):
        return self.cab(x)


class RSSB(nn.Module):
    """MambaIR's ``VSSBlock`` on NHWC: the SS2D and CAB residuals, each
    around a LayerNorm and with a learned per-channel scale on its skip."""

    def __init__(self, dim: int, cfg: MambaIRConfig):
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.self_attention = SS2D(d_model=dim, d_state=cfg.ssm_d_state,
                                   ssm_ratio=cfg.ssm_ratio, scan_backend=cfg.scan_backend)
        self.skip_scale = nn.Parameter(torch.ones(dim))
        self.ln_2 = LayerNorm(dim, eps=1e-5)
        self.conv_blk = CAB(dim, cfg.compress_ratio, cfg.squeeze_factor)
        self.skip_scale2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        with record_function("mambair.ss2d"):
            x = x * self.skip_scale + self.self_attention(self.ln_1(x))
        with record_function("mambair.cab"):
            return x * self.skip_scale2 + _nhwc(self.conv_blk(_nchw(self.ln_2(x))))


class BasicLayer(nn.Module):
    """A residual group's blocks, in order."""

    def __init__(self, dim: int, depth: int, cfg: MambaIRConfig):
        super().__init__()
        self.blocks = nn.ModuleList([RSSB(dim, cfg) for _ in range(depth)])

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class ResidualGroup(nn.Module):
    """``t + conv(blocks(t))`` on NHWC tokens (``resi_connection`` '1conv')."""

    def __init__(self, dim: int, depth: int, cfg: MambaIRConfig):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, cfg)
        self.conv = Conv2d(dim, dim, 3, padding=1)

    def forward(self, t):
        h = self.residual_group(t)
        with record_function("mambair.group_conv"):
            return t + _nhwc(self.conv(_nchw(h)))


class PatchEmbed(nn.Module):
    """MambaIR's ``patch_embed``: the feature map as tokens, LayerNormed."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)


class MambaIR(nn.Module):
    """The denoiser of the module docstring.  ``forward`` takes (B, H, W, 3)
    in [0, 1], any H and W, and returns the restored (B, H, W, 3)."""

    pad_multiple = 1  # no downsampling: any size runs as it is
    trains = False  # the trainer's multi-scale L1 + FFT loss is MIMO-UNet's
    shards_scans = False
    scan_flops = staticmethod(mambair_scan_flops)

    def __init__(self, cfg: MambaIRConfig, seq_mesh=None):
        super().__init__()
        if seq_mesh is not None:
            raise ValueError("MambaIR does not shard its scans: it takes no seq_mesh")
        if cfg.scan_backend not in SCAN_BACKENDS:
            raise ValueError(f"scan_backend {cfg.scan_backend!r} not in {SCAN_BACKENDS}")
        self.cfg = cfg
        self.img_range = cfg.img_range
        c = cfg.embed_dim
        self.register_buffer("mean", torch.tensor(cfg.rgb_mean).reshape(1, 1, 1, 3),
                             persistent=False)
        self.conv_first = Conv2d(3, c, 3, padding=1)
        self.patch_embed = PatchEmbed(c)
        self.layers = nn.ModuleList([ResidualGroup(c, d, cfg) for d in cfg.depths])
        self.norm = LayerNorm(c, eps=1e-5)
        self.conv_after_body = Conv2d(c, c, 3, padding=1)
        self.conv_last = Conv2d(c, 3, 3, padding=1)

    def forward(self, x):
        x = _nchw((x - self.mean) * self.img_range)
        f0 = self.conv_first(x)
        t = self.patch_embed.norm(_nhwc(f0))
        for group in self.layers:
            t = group(t)
        res = self.conv_after_body(_nchw(self.norm(t))) + f0
        out = x + self.conv_last(res)
        return _nhwc(out) / self.img_range + self.mean
