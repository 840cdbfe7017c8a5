"""MambaIR's colour denoiser as a plain fp32 function of a state dict.

Written from the published equations (Guo et al., "MambaIR: A Simple
Baseline for Image Restoration with State-Space Model", ECCV 2024,
``basicsr/archs/mambair_arch.py`` with ``upscale`` 1 and no upsampler):

    x' = (x - mean) img_range;  f0 = conv_first(x')
    t = patch_embed.norm(f0);  t = layers[i](t) for each residual group
    out = x' + conv_last(conv_after_body(norm(t)) + f0);  out / img_range + mean

a residual group is ``t + conv(blocks(t))`` and a block

    x = skip_scale  x + SS2D(ln_1(x))
    x = skip_scale2 x + CAB(ln_2(x))

with SS2D VMamba v0's operator (``reference/model.py``'s: in_proj, x and z,
depthwise 3x3 and SiLU, four directions of the blocked scan of
``reference/scan.py``, their sum LayerNormed, gated by SiLU(z), out_proj)
and CAB ``conv 3x3, GELU, conv 3x3`` then the channel attention ``x
sigmoid(conv1x1(relu(conv1x1(avgpool(x)))))``.  Every size comes from the
state dict's shapes; ``cfg`` gives ``img_range`` and ``rgb_mean``.

Departures from the published code, in the configuration's ``assumed`` too:
whole images, with none of the published test script's tiling; one
orientation of each image (no self-ensemble); weights random, not trained.
DropPath is an identity in eval and is left out.  Everything runs in fp32:
the caller turns TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.model import _ln, _ss2d


def _conv(p, name, x):
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, p[f"{name}.bias"], padding=w.shape[-1] // 2)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _cab(p, n, x):
    """(B, C, H, W) -> (B, C, H, W)."""
    h = _conv(p, f"{n}.cab.2", F.gelu(_conv(p, f"{n}.cab.0", x)))
    a = h.mean(dim=(2, 3), keepdim=True)
    a = torch.sigmoid(_conv(p, f"{n}.cab.3.attention.3",
                            F.relu(_conv(p, f"{n}.cab.3.attention.1", a))))
    return h * a


def _block(p, n, x):
    """(B, H, W, C) -> (B, H, W, C)."""
    d_state = p[f"{n}.self_attention.A_logs"].shape[-1]
    x = x * p[f"{n}.skip_scale"] + _ss2d(p, f"{n}.self_attention", _ln(p, f"{n}.ln_1", x),
                                         d_state)
    return x * p[f"{n}.skip_scale2"] + _nhwc(_cab(p, f"{n}.conv_blk",
                                                  _nchw(_ln(p, f"{n}.ln_2", x))))


def _count(p, prefix):
    """How many ``<prefix><i>.`` indices the state dict has."""
    return len({k[len(prefix):].split(".")[0] for k in p if k.startswith(prefix)})


def forward(p, x, cfg):
    """Denoise x (B, H, W, 3) in [0, 1], any H and W; returns (B, H, W, 3).
    ``p``: the state dict (fp32 tensors by name); ``cfg``: ``img_range``
    and ``rgb_mean``."""
    mean = torch.tensor(cfg["rgb_mean"], dtype=x.dtype, device=x.device)
    x = _nchw((x - mean) * cfg["img_range"])
    f0 = _conv(p, "conv_first", x)
    t = _ln(p, "patch_embed.norm", _nhwc(f0))
    for i in range(_count(p, "layers.")):
        g = f"layers.{i}"
        h = t
        for j in range(_count(p, f"{g}.residual_group.blocks.")):
            h = _block(p, f"{g}.residual_group.blocks.{j}", h)
        t = t + _nhwc(_conv(p, f"{g}.conv", _nchw(h)))
    res = _conv(p, "conv_after_body", _nchw(_ln(p, "norm", t))) + f0
    out = x + _conv(p, "conv_last", res)
    return _nhwc(out) / cfg["img_range"] + mean
