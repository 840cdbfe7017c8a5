"""The MIMO-UNet dehazer with VSSG stages, as a plain fp32 function of a
state dict.

It follows the published model (the reference's trained variants under
``ITS/results_*/code/``): a 3-scale encoder/decoder whose six stages are
each one VSSG with its outer residual.  A VSSG embeds patches (a conv of
kernel and stride ``ps``, then LayerNorm), runs two VSSBlocks (pre-norm SS2D
and MLP residuals; DropPath, a training layer, is left out) and un-embeds
(a 1x1 conv to C ps^2 channels and a pixel shuffle).  ``gl_merge`` adds a
local branch at patch ``ps_local`` whose un-embed is added.  SS2D scans the
row raster and the column raster of its map forwards and backwards (four
directions), and normalises their sum with LayerNorm before the gate.

Parameters are looked up by the names of the published checkpoints (the
port's state dict has the same), so the weights are handed over by state
dict and nothing else.  Everything runs in fp32: the caller turns TF32 off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.scan import selective_scan


def _conv(p, name, x, stride=1, act=False):
    """``<name>.main.0``: a conv with padding k // 2, then the exact GELU."""
    w, b = p[f"{name}.main.0.weight"], p[f"{name}.main.0.bias"]
    y = F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)
    return F.gelu(y) if act else y


def _deconv(p, name, x):
    """``<name>.main.0``: the 4x4 stride-2 transposed conv, then GELU."""
    w, b = p[f"{name}.main.0.weight"], p[f"{name}.main.0.bias"]
    return F.gelu(F.conv_transpose2d(x, w, b, stride=2, padding=w.shape[-1] // 2 - 1))


def _ln(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def _ss2d_core(p, n, x, d_state):
    """Four-direction scan of (B, D, H, W) -> LayerNormed (B, H, W, D)."""
    Bsz, D, H, W = x.shape
    wx, wdt = p[f"{n}.x_proj_weight"], p[f"{n}.dt_projs_weight"]
    R, N, L = wdt.shape[-1], d_state, H * W
    A = -torch.exp(p[f"{n}.A_logs"])
    Ds, bias = p[f"{n}.Ds"], p[f"{n}.dt_projs_bias"].reshape(-1)
    y = 0
    for i, col in enumerate((False, True)):
        xr = (x.transpose(2, 3) if col else x).reshape(Bsz, D, L)
        ys = 0
        for k, reverse in ((i, False), (i + 2, True)):
            dts, Bm, Cm = torch.split(torch.einsum("cd,bdl->bcl", wx[k], xr), [R, N, N], dim=1)
            delta = torch.einsum("dr,brl->bdl", wdt[k], dts)
            rows = slice(k * D, (k + 1) * D)
            ys = ys + selective_scan(xr, delta, A[rows], Bm, Cm, Ds[rows], bias[rows], reverse)
        y = y + (ys.reshape(Bsz, D, W, H).transpose(2, 3) if col else ys.reshape(Bsz, D, H, W))
    return _ln(p, f"{n}.out_norm", y.permute(0, 2, 3, 1))


def _ss2d(p, n, x, d_state):
    """(B, H, W, C) -> (B, H, W, C)."""
    h, z = F.linear(x, p[f"{n}.in_proj.weight"]).chunk(2, dim=-1)
    h = h.permute(0, 3, 1, 2)
    h = F.conv2d(h, p[f"{n}.conv2d.weight"], p[f"{n}.conv2d.bias"], padding=1,
                 groups=h.shape[1])
    y = _ss2d_core(p, n, F.silu(h), d_state) * F.silu(z)
    return F.linear(y, p[f"{n}.out_proj.weight"])


def _block(p, n, x, cfg):
    x = x + _ss2d(p, f"{n}.op", _ln(p, f"{n}.norm", x), cfg["ssm_d_state"])
    h = _ln(p, f"{n}.norm2", x)
    h = F.linear(F.gelu(F.linear(h, p[f"{n}.mlp.fc1.weight"], p[f"{n}.mlp.fc1.bias"])),
                 p[f"{n}.mlp.fc2.weight"], p[f"{n}.mlp.fc2.bias"])
    return x + h


def _vssg(p, n, x, cfg):
    """One VSSG on (B, C, H, W), its outer residual not included."""
    branches = ["global", "local"] if cfg["gl_merge"] else ["global"]
    feats = {}
    for br in branches:
        w, b = p[f"{n}.patch_embed_{br}.0.weight"], p[f"{n}.patch_embed_{br}.0.bias"]
        f = F.conv2d(x, w, b, stride=w.shape[-1]).permute(0, 2, 3, 1)
        feats[br] = _ln(p, f"{n}.patch_embed_{br}.2", f)
    for br in branches:  # the global blocks, then the local ones
        for j in range(cfg["depth"]):
            feats[br] = _block(p, f"{n}.layers.0.seq_{br}.blocks.{j}", feats[br], cfg)
    out = 0
    for br in branches:
        w, b = p[f"{n}.patch_unembed_{br}.1.weight"], p[f"{n}.patch_unembed_{br}.1.bias"]
        ps = int(math.isqrt(w.shape[0] // x.shape[1]))
        out = out + F.pixel_shuffle(F.conv2d(feats[br].permute(0, 3, 1, 2), w, b), ps)
    return out


def _stage(p, n, x, cfg):
    return _vssg(p, f"{n}.layers.0", x, cfg) + x


def _scm(p, n, x):
    x = _conv(p, f"{n}.main.0", x, act=True)
    x = _conv(p, f"{n}.main.1", x, act=True)
    x = _conv(p, f"{n}.main.2", x, act=True)
    x = _conv(p, f"{n}.main.3", x)
    return F.instance_norm(x, weight=p[f"{n}.main.4.weight"], bias=p[f"{n}.main.4.bias"],
                           eps=1e-5)


def forward(p, x, cfg):
    """Dehaze x (B, H, W, 3) in [0, 1], H and W multiples of 32, in eval
    mode (no DropPath); returns the three outputs (B, H/4, W/4, 3),
    (B, H/2, W/2, 3), (B, H, W, 3).  ``p``: the state dict (fp32 tensors by
    name).  ``cfg``: ``ssm_d_state``, ``depth``, ``gl_merge``."""
    x = x.permute(0, 3, 1, 2)
    x_2 = x[:, :, ::2, ::2]
    x_4 = x_2[:, :, ::2, ::2]
    z2, z4 = _scm(p, "SCM2", x_2), _scm(p, "SCM1", x_4)

    res1 = _stage(p, "Encoder.0", _conv(p, "feat_extract.0", x, act=True), cfg)
    z = _conv(p, "FAM2.merge",
              torch.cat([_conv(p, "feat_extract.1", res1, stride=2, act=True), z2], dim=1))
    res2 = _stage(p, "Encoder.1", z, cfg)
    z = _conv(p, "FAM1.merge",
              torch.cat([_conv(p, "feat_extract.2", res2, stride=2, act=True), z4], dim=1))
    z = _stage(p, "Encoder.2", z, cfg)

    z = _stage(p, "Decoder.0", z, cfg)
    out_4 = _conv(p, "ConvsOut.0", z) + x_4
    z = _conv(p, "Convs.0", torch.cat([_deconv(p, "feat_extract.3", z), res2], dim=1), act=True)
    z = _stage(p, "Decoder.1", z, cfg)
    out_2 = _conv(p, "ConvsOut.1", z) + x_2
    z = _conv(p, "Convs.1", torch.cat([_deconv(p, "feat_extract.4", z), res1], dim=1), act=True)
    z = _stage(p, "Decoder.2", z, cfg)
    out_1 = _conv(p, "feat_extract.5", z) + x
    return [o.permute(0, 2, 3, 1) for o in (out_4, out_2, out_1)]
