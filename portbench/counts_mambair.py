"""The yardstick's arithmetic for MambaIR, from shapes: the forward's FLOPs
and its scans' least times, by the laws of ``counts.py``.

Every block scans the whole image, L = H W, in four directions: per SS2D two
rasters, each a forward K1 call and a reverse one that adds the forward's
output (``y_accum``), over D = d_inner channels, N = ``ssm_d_state``.

The counted FLOPs are the forward's matrix products and convolutions, two
per multiply-add, as ``FlopCounterMode`` counts them (no bias, norm or
elementwise work): per pixel and block ``in_proj`` (C to 2 D_i), the
depthwise 3x3 (D_i 9), ``x_proj`` in four directions (D_i to R + 2 N),
``dt_proj`` (R to D_i, four times) and ``out_proj`` (D_i to C), the CAB's two
3x3 convs (C to C / compress_ratio and back); per image and block the channel
attention's two 1x1 convs on the pooled vector; per pixel the groups' 3x3
convs, ``conv_first``, ``conv_after_body`` and ``conv_last``.  The scans
add K1's 9 L D N + L D operations a call.
"""

from __future__ import annotations

import math

from portbench import counts


def widths(cfg):
    """(C, D_i, N, R, the CAB's width, the attention's width) of a
    configuration."""
    C = cfg["embed_dim"]
    d_inner = int(cfg["ssm_ratio"] * C)
    return (C, d_inner, cfg["ssm_d_state"], math.ceil(C / 16), C // cfg["compress_ratio"],
            C // cfg["squeeze_factor"])


def scan_calls(cfg, hw, batch):
    """One forward's K1 calls as [(L, B, kwargs)]."""
    _, d_inner, N, *_ = widths(cfg)
    L = hw[0] * hw[1]
    calls = []
    for _ in range(sum(cfg["depths"]) * 2):
        calls.append((L, batch, dict(dim=d_inner, N=N)))
        calls.append((L, batch, dict(dim=d_inner, N=N, accum=True)))
    return calls


def scan_bound_s(cfg, hw, batch):
    """The summed least time of one forward's K1 calls."""
    return sum(counts.bound_s(*counts.k1_call(L, b, **kw))
               for L, b, kw in scan_calls(cfg, hw, batch))


def scan_flops(cfg, hw, batch):
    return sum(counts.k1_call(L, b, **kw)[1] for L, b, kw in scan_calls(cfg, hw, batch))


def counted_flops(cfg, hw, batch):
    """Matrix products and convolutions of one forward."""
    C, Di, N, R, cab, sq = widths(cfg)
    blocks, groups = sum(cfg["depths"]), len(cfg["depths"])
    block_px = (C * 2 * Di + Di * 9 + 4 * Di * (R + 2 * N) + 4 * R * Di + Di * C
                + 2 * C * cab * 9)
    per_px = blocks * block_px + groups * C * C * 9 + 3 * C * 9 + C * C * 9 + C * 3 * 9
    return 2 * batch * (hw[0] * hw[1] * per_px + blocks * 2 * C * sq)


def model_flops(cfg, hw, batch):
    """FLOPs of one forward at ``batch`` x ``hw``: products, convolutions and
    the scans' operations."""
    return counted_flops(cfg, hw, batch) + scan_flops(cfg, hw, batch)
