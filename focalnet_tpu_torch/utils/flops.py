"""FLOPs accounting (counterpart of ``focalnet_tpu/utils/flops.py``).

The reference's complexity report: the selective-scan cost model 9·B·L·D·N
(+ B·L·D for the D skip) plus a counted term for everything else.  The JAX
package counts that term with XLA's cost analysis; the port counts it with
``torch.utils.flop_counter.FlopCounterMode`` (see :func:`model_flops`).
"""

from __future__ import annotations

import torch


def scan_flops(B: int, L: int, D: int, N: int, with_D: bool = True,
               with_Z: bool = False) -> int:
    """The reference's ``flops_selective_scan_fn`` cost model: 9·B·L·D·N
    core + optional skips."""
    flops = 9 * B * L * D * N
    if with_D:
        flops += B * D * L
    if with_Z:
        flops += B * D * L
    return flops


def mimounet_scan_flops(cfg, hw=(256, 256), batch: int = 1) -> int:
    """Total selective-scan FLOPs for one MIMOUNet forward at ``hw``.

    Per VSSG branch: depth blocks x scan over L=(H_s/ps)^2 with
    D = K_dirs * d_inner channels; 6 stages (3 encoder + 3 decoder), each
    ``num_res`` VSSGs; the gl_merge variant adds the local branch.
    """
    H, W = hw
    d_inner = int(cfg.ssm_ratio * cfg.vssg_dim)
    D = 4 * d_inner  # K=4 directions folded into channels
    N = cfg.ssm_d_state
    depth = sum(cfg.depths)
    total = 0
    for scale in (1, 2, 4):  # full/half/quarter stages, encoder + decoder
        hs, ws = H // scale, W // scale
        branches = [cfg.patch_size_global]
        if cfg.gl_merge:
            branches.append(cfg.patch_size_local)
        for ps in branches:
            L = (hs // ps) * (ws // ps)
            total += 2 * cfg.num_res * depth * scan_flops(batch, L, D, N)
    return total


def mambair_scan_flops(cfg, hw=(256, 256), batch: int = 1) -> int:
    """Total selective-scan FLOPs for one MambaIR forward at ``hw``: every
    block scans L = H*W over D = K_dirs * d_inner channels."""
    H, W = hw
    D = 4 * int(cfg.ssm_ratio * cfg.embed_dim)
    return sum(cfg.depths) * scan_flops(batch, H * W, D, cfg.ssm_d_state)


def model_flops(fn, *args) -> float:
    """FLOPs of one call ``fn(*args)`` by ``FlopCounterMode``.

    That counter counts matrix products and convolutions only (mm, bmm,
    addmm, convolution, attention); XLA's cost analysis, which the JAX
    package uses, also counts fused elementwise work.  The two figures
    differ by design and are not comparable.  The selective scan counts 0
    here (a custom kernel, or elementwise ops on the plain backends): add
    :func:`scan_flops` per scan call site for a complete figure.  Arguments
    on the ``meta`` device give the count without computing anything.
    """
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
