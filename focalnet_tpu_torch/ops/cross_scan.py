"""The 4-direction cross scan and merge as layout ops
(``focalnet_tpu/ops/cross_scan.py``).

Pure data movement (reshape, transpose, flip, stack); autograd gives the
gradients, and ``cross_scan`` and ``cross_merge`` are each other's adjoint.
SS2D does not call them: its scans read each raster once and run the
reversed directions in the kernel's ``reverse`` mode.

Directions (row-major H x W grid, L = H W):
    0: row-major raster           (h, w) -> h W + w
    1: column-major raster        (h, w) -> w H + h
    2: reversed row-major         flip of 0
    3: reversed column-major      flip of 1

Grids are channel-last (B, H, W, C) and sequence stacks (B, 4, L, C), as in
the JAX module.
"""

from __future__ import annotations

import torch

K_DIRS = 4


def cross_scan(x):
    """(B, H, W, C) -> (B, 4, L, C), the 4 raster directions."""
    B, H, W, C = x.shape
    d0 = x.reshape(B, H * W, C)
    d1 = x.transpose(1, 2).reshape(B, W * H, C)
    return torch.stack([d0, d1, d0.flip(1), d1.flip(1)], dim=1)


def cross_merge(ys, H, W):
    """(B, 4, L, C) -> (B, H, W, C): the 4 directions mapped back to the
    grid and summed."""
    B, K, L, C = ys.shape
    if K != K_DIRS or L != H * W:
        raise ValueError(f"cross_merge: {tuple(ys.shape)} is not (B, 4, {H * W}, C)")
    fwd = ys[:, 0] + ys[:, 2].flip(1)  # row-major
    rev = ys[:, 1] + ys[:, 3].flip(1)  # column-major
    rev = rev.reshape(B, W, H, C).transpose(1, 2).reshape(B, L, C)
    return (fwd + rev).reshape(B, H, W, C)


def cross_scan_1b1(x):
    """(B, 4, H, W, C) -> (B, 4, L, C): stream k rastered in direction k."""
    B, K, H, W, C = x.shape
    if K != K_DIRS:
        raise ValueError(f"cross_scan_1b1: {tuple(x.shape)} does not hold 4 streams")
    d0 = x[:, 0].reshape(B, H * W, C)
    d1 = x[:, 1].transpose(1, 2).reshape(B, W * H, C)
    d2 = x[:, 2].reshape(B, H * W, C).flip(1)
    d3 = x[:, 3].transpose(1, 2).reshape(B, W * H, C).flip(1)
    return torch.stack([d0, d1, d2, d3], dim=1)


def cross_merge_1b1(ys, H, W):
    """Inverse of :func:`cross_scan_1b1` stream by stream, unsummed:
    (B, 4, L, C) -> (B, 4, H, W, C)."""
    B, K, L, C = ys.shape
    if K != K_DIRS or L != H * W:
        raise ValueError(f"cross_merge_1b1: {tuple(ys.shape)} is not (B, 4, {H * W}, C)")
    d0 = ys[:, 0].reshape(B, H, W, C)
    d1 = ys[:, 1].reshape(B, W, H, C).transpose(1, 2)
    d2 = ys[:, 2].flip(1).reshape(B, H, W, C)
    d3 = ys[:, 3].flip(1).reshape(B, W, H, C).transpose(1, 2)
    return torch.stack([d0, d1, d2, d3], dim=1)
