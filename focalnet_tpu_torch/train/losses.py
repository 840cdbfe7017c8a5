"""Multiscale L1 + FFT training loss (counterpart of ``focalnet_tpu/train/losses.py``).

loss = sum_{s in {1/4, 1/2, 1}} L1(pred_s, label_s)
     + 0.1 * sum_s L1(stack(Re, Im)(FFT2(pred_s)), stack(Re, Im)(FFT2(label_s)))

The labels at 1/2 and 1/4 come from PyTorch-style bilinear downsampling
(half-pixel centres, no antialiasing), written out as the JAX package's
gather and lerp so both packages compute the same sums.  Tensors are NHWC,
as the model returns them.
"""

from __future__ import annotations

import numpy as np
import torch


def _down_axis(x, axis: int, factor: int):
    """Bilinear (align_corners=False) downsample along ``axis``:
    out[i] = lerp(src[floor(p)], src[floor(p) + 1], frac(p)),
    p = (i + 0.5) * factor - 0.5, clamped to the valid range."""
    n = x.shape[axis]
    pos = (np.arange(n // factor) + 0.5) * factor - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    hi = np.clip(lo + 1, 0, n - 1)
    shape = [1] * x.dim()
    shape[axis] = len(pos)
    w = torch.from_numpy((pos - np.floor(pos)).astype(np.float32)).to(x.device).reshape(shape)
    xlo = x.index_select(axis, torch.from_numpy(lo).to(x.device))
    xhi = x.index_select(axis, torch.from_numpy(hi).to(x.device))
    return xlo * (1.0 - w) + xhi * w


def bilinear_down(x, factor: int):
    """(B, H, W, C) -> (B, H/f, W/f, C), F.interpolate bilinear semantics."""
    return _down_axis(_down_axis(x, 1, factor), 2, factor)


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def fft_l1(a, b):
    """L1 over the stacked real and imaginary parts of the 2-D FFT over H, W."""
    fa = torch.fft.fft2(a, dim=(1, 2))
    fb = torch.fft.fft2(b, dim=(1, 2))
    return 0.5 * (l1(fa.real, fb.real) + l1(fa.imag, fb.imag))


def multiscale_loss(preds, label, fft_weight: float = 0.1):
    """preds = [out_4, out_2, out_1] (NHWC); label (B, H, W, C) in [0, 1].
    Returns (total, content, fft), the reference's "Pixel Loss" and "FFT
    Loss" being content and fft."""
    labels = [bilinear_down(label, 4), bilinear_down(label, 2), label]
    content = sum(l1(p, t) for p, t in zip(preds, labels))
    fft = sum(fft_l1(p, t) for p, t in zip(preds, labels))
    return content + fft_weight * fft, content, fft
