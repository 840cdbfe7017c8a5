"""Image helpers and PSNR (counterpart of ``focalnet_tpu/evaluation/metrics.py``).

SSIM and its pooling protocol arrive with the eval slice (ROADMAP).
"""

from __future__ import annotations

import numpy as np

from focalnet_tpu_torch.data.png import write_png
from focalnet_tpu_torch.data.reside import pil_image


def pad_to_multiple(x: np.ndarray, factor: int = 32):
    """Reflect-pad (B, H, W, C) on the bottom/right to multiples of ``factor``,
    only where not already a multiple.  Returns (padded, (h, w))."""
    h, w = x.shape[1], x.shape[2]
    H = (h + factor) // factor * factor
    W = (w + factor) // factor * factor
    padh = H - h if h % factor != 0 else 0
    padw = W - w if w % factor != 0 else 0
    if padh or padw:
        x = np.pad(x, ((0, 0), (0, padh), (0, padw), (0, 0)), mode="reflect")
    return x, (h, w)


def psnr_mse(pred: np.ndarray, label: np.ndarray) -> float:
    """10 log10(1 / MSE), data range 1, the MSE in float64."""
    mse = float(np.mean((pred.astype(np.float64) - label.astype(np.float64)) ** 2))
    return float(10.0 * np.log10(1.0 / mse)) if mse > 0 else float("inf")


def psnr_skimage(pred: np.ndarray, label: np.ndarray) -> float:
    """skimage's peak_signal_noise_ratio(data_range=1): the same formula, a
    separate entry point because the reference logs both."""
    return psnr_mse(pred, label)


def save_image(pred: np.ndarray, path: str) -> None:
    """Save float (H, W, 3) in [0, 1] with the reference's +0.5/255 offset and
    a truncating uint8 cast.  PNG through the port's codec; other formats
    need PIL."""
    x = np.clip(pred + 0.5 / 255.0, 0.0, 1.0)
    u8 = (x * 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        write_png(path, u8)
        return
    pil_image(path).fromarray(u8).save(path)
