"""Image helpers, PSNR and SSIM (counterpart of ``focalnet_tpu/evaluation/metrics.py``).

numpy, float64 inside, as the JAX package's.  SSIM is the pytorch_msssim
algorithm (gaussian window 11, sigma 1.5, K = (0.01, 0.03), valid-mode
filtering, per-image mean) on images adaptive-average-pooled to
(H/down, W/down), down = max(1, round(min(H, W)/256)), as the reference's
``eval.py`` scores them.
"""

from __future__ import annotations

import numpy as np

from focalnet_tpu_torch.data.native_loader import encode_png
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


def adaptive_avg_pool(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PyTorch's adaptive_avg_pool2d on (B, H, W, C): bin i covers
    [floor(i n/m), ceil((i+1) n/m)); an output larger than the input
    upsamples."""

    def pool_axis(a, axis, m):
        n = a.shape[axis]
        csum = np.cumsum(a, axis=axis, dtype=np.float64)
        csum = np.concatenate(
            [np.zeros_like(np.take(csum, [0], axis=axis)), csum], axis=axis)
        starts = (np.arange(m) * n) // m
        ends = np.ceil((np.arange(m) + 1) * n / m).astype(np.int64)
        hi = np.take(csum, ends, axis=axis)
        lo = np.take(csum, starts, axis=axis)
        width = (ends - starts).astype(np.float64)
        shape = [1] * a.ndim
        shape[axis] = m
        return ((hi - lo) / width.reshape(shape)).astype(a.dtype)

    x = pool_axis(x.astype(np.float64), 1, out_h)
    x = pool_axis(x, 2, out_w)
    return x.astype(np.float32)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d_valid(x: np.ndarray, win: np.ndarray) -> np.ndarray:
    """Separable valid-mode filter by ``win`` over H, W of (B, H, W, C)."""
    from numpy.lib.stride_tricks import sliding_window_view

    v = sliding_window_view(x, win.size, axis=1)
    x = np.tensordot(v, win, axes=([-1], [0]))
    v = sliding_window_view(x, win.size, axis=2)
    return np.tensordot(v, win, axes=([-1], [0]))


def ssim(pred: np.ndarray, label: np.ndarray, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5,
         K=(0.01, 0.03)) -> np.ndarray:
    """pytorch_msssim's SSIM on (B, H, W, C): one value per image (its
    ``size_average=False``)."""
    win = _gaussian_window(win_size, win_sigma)
    X = pred.astype(np.float64)
    Y = label.astype(np.float64)
    C1 = (K[0] * data_range) ** 2
    C2 = (K[1] * data_range) ** 2

    mu_x = _filter2d_valid(X, win)
    mu_y = _filter2d_valid(Y, win)
    sxx = _filter2d_valid(X * X, win) - mu_x**2
    syy = _filter2d_valid(Y * Y, win) - mu_y**2
    sxy = _filter2d_valid(X * Y, win) - mu_x * mu_y

    cs = (2 * sxy + C2) / (sxx + syy + C2)
    ssim_map = ((2 * mu_x * mu_y + C1) / (mu_x**2 + mu_y**2 + C1)) * cs
    return ssim_map.mean(axis=(1, 2, 3)).astype(np.float32)


def eval_ssim(pred: np.ndarray, label: np.ndarray, padded_hw) -> np.ndarray:
    """The reference's pooled SSIM: both images adaptive-average-pooled to
    (H/down, W/down), then :func:`ssim`.

    ``padded_hw`` are the reference's formula values ``((h+32)//32*32,
    (w+32)//32*32)``: where h or w is already a multiple of 32 they exceed
    the image, the pooled grid is larger than it and the pool upsamples.
    Scores match the reference's only with that quirk kept."""
    H, W = padded_hw
    down = max(1, round(min(H, W) / 256))
    out_h, out_w = int(H / down), int(W / down)
    return ssim(adaptive_avg_pool(pred, out_h, out_w),
                adaptive_avg_pool(label, out_h, out_w))


def save_image(pred: np.ndarray, path: str) -> None:
    """Save float (H, W, 3) in [0, 1] with the reference's +0.5/255 offset and
    a truncating uint8 cast.  PNG through the native encoder (level 1, the
    Sub filter); other formats need PIL."""
    x = np.clip(pred + 0.5 / 255.0, 0.0, 1.0)
    u8 = (x * 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        encode_png(path, u8)
        return
    pil_image(path).fromarray(u8).save(path)
