"""Inputs made from the seed: hazy and clear images.

A clear image J is a smooth random field (bicubic from a 12 x 16 grid) with
fine noise, so that it compresses as photographs do; its hazy versions
follow the atmospheric scattering model I = J t + A (1 - t), with a
transmission map t that varies smoothly over the image and an airlight A
drawn per image (RESIDE's synthesis).  Every seed gives images of the same
size; the same seed gives the same pixels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The numpy generator of ``seed`` (any whole number) and ``stream``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *stream]))


def _smooth(g: np.random.Generator, n: int, hw, grid=(12, 16), channels=3) -> np.ndarray:
    base = torch.from_numpy(g.random((n, channels, *grid), dtype=np.float32))
    return F.interpolate(base, size=tuple(hw), mode="bicubic", align_corners=True).numpy()


def scenes(seed: int, n_clear: int, n_hazy: int, hw=(460, 620)):
    """(clear, hazy): ``n_clear`` clear images and ``n_hazy`` hazy versions
    of each, uint8 (H, W, 3); ``hazy[i][k]`` is the k-th version of
    ``clear[i]``."""
    g = rng(seed, 1)
    J = np.clip(_smooth(g, n_clear, hw) + g.normal(0, 0.03, (n_clear, 3, *hw)), 0, 1)
    J = J.transpose(0, 2, 3, 1).astype(np.float32)
    t = 0.45 + 0.45 * _smooth(g, n_clear * n_hazy, hw, channels=1).transpose(0, 2, 3, 1)
    A = g.uniform(0.7, 1.0, (n_clear * n_hazy, 1, 1, 1)).astype(np.float32)
    I = np.repeat(J, n_hazy, axis=0) * t + A * (1 - t)
    q = lambda x: np.round(np.clip(x, 0, 1) * 255).astype(np.uint8)  # noqa: E731
    return q(J), q(I).reshape(n_clear, n_hazy, *hw, 3)
