"""Learning-rate schedule (counterpart of ``focalnet_tpu/train/schedule.py``):
GradualWarmupScheduler(multiplier=1) with a cosine after it, stepped once per
epoch.  The learning rate of (1-based) epoch e:

    e <= 3 (warm-up): base_lr * e / 3
    e >= 4 (cosine):  eta_min + (base_lr - eta_min) / 2 * (1 + cos(pi t / T)),
                      t = e - 4, T = num_epoch - warmup_epochs

The cosine's own epoch restarts at 0 when the warm-up ends (epoch 4 trains at
base_lr) and never reaches T, as in the reference.  Computed in float32, as
the JAX package computes it.
"""

from __future__ import annotations

import numpy as np


def warmup_cosine_epoch_lr(epoch, base_lr: float, num_epoch: int,
                           warmup_epochs: int = 3, eta_min: float = 1e-6):
    """Learning rate of ``epoch`` (an int or an integer array), float32."""
    e = np.asarray(epoch, np.float32)
    f32 = np.float32
    warm = f32(base_lr) * e / f32(warmup_epochs)
    t = e - f32(warmup_epochs + 1)
    T = f32(num_epoch - warmup_epochs)
    with np.errstate(divide="ignore", invalid="ignore"):  # T = 0: warm-up only
        cos = f32(eta_min) + f32(base_lr - eta_min) * f32(0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * t / T))
    return np.where(e <= warmup_epochs, warm, cos).astype(np.float32)


def make_schedule(base_lr: float, num_epoch: int, steps_per_epoch: int,
                  warmup_epochs: int = 3, eta_min: float = 1e-6):
    """Step index -> learning rate, constant within each epoch."""

    def schedule(step):
        return warmup_cosine_epoch_lr(np.asarray(step) // steps_per_epoch + 1, base_lr,
                                      num_epoch, warmup_epochs, eta_min)

    return schedule
