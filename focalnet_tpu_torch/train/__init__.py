"""Training: the loss, the schedule, the optimizer step, checkpoints, the loop."""

from focalnet_tpu_torch.train.checkpoint import CheckpointManager, restore
from focalnet_tpu_torch.train.losses import multiscale_loss
from focalnet_tpu_torch.train.schedule import make_schedule, warmup_cosine_epoch_lr
from focalnet_tpu_torch.train.trainer import (
    make_optimizer,
    make_train_step,
    optimizer_step,
    set_lr,
    train,
)

__all__ = [
    "CheckpointManager", "make_optimizer", "make_schedule", "make_train_step",
    "multiscale_loss", "optimizer_step", "restore", "set_lr", "train",
    "warmup_cosine_epoch_lr",
]
