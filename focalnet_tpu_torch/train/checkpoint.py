"""Checkpoints with the reference's rolling, periodic, best and final files
(counterpart of ``focalnet_tpu/train/checkpoint.py``), as reference-format
``.pkl`` under ``save_dir``:

- ``model.pkl``   - rolling {model, optimizer, epoch}, overwritten every epoch
                    and read by ``--resume``
- ``model_N.pkl`` - the model every ``save_freq`` epochs
- ``Best.pkl``    - the model, written when validation PSNR improves
- ``Final.pkl``   - the model at the end

Each file is written synchronously and whole (:func:`..utils.convert.save_checkpoint`).
"""

from __future__ import annotations

import os

from focalnet_tpu_torch.utils.convert import load_checkpoint, save_checkpoint


class CheckpointManager:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.save_dir, f"{name}.pkl")

    def save_rolling(self, model, optimizer, epoch: int) -> None:
        save_checkpoint(self.path("model"), model.state_dict(), epoch,
                        optimizer=optimizer.state_dict())

    def save_snapshot(self, model, epoch: int) -> None:
        save_checkpoint(self.path(f"model_{epoch}"), model.state_dict(), epoch)

    def save_best(self, model, epoch: int) -> None:
        save_checkpoint(self.path("Best"), model.state_dict(), epoch)

    def save_final(self, model, epoch: int) -> None:
        save_checkpoint(self.path("Final"), model.state_dict(), epoch)


def restore(path: str, model, optimizer) -> int:
    """Load a rolling checkpoint into ``model`` and ``optimizer`` (strict
    keys); returns its epoch."""
    obj = load_checkpoint(path, full=True)
    model.load_state_dict(obj["model"], strict=True)
    optimizer.load_state_dict(obj["optimizer"])
    return int(obj["epoch"])
