"""Batch-1 validation (counterpart of ``focalnet_tpu/evaluation/evaluator.py::validate``).

What training calls at the epoch boundary: the mean skimage-PSNR over the
test split at full size, each image reflect-padded to a multiple of 32 and
the prediction cropped back and clamped.  Batched validation, ``evaluate``
and ``--mode test`` arrive with the eval slice (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from focalnet_tpu_torch.data.reside import EvalLoader
from focalnet_tpu_torch.evaluation.metrics import pad_to_multiple, psnr_skimage
from focalnet_tpu_torch.utils.meters import Adder


def validate(model, data_dir: str, factor: int = 32) -> float:
    """Mean PSNR of ``model`` (a MIMOUNet, on its device) over
    ``data_dir/test``; the model runs in eval mode and is put back in the mode
    it was in."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    psnr_adder = Adder()
    print("Start Validation...")
    try:
        with torch.inference_mode():
            for hazy, gt, _ in EvalLoader(data_dir, "test"):
                padded, (h, w) = pad_to_multiple(hazy, factor)
                pred = model(torch.from_numpy(padded).to(device))[2][0]
                pred = np.clip(pred.cpu().numpy()[:h, :w], 0.0, 1.0)
                psnr_adder(psnr_skimage(pred, gt[0]))
    finally:
        model.train(was_training)
    return psnr_adder.average()
