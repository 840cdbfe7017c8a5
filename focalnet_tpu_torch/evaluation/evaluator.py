"""Validation and the test-split evaluation (counterpart of
``focalnet_tpu/evaluation/evaluator.py``).

``validate`` is what training calls at the epoch boundary: the mean
skimage-PSNR over the test split at full size.  ``evaluate`` is ``--mode
test``, the reference ``eval.py``'s protocol: both PSNR formulas, the pooled
SSIM, the time per image, and optionally the images.  Each image is
reflect-padded to a multiple of 32 and the prediction cropped back and
clamped.  The printed lines are the reference's, byte for byte where
``utils/plot_logs.py`` reads them ("Average PSNR %.2f dB").
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from focalnet_tpu_torch.data.reside import EvalLoader
from focalnet_tpu_torch.evaluation.metrics import (
    eval_ssim,
    pad_to_multiple,
    psnr_mse,
    psnr_skimage,
    save_image,
)
from focalnet_tpu_torch.utils.meters import Adder


@contextlib.contextmanager
def _forward(model):
    """Yield ``fwd``: (B, H, W, 3) float32 array -> the full-size output of
    ``model`` (a MIMOUNet, on its device) as a host array.  The model runs in
    eval mode and is put back in the mode it was in."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()

    def fwd(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return model(torch.from_numpy(x).to(device))[2].cpu().numpy()

    try:
        yield fwd
    finally:
        model.train(was_training)


def validate(model, data_dir: str, factor: int = 32, batch_size: int = 1,
             mesh=None) -> float:
    """Mean PSNR of ``model`` over ``data_dir/test``.

    ``batch_size > 1`` stacks images of one padded shape into one forward,
    with the same metrics: a bucket is run when it is full or the next
    image's padded shape differs, and a partial bucket runs at its own
    size.  The reference protocol is batch 1.

    Under a ``mesh`` (a :class:`..parallel.Mesh`; ``model`` mesh-free) the
    ranks split the images, image i to rank ``i % size``, and the PSNR sum
    and count are all-reduced: every rank returns the mean over all of them,
    and no rank waits in a collective longer than one rank's share takes."""
    psnr_adder = Adder()
    print("Start Validation...")
    buf = []  # (padded, h, w, gt), one padded shape

    with _forward(model) as fwd:
        def flush():
            if not buf:
                return
            preds = fwd(np.concatenate([b[0] for b in buf], axis=0))
            for pred, (_, h, w, gt) in zip(preds, buf):
                psnr_adder(psnr_skimage(np.clip(pred[:h, :w], 0.0, 1.0), gt[0]))
            buf.clear()

        shard = (0, 1) if mesh is None else (mesh.rank, mesh.size)
        for hazy, gt, _ in EvalLoader(data_dir, "test", shard=shard):
            padded, (h, w) = pad_to_multiple(hazy, factor)
            if buf and (len(buf) >= batch_size or buf[0][0].shape != padded.shape):
                flush()
            buf.append((padded, h, w, gt))
        flush()
    if mesh is None:
        return psnr_adder.average()
    from focalnet_tpu_torch.parallel.mesh import all_reduce

    total, count = all_reduce(torch.tensor([psnr_adder.num, psnr_adder.count],
                                           dtype=torch.float64, device=mesh.device),
                              mesh).tolist()
    return total / count if count else 0.0


def evaluate(model, data_dir: str, result_dir: Optional[str] = None,
             save_images: bool = False, factor: int = 32) -> dict:
    """The reference's test protocol over ``data_dir/test``, batch 1: prints
    each image's PSNR, SSIM and time and the three averages; saves the
    predictions (+0.5/255 offset) under ``result_dir`` when
    ``save_images``.  Returns {"psnr", "ssim", "time"}.

    An image's time runs from the upload to the prediction on the host, so
    it holds the whole forward on the card, not only its launches."""
    time_adder, psnr_adder, ssim_adder = Adder(), Adder(), Adder()

    with _forward(model) as fwd:
        for iter_idx, (hazy, gt, name) in enumerate(EvalLoader(data_dir, "test")):
            padded, (h, w) = pad_to_multiple(hazy, factor)
            tm = time.time()
            pred = fwd(padded)
            elapsed = time.time() - tm
            time_adder(elapsed)

            # the reference's H, W: the NEXT multiple of 32 where h or w is
            # one already (eval.py:34), for SSIM's pool grid
            H = (h + factor) // factor * factor
            W = (w + factor) // factor * factor
            pred = np.clip(pred[:, :h, :w], 0.0, 1.0)

            psnr_val = psnr_mse(pred, gt)
            ssim_val = float(eval_ssim(pred, gt, (H, W))[0])
            print("%d iter PSNR_dehazing: %.2f ssim: %f" % (iter_idx + 1, psnr_val, ssim_val))
            ssim_adder(ssim_val)

            if save_images and result_dir:
                os.makedirs(result_dir, exist_ok=True)
                save_image(pred[0], os.path.join(result_dir, name))

            psnr_mimo = psnr_skimage(pred, gt)
            psnr_adder(psnr_val)
            print("%d iter PSNR: %.2f time: %f" % (iter_idx + 1, psnr_mimo, elapsed))

    print("==========================================================")
    print("The average PSNR is %.2f dB" % psnr_adder.average())
    print("The average SSIM is %.5f dB" % ssim_adder.average())
    print("Average time: %f" % time_adder.average())
    return {
        "psnr": psnr_adder.average(),
        "ssim": ssim_adder.average(),
        "time": time_adder.average(),
    }
