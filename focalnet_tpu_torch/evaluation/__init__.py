"""Serving (the line-protocol server), inference on image directories, tiled
inference, validation, the test protocol, image helpers, PSNR and SSIM."""

from focalnet_tpu_torch.evaluation.infer import infer, tiled_forward
from focalnet_tpu_torch.evaluation.evaluator import evaluate, validate
from focalnet_tpu_torch.evaluation.metrics import (
    eval_ssim,
    pad_to_multiple,
    psnr_mse,
    psnr_skimage,
    save_image,
    ssim,
)
from focalnet_tpu_torch.evaluation.serve import serve

__all__ = [
    "eval_ssim", "evaluate", "infer", "pad_to_multiple", "psnr_mse", "psnr_skimage",
    "save_image", "serve", "ssim", "tiled_forward", "validate",
]
