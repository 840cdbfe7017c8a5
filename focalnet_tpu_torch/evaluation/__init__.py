"""Serving (the line-protocol server, tiled inference), batch-1 validation,
image helpers and PSNR."""

from focalnet_tpu_torch.evaluation.infer import tiled_forward
from focalnet_tpu_torch.evaluation.evaluator import validate
from focalnet_tpu_torch.evaluation.metrics import (
    pad_to_multiple,
    psnr_mse,
    psnr_skimage,
    save_image,
)
from focalnet_tpu_torch.evaluation.serve import serve

__all__ = [
    "pad_to_multiple", "psnr_mse", "psnr_skimage", "save_image", "serve",
    "tiled_forward", "validate",
]
