"""The MIMO-UNet dehazer and its modules."""

from focalnet_tpu_torch.models.layers import BasicConv, GhostModule, pixel_shuffle
from focalnet_tpu_torch.models.mamba1d import Mamba1D, MambaSS2D, causal_conv1d
from focalnet_tpu_torch.models.mimounet import MIMOUNet, StageStack, build_net
from focalnet_tpu_torch.models.ss2d import (
    SS2D,
    DropPath,
    Dropout,
    parse_forward_type,
    set_dropout_generator,
)
from focalnet_tpu_torch.models.vssg import VSSG, VSSBlock

__all__ = [
    "BasicConv", "DropPath", "Dropout", "GhostModule", "MIMOUNet", "Mamba1D", "MambaSS2D",
    "SS2D", "StageStack", "VSSBlock", "VSSG", "build_net", "causal_conv1d",
    "parse_forward_type", "pixel_shuffle", "set_dropout_generator",
]
