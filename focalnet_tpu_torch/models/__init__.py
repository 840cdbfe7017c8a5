"""The MIMO-UNet dehazer and its modules."""

from focalnet_tpu_torch.models.mimounet import MIMOUNet, StageStack, build_net
from focalnet_tpu_torch.models.ss2d import SS2D, DropPath, Dropout, set_dropout_generator
from focalnet_tpu_torch.models.vssg import VSSG, VSSBlock

__all__ = [
    "DropPath", "Dropout", "MIMOUNet", "SS2D", "StageStack", "VSSBlock", "VSSG", "build_net",
    "set_dropout_generator",
]
