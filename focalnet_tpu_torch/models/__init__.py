"""The MIMO-UNet dehazer and its modules."""

from focalnet_tpu_torch.models.mimounet import MIMOUNet, StageStack, build_net
from focalnet_tpu_torch.models.ss2d import SS2D, DropPath, set_drop_path_generator
from focalnet_tpu_torch.models.vssg import VSSG, VSSBlock

__all__ = [
    "DropPath", "MIMOUNet", "SS2D", "StageStack", "VSSBlock", "VSSG", "build_net",
    "set_drop_path_generator",
]
