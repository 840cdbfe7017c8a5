"""The MIMO-UNet dehazer, the MambaIR denoiser, and their modules.

Each preset's config type names its network (:data:`FAMILIES`); what the
entry points must know of a network is on its class: ``pad_multiple`` (the
multiple of H and W it takes), ``trains`` and ``shards_scans`` (whether
``--mode train`` and a sharded-scan mesh run it) and ``scan_flops`` (the
scan cost model of a forward)."""

import torch

from focalnet_tpu_torch.configs import PRESETS, MambaIRConfig, ModelConfig
from focalnet_tpu_torch.models.initializers import init_weights
from focalnet_tpu_torch.models.layers import BasicConv, GhostModule, pixel_shuffle
from focalnet_tpu_torch.models.mambair import MambaIR
from focalnet_tpu_torch.models.mamba1d import Mamba1D, MambaSS2D, causal_conv1d
from focalnet_tpu_torch.models.mimounet import MIMOUNet, StageStack
from focalnet_tpu_torch.models.ss2d import (
    SS2D,
    DropPath,
    Dropout,
    parse_forward_type,
    set_dropout_generator,
)
from focalnet_tpu_torch.models.vssg import VSSG, VSSBlock
from focalnet_tpu_torch.utils.device import resolve_device

FAMILIES = {ModelConfig: MIMOUNet, MambaIRConfig: MambaIR}


def model_class(preset: str):
    """The network class that ``preset`` builds."""
    return FAMILIES[type(PRESETS[preset])]


def build_net(preset: str = "1mlp_g2", device=None, generator=None, seq_mesh=None,
              **overrides) -> torch.nn.Module:
    """Build ``preset`` (with config ``overrides``) in eval mode on ``device``
    (default: the CUDA card; without one this raises), its weights drawn by
    the reference init laws from ``generator`` (default: seed 0).
    ``seq_mesh``: the mesh of the sharded scans (pass ``seq_axis`` or
    ``tp_axis``, and ``data_axis``, as overrides), for a network that
    ``shards_scans``."""
    device = resolve_device(device)
    cfg = PRESETS[preset].replace(**overrides)
    model = FAMILIES[type(cfg)](cfg, seq_mesh)
    init_weights(model, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    return model.to(device).eval()


__all__ = [
    "BasicConv", "DropPath", "Dropout", "FAMILIES", "GhostModule", "MIMOUNet", "Mamba1D",
    "MambaIR", "MambaSS2D", "SS2D", "StageStack", "VSSBlock", "VSSG", "build_net",
    "causal_conv1d", "model_class", "parse_forward_type", "pixel_shuffle",
    "set_dropout_generator",
]
