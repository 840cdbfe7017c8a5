"""Utilities: device choice, reference-format weights, meters, FLOPs and
profiling."""

from focalnet_tpu_torch.utils.convert import (
    load_checkpoint,
    save_checkpoint,
    state_dict_from_jax,
)
from focalnet_tpu_torch.utils.device import resolve_device
from focalnet_tpu_torch.utils.flops import model_flops, scan_flops
from focalnet_tpu_torch.utils.meters import Adder, Timer
from focalnet_tpu_torch.utils.profiling import annotate, timed, trace

__all__ = [
    "Adder",
    "Timer",
    "annotate",
    "load_checkpoint",
    "model_flops",
    "resolve_device",
    "save_checkpoint",
    "scan_flops",
    "state_dict_from_jax",
    "timed",
    "trace",
]
