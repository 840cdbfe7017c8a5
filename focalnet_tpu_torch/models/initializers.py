"""Reference init laws (counterpart of ``focalnet_tpu/models/initializers.py``).

Every law draws from an explicit ``torch.Generator``.  A generator and a JAX
key give different numbers for the same seed; the laws match, the draws do
not, and weights move between the two packages through ``utils/convert.py``.

- ``nn.Linear`` inside the VSSG: truncated normal, std 0.02, cut at +-2 std;
  bias zero.
- Convolutions: PyTorch's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the
  weight and the bias, fan_in = in_channels/groups * kh * kw (for a
  transposed conv, in_channels * kh * kw, as the JAX package counts it).
- SS2D's raw stacks: x_proj U(+-1/sqrt(d_inner)), dt_proj U(+-dt_rank^-0.5),
  the softplus-inverse dt bias, A_log = log(1..N), D = 1 (``initialize``
  v0); v1 and v2 take :func:`normal` and :func:`uniform` (flax's
  ``normal(1)`` and ``uniform(0.1)``) for some of them.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def trunc_normal_02(t: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(t, mean=0.0, std=0.02, a=-0.04, b=0.04, generator=generator)


@torch.no_grad()
def uniform_pm(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """U(-bound, +bound)."""
    t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std^2) (flax's ``initializers.normal(std)``)."""
    t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def uniform(t: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """U[0, scale) (flax's ``initializers.uniform(scale)``)."""
    t.uniform_(0.0, scale, generator=generator)


def torch_default(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """PyTorch's default conv/linear law U(+-1/sqrt(fan_in)), weight or bias."""
    uniform_pm(t, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, generator)


@torch.no_grad()
def dt_bias_init(t: torch.Tensor, generator: torch.Generator, dt_min=0.001,
                 dt_max=0.1, dt_init_floor=1e-4) -> None:
    """softplus^-1 of dt ~ LogUniform(dt_min, dt_max), dt clamped at the floor."""
    r = torch.rand(t.shape, generator=generator)
    dt = torch.exp(r * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min))
    dt = dt.clamp(min=dt_init_floor)
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


@torch.no_grad()
def a_log_init(t: torch.Tensor, generator: torch.Generator) -> None:
    """S4D-real: every row log(1..N).  Draws nothing from ``generator``."""
    del generator
    t.copy_(torch.log(torch.arange(1, t.shape[-1] + 1, dtype=torch.float32)).expand_as(t))


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Apply the reference laws to every submodule, in module order.  A module
    with raw parameter stacks initialises them in ``reset_parameters_from``."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_02(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else w.shape[0] * w[0, 0].numel()
            torch_default(w, fan_in, generator)
            if m.bias is not None:
                torch_default(m.bias, fan_in, generator)
        elif isinstance(m, (nn.LayerNorm, nn.InstanceNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif hasattr(m, "reset_parameters_from"):
            m.reset_parameters_from(generator)
