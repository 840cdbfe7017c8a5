"""MambaIR's weights, drawn from the seed on the card by its initialisation
laws, in a few large draws (as ``weights.py`` draws MIMO-UNet's).

- Linear layers (SS2D's ``in_proj`` and ``out_proj``): a normal of std 0.02
  cut at two std (a draw beyond is replaced by a uniform one within); timm's
  ``trunc_normal_``, which MambaIR calls, cuts at two in absolute value;
- convolutions: weight and bias uniform in +-1/sqrt(fan_in), fan_in the
  input channels per group times the kernel's area (PyTorch's default);
- LayerNorm (``patch_embed.norm``, ``ln_1``, ``ln_2``, ``out_norm``,
  ``norm``): weight one, bias zero;
- ``skip_scale`` and ``skip_scale2``: one;
- SS2D (``initialize`` v0): ``x_proj_weight`` uniform in +-1/sqrt(d_inner),
  ``dt_projs_weight`` uniform in +-rank^-1/2, ``dt_projs_bias`` the inverse
  softplus of a dt log-uniform in [0.001, 0.1] (at least 1e-4), ``A_logs``
  log(1..N), ``Ds`` one.
"""

from __future__ import annotations

import math

import torch

LINEAR = (".in_proj.", ".out_proj.")
NORMS = ("patch_embed.norm.", ".ln_1.", ".ln_2.", ".out_norm.")
ONES = ("skip_scale", "skip_scale2", ".Ds")


def law(name: str, shape, shapes: dict):
    """(kind, parameter) of a leaf: ("uniform", bound), ("normal", None),
    ("dt_bias", None), ("a_log", None), ("const", value)."""
    if name.endswith("x_proj_weight"):
        return "uniform", 1.0 / math.sqrt(shape[-1])
    if name.endswith("dt_projs_weight"):
        return "uniform", shape[-1] ** -0.5
    if name.endswith("dt_projs_bias"):
        return "dt_bias", None
    if name.endswith("A_logs"):
        return "a_log", None
    if name.endswith(ONES):
        return "const", 1.0
    if name.startswith("norm.") or any(t in name for t in NORMS):
        return "const", 1.0 if name.endswith("weight") else 0.0
    if any(t in name for t in LINEAR):
        return ("normal", None) if name.endswith("weight") else ("const", 0.0)
    w = shapes[name.rsplit(".", 1)[0] + ".weight"]
    return "uniform", 1.0 / math.sqrt(w[1] * math.prod(w[2:]))


def make(shapes: dict, seed: int, device) -> dict:
    """Every leaf of ``shapes`` ({name: shape}) in fp32 on ``device``."""
    laws = {k: law(k, s, shapes) for k, s in shapes.items()}
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    uni = torch.rand(sum(sizes.values()), generator=gen, device=device)
    nrm = torch.randn(sum(n for k, n in sizes.items() if laws[k][0] == "normal"),
                      generator=gen, device=device)
    out, u, z = {}, 0, 0
    for k, shape in shapes.items():
        kind, arg = laws[k]
        n = sizes[k]
        r = uni[u:u + n]
        u += n
        if kind == "uniform":
            v = (2 * r - 1) * arg
        elif kind == "normal":  # std 0.02 cut at +-2 std: redraw out of range from r
            v = nrm[z:z + n]
            z += n
            v = torch.where(v.abs() <= 2, v, (2 * r - 1) * 2) * 0.02
        elif kind == "dt_bias":
            dt = torch.exp(r * (math.log(0.1) - math.log(0.001)) + math.log(0.001)).clamp(min=1e-4)
            v = dt + torch.log(-torch.expm1(-dt))
        elif kind == "a_log":
            v = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                       device=device)).expand(shape)
        else:
            v = torch.full((n,), arg, device=device)
        out[k] = v.reshape(shape).contiguous()
    return out
