"""The model's weights, drawn from the seed on the card by the published
initialisation laws, in a few large draws.

- Linear layers (``in_proj``, ``out_proj``, the MLP's ``fc1``, ``fc2``):
  weights from a normal of std 0.02 cut at two std (a draw beyond is
  replaced by a uniform one within), biases zero;
- convolutions: weight and bias uniform in +-1/sqrt(fan_in), fan_in the
  input channels per group times the kernel's area (for the transposed
  convolutions ``feat_extract.3`` and ``feat_extract.4``, the first axis of
  the weight times the kernel's area);
- LayerNorm and InstanceNorm: weight one, bias zero;
- SS2D: ``x_proj_weight`` uniform in +-1/sqrt(d_inner), ``dt_projs_weight``
  uniform in +-rank^-1/2, ``dt_projs_bias`` the inverse softplus of a dt
  log-uniform in [0.001, 0.1] (at least 1e-4), ``A_logs`` log(1..N), ``Ds``
  one.

One uniform draw and one normal draw on a ``torch.Generator`` of the card
give every leaf its values; the same seed gives the same weights on every
card of a kind.
"""

from __future__ import annotations

import math

import torch

TRANSPOSED = ("feat_extract.3.", "feat_extract.4.")
LINEAR = (".in_proj.", ".out_proj.", ".fc1.", ".fc2.")
NORMS = (".norm.", ".norm2.", ".out_norm.", ".main.4.")


def law(name: str, shape, shapes: dict):
    """(kind, parameter) of a leaf: ("uniform", bound), ("normal", None),
    ("dt_bias", None), ("a_log", None), ("const", value)."""
    base = name.rsplit(".", 1)[0]
    if name.endswith("x_proj_weight"):
        return "uniform", 1.0 / math.sqrt(shape[-1])
    if name.endswith("dt_projs_weight"):
        return "uniform", shape[-1] ** -0.5
    if name.endswith("dt_projs_bias"):
        return "dt_bias", None
    if name.endswith("A_logs"):
        return "a_log", None
    if name.endswith(".Ds"):
        return "const", 1.0
    if any(t in name for t in NORMS) or (".patch_embed_" in name and base.endswith(".2")):
        return "const", 1.0 if name.endswith("weight") else 0.0
    if any(t in name for t in LINEAR):
        return ("normal", None) if name.endswith("weight") else ("const", 0.0)
    w = shapes[base + ".weight"]
    fan_in = (w[0] if name.startswith(TRANSPOSED) else w[1]) * math.prod(w[2:])
    return "uniform", 1.0 / math.sqrt(fan_in)


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
