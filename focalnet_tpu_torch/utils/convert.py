"""Reference-format weights for the port (counterpart of ``focalnet_tpu/utils/convert.py``).

The port's module tree carries the reference's state-dict names, so its
checkpoints are reference ``.pkl`` files (``{'model': state_dict, 'epoch':
n}``) with no conversion.  :func:`state_dict_from_jax` brings a JAX param
tree (nested dicts of arrays, as ``jax.device_get(params)`` gives) into that
format; it is an own copy of the JAX converter's name map and inverse layout
rules, since the port imports nothing of ``focalnet_tpu``:

  flax Conv kernel (kh, kw, I, O)          -> torch Conv2d (O, I, kh, kw)
  flax ConvTranspose kernel (kh, kw, I, O) -> torch ConvTranspose2d (I, O, kh, kw)
      with SPATIALLY FLIPPED taps (flax's SAME transposed conv vs torch's
      k4 s2 p1 one)
  flax Dense kernel (I, O)                 -> torch Linear (O, I)
  flax LayerNorm/GroupNorm scale           -> weight
  raw stacks (x_proj_weight, dt_projs_*, A_logs, Ds): unchanged
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Dict, List, Tuple

import numpy as np
import torch


def _translate(path: Tuple[str, ...]) -> Tuple[str, str]:
    """Map a flax param path (module names..., leaf) to the reference's
    state-dict key and the layout transform, one of
    {conv, conv_t, dense, norm_scale, plain}."""
    parts: List[str] = []
    kind = "plain"
    leaf = path[-1]
    for m in path[:-1]:
        if re.fullmatch(r"(Encoder|Decoder|feat_extract|Convs|ConvsOut)_\d+", m):
            base, idx = m.rsplit("_", 1)
            parts += [base, idx]
        elif m in ("SCM1", "SCM2", "FAM1", "FAM2"):
            parts.append(m)
            if m.startswith("FAM"):
                parts.append("merge")
        elif re.fullmatch(r"BasicConv_\d+", m):
            # SCM's k-th BasicConv is main.k, as is a ResBlock's; elsewhere
            # BasicConv_0 is the module itself
            if parts and parts[-1] in ("SCM1", "SCM2"):
                parts += ["main", m.split("_")[1]]
            elif len(parts) >= 2 and parts[-2] == "layers":
                parts += ["main", m.split("_")[1]]
        elif re.fullmatch(r"GroupNorm_\d+", m):
            parts += ["main", "4"]  # SCM's InstanceNorm slot
            kind = "norm_scale"
        elif re.fullmatch(r"(Conv|ConvTranspose)_\d+", m):
            parts += ["main", "0"]  # BasicConv's conv slot
            kind = "conv_t" if m.startswith("ConvTranspose") else "conv"
        elif re.fullmatch(r"layers_\d+", m):
            parts += ["layers", m.split("_")[1]]
        elif re.fullmatch(r"layers_\d+_(global|local)_\d+", m):
            _, idx, branch, d = m.split("_")
            parts += ["layers", idx, f"seq_{branch}", "blocks", d]
        elif m.startswith("patch_embed_") or m.startswith("patch_unembed_"):
            # patch_embed_global_conv -> patch_embed_global.0, ..._norm -> .2;
            # patch_unembed_global_conv -> patch_unembed_global.1
            stem, slot = m.rsplit("_", 1)
            if slot == "conv":
                parts += [stem, "1" if stem.startswith("patch_unembed") else "0"]
                kind = "conv"
            else:
                parts += [stem, "2"]
                kind = "norm_scale"
        elif m in ("norm", "norm2", "out_norm"):
            parts.append(m)
            kind = "norm_scale"
        elif m in ("fc1", "fc2", "in_proj", "out_proj"):
            parts.append(m)
            kind = "dense"
        elif m == "conv2d":
            parts.append(m)
            kind = "conv"
        else:  # mlp, op, ...
            parts.append(m)

    if leaf in ("kernel", "scale"):
        torch_leaf = "weight"
    else:  # bias and the raw stacks keep their layout
        torch_leaf = leaf
        kind = "plain"
    return ".".join(parts + [torch_leaf]), kind


_INVERSE_TRANSFORMS = {
    "conv": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "conv_t": lambda w: np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1],
    "dense": np.transpose,
    "norm_scale": lambda w: w,
    "plain": lambda w: w,
}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested mappings of arrays, with or without the top
    ``"params"`` collection) -> the port's state dict, reference keys and
    layouts, fp32."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        if path[0] == "params":
            path = path[1:]
        key, kind = _translate(path)
        if key in sd:
            raise ValueError(f"two leaves map to the key {key!r} (second: {'.'.join(path)})")
        w = _INVERSE_TRANSFORMS[kind](np.asarray(leaf, dtype=np.float32))
        sd[key] = torch.from_numpy(np.array(w, order="C"))
    return sd


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state_dict, epoch: int = 0, optimizer=None) -> None:
    """Write a reference-format ``.pkl``: ``{'model': state_dict, 'epoch':
    epoch}``, plus ``'optimizer'`` (an optimizer's state dict) when given.
    Tensors are stored on the CPU; the file is written whole or not at all
    (a temporary file renamed over ``path``)."""
    obj = {"model": _to_cpu(state_dict), "epoch": epoch}
    if optimizer is not None:
        obj["optimizer"] = _to_cpu(optimizer)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, full: bool = False):
    """Read a reference ``.pkl`` (``{'model': sd, ...}`` or a bare state
    dict) onto the CPU: the state dict, or with ``full=True`` the whole
    object.  Only tensors and plain containers are unpickled."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if full:
        return obj
    return obj["model"] if "model" in obj else obj
