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
  flax LayerNorm/GroupNorm/BatchNorm scale -> weight
  flax BatchNorm batch_stats mean / var    -> running_mean / running_var
  raw stacks (x_proj_weight, dt_projs_*, A_logs, Ds, and Mamba1D's
      conv1d_weight (K, D), x_proj_weight, dt_proj_*, A_logs, Ds): unchanged

Three keys and layouts depart from the JAX converter's, which gets them
wrong (ROADMAP Queue 3 logs them as faults on the JAX side):

- SS2D's ``dwconv3`` out-norm kernel (3, 3, 1, D) becomes ``out_norm.weight``
  in torch's (D, 1, 3, 3); the JAX map treats every ``out_norm`` as a norm
  scale and leaves the kernel in flax's layout, which no Conv2d loads.
- GhostModule's ``Conv_0`` and ``Conv_1`` become the reference's
  ``primary_conv.0`` and ``cheap_operation.0`` (a module holding a
  ``Conv_1`` is a GhostModule: no other module of the package has two
  convs); the JAX map sends both to ``main.0``, and they collide.
- BasicConv's ``BatchNorm_0`` becomes the reference's ``main.1`` (the JAX map
  keeps ``BatchNorm_0``), and its running statistics, which flax keeps in the
  ``batch_stats`` collection, come from the tree passed as ``batch_stats``
  (with ``num_batches_tracked`` 0: flax counts no batches).
"""

from __future__ import annotations

import os
import re
from collections.abc import Mapping
from typing import Dict, List, Tuple

import numpy as np
import torch


_GHOST_CONVS = {"Conv_0": "primary_conv", "Conv_1": "cheap_operation"}
_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _translate(path: Tuple[str, ...], ghost: bool = False) -> Tuple[str, str]:
    """Map a flax param path (module names..., leaf) to the reference's
    state-dict key and the layout transform, one of
    {conv, conv_t, dense, norm_scale, plain}.  ``ghost``: the leaf's conv
    is one of a GhostModule's two."""
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
        elif re.fullmatch(r"BatchNorm_\d+", m):
            parts += ["main", "1"]  # BasicConv's BatchNorm slot
            kind = "norm_scale"
        elif ghost and m in _GHOST_CONVS:
            parts += [_GHOST_CONVS[m], "0"]
            kind = "conv"
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

    if leaf == "kernel" and kind == "norm_scale":  # the dwconv3 out-norm
        torch_leaf, kind = "weight", "conv"
    elif leaf in ("kernel", "scale"):
        torch_leaf = "weight"
    elif leaf in _BATCH_STATS:
        torch_leaf, kind = _BATCH_STATS[leaf], "plain"
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


def state_dict_from_jax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested mappings of arrays, with or without the top
    ``"params"`` collection) -> the port's state dict, reference keys and
    layouts, fp32.  ``batch_stats`` (the ``batch_stats`` collection, with or
    without its top key) adds each BatchNorm's running mean and variance,
    and its ``num_batches_tracked`` (0)."""
    leaves = []
    for tree, top in ((params, "params"), (batch_stats or {}, "batch_stats")):
        leaves += [(p[1:] if p[0] == top else p, v) for p, v in _leaves(tree)]
    ghosts = {p[:-2] for p, _ in leaves if len(p) >= 2 and p[-2] == "Conv_1"}
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in leaves:
        key, kind = _translate(path, ghost=path[:-2] in ghosts)
        if key in sd:
            raise ValueError(f"two leaves map to the key {key!r} (second: {'.'.join(path)})")
        w = _INVERSE_TRANSFORMS[kind](np.asarray(leaf, dtype=np.float32))
        sd[key] = torch.from_numpy(np.array(w, order="C"))
        if path[-1] == "mean":
            sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0)
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
