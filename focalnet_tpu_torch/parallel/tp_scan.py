"""Channel-sharded (tensor-parallel) selective scan over a ``torch.distributed``
group (counterpart of ``focalnet_tpu/parallel/tp_scan.py``).

The recurrence is independent per (channel, state) pair, so each of the
``T`` ranks of the mesh's ``model`` axis runs the scan kernel on its shard
of the channels, with no collective inside the scan.  The operands arrive
whole on every rank of the ``model`` row (replicated activations, as those
ranks run the model's other layers on the same inputs; under a ``(data,
model)`` mesh each row holds its data index's rows of the batch).  Two
granularities, as in the JAX module:

- **whole-group** (``G % T == 0``): each rank keeps ``G / T`` whole B/C
  groups and their channel rows, one contiguous block;
- **sub-group** (``G < T``, the live model's case: G = 2 direction groups of
  ``D_per`` channels each): each rank takes block ``t`` of every group's
  ``D_per`` channels (``D_per % T == 0``), and B and C stay replicated.

Gradients (the autograd Functions of :mod:`.mesh`): a sharded operand or
parameter (u, delta, A, D, the dt bias, ``y_accum``; B and C whole-group)
gets its shards' gradients all-gathered, so that every rank's layers before
the scan see the whole gradient; replicated B and C (sub-group) the sum over
``model`` of each rank's share; the gathered output gives each rank its own
shard of ``dy``.  The scan runs from a zero state: the plain launch, whose
state starts at zero as JAX's explicit ``h0 = 0`` does.  The TPU layout
(``pre_interleaved``, ``chunk``) has no counterpart.
"""

from __future__ import annotations

import torch

from focalnet_tpu_torch.ops.selective_scan import selective_scan
from focalnet_tpu_torch.parallel.mesh import GatherShards, Mesh, SumOverAxis, TakeShard


def selective_scan_tp(u, delta, A, B, C, D=None, delta_bias=None, delta_softplus=False,
                      *, mesh: Mesh, axis: str = "model", out_dtype=torch.float32,
                      backend="auto", reverse=False, y_accum=None, gather=True):
    """Selective scan with the channels sharded over ``mesh``'s ``axis``.

    Shapes as in :mod:`focalnet_tpu_torch.ops.scan_ref`, whole on every rank
    of this rank's ``axis`` row; picks whole-group or sub-group sharding
    (module docstring).  Returns the whole ``y`` (batch, dim, L) in
    ``out_dtype`` on every rank, or with ``gather=False`` this rank's shard
    of it, which a later call takes as its ``y_accum`` (``y_accum`` is
    either whole or such a shard, told apart by its channel count)."""
    if B.dim() == 3:
        B = B[:, None]
    if C.dim() == 3:
        C = C[:, None]
    n, G, dim = mesh.shape[axis], B.shape[1], u.shape[1]
    whole = G % n == 0
    if not whole and (dim // G) % n:
        raise ValueError(f"TP needs G ({G}) or D_per ({dim // G}) divisible by {axis}={n}")
    groups = 1 if whole else G
    take = lambda t, d: None if t is None else TakeShard.apply(t, mesh, axis, d, groups)
    if whole:
        B, C = (TakeShard.apply(t, mesh, axis, 1, 1) for t in (B, C))
    else:
        B, C = (SumOverAxis.apply(t, mesh, axis) for t in (B, C))
    if y_accum is not None and y_accum.shape[1] == dim:
        y_accum = take(y_accum, 1)
    y = selective_scan(take(u, 1), take(delta, 1), take(A, 0), B, C, D=take(D, 0),
                       delta_bias=take(delta_bias, 0), delta_softplus=delta_softplus,
                       out_dtype=out_dtype, backend=backend, reverse=reverse, y_accum=y_accum)
    return GatherShards.apply(y, mesh, axis, 1, groups) if gather else y
