"""What each rank of the port's gloo worlds on the CPU runs: the 2-rank
world of ``tests/test_torch_seq_parallel.py``, the 4-rank one of
``tests/test_torch_data_parallel.py`` and the 2-rank one of
``tests/test_torch_tensor_parallel.py`` (a module of its own, importable by
name in the spawned ranks, which import no JAX).  Every case returns numpy
arrays and numbers."""

import contextlib
import io

import numpy as np
import torch

from focalnet_tpu_torch.main import main
from focalnet_tpu_torch.models import build_net
from focalnet_tpu_torch.models.ss2d import SS2D, set_dropout_generator
from focalnet_tpu_torch.parallel import make_mesh, selective_scan_seq_sharded
from focalnet_tpu_torch.parallel.tp_scan import selective_scan_tp
from focalnet_tpu_torch.train.trainer import (
    batch_rows,
    make_optimizer,
    make_train_step,
    micro_batch_rows,
)

TINY = dict(vssg_dim=16, ssm_d_state=4)
SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def scan_grads(scan, arrays, dy, reverse):
    """y and the gradients of ``sum(y * dy)`` of ``scan(*operands, reverse)``."""
    leaves = [torch.tensor(arrays[k], requires_grad=True) for k in SCAN_NAMES]
    y = scan(*leaves, reverse)
    (y * torch.tensor(dy)).sum().backward()
    return y.detach().numpy(), [t.grad.numpy() for t in leaves]


def ss2d_out_grads(ss2d, x):
    """SS2D's output at x and the gradients of ``sum |y|`` by parameter."""
    ss2d.zero_grad()
    y = ss2d(torch.tensor(x))
    y.abs().sum().backward()
    return y.detach().numpy(), {k: p.grad.numpy() for k, p in ss2d.named_parameters()}


def train_step(model, hazy, gt, mesh=None, grad_accum=1):
    """One train step of ``model`` (loss, clip, Adam) over ``grad_accum``
    micro-batches, on this rank's rows of each (maybe none), with the
    step-seeded mask generator drawing each micro-batch's masks whole: the
    loss, the (clipped) gradients and the parameters after the step."""
    model.train()
    batch = len(hazy)
    rows, shard = batch_rows(batch, grad_accum, mesh), None
    if rows is None:
        rows = slice(None)
    else:
        shard = (micro_batch_rows(batch, grad_accum, mesh).start, batch // grad_accum)
    set_dropout_generator(model, torch.Generator().manual_seed(7), shard)
    step = make_train_step(model, make_optimizer(model), grad_accum=grad_accum, mesh=mesh,
                           batch_size=batch)
    out = step(torch.tensor(hazy[rows]), torch.tensor(gt[rows]))
    return (float(out["loss"]), {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
            {k: p.detach().numpy().copy() for k, p in model.named_parameters()})


def run_cases(mesh, scan_case, ss2d_cases, train_case, test_argv):
    """Every case on this rank: the sequence-sharded scan (both directions)
    with the largest tensor its graph saves, the seq-sharded SS2D of each of
    ``ss2d_cases`` (by name: its keyword arguments, state dict and input), one train
    step of the seq-sharded model, and ``--mode test --mesh_shape 1,2``
    through the CLI on the running world (what rank 0 printed)."""
    out = {}
    arrays, dy = scan_case
    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: sizes.append(t.numel()) or t, lambda t: t):
        for reverse in (False, True):
            out[("scan", reverse)] = scan_grads(
                lambda *a: selective_scan_seq_sharded(*a[:7], delta_softplus=True,
                                                      mesh=mesh, reverse=a[7]),
                arrays, dy, reverse)
    out["scan_max_saved"] = max(sizes)

    for name, (ss2d_kw, state, x) in ss2d_cases.items():
        ss2d = SS2D(**ss2d_kw, seq_mesh=mesh, seq_axis="seq")
        ss2d.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        out[name] = ss2d_out_grads(ss2d, x)

    seed, hazy, gt = train_case
    model = build_net("1mlp_g2", device="cpu", generator=torch.Generator().manual_seed(seed),
                      seq_mesh=mesh, seq_axis="seq", data_axis="data", **TINY)
    out["train"] = train_step(model, hazy, gt, mesh)

    with contextlib.redirect_stdout(io.StringIO()):
        out["test_cli"] = main(test_argv)
    return out


def _cli(argv):
    """``main(argv)`` on the running world, its printout kept by the report."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def run_dp_cases(mesh, train_case, clis):
    """The 4-rank world of the data-parallel tests: one train step of the
    tiny model (DropPath on) on the ``(4,)`` data-parallel mesh, once more
    there over two micro-batches of 2 (ranks 2 and 3 hold no rows), and on a
    ``(2, 2)`` dp x sp mesh, then each CLI command of ``clis`` on the
    running world (those of two ranks on ranks 0 and 1; None on the others)."""
    seed, hazy, gt = train_case
    out = {}
    model = build_net("1mlp_g2", device="cpu", generator=torch.Generator().manual_seed(seed),
                      **TINY)
    out["dp"] = train_step(model, hazy, gt, mesh)
    model = build_net("1mlp_g2", device="cpu", generator=torch.Generator().manual_seed(seed),
                      **TINY)
    out["dp_accum"] = train_step(model, hazy, gt, mesh, grad_accum=2)
    dpsp = make_mesh((2, 2), mesh.device)
    model = build_net("1mlp_g2", device="cpu", generator=torch.Generator().manual_seed(seed),
                      seq_mesh=dpsp, seq_axis="seq", data_axis="data", **TINY)
    out["dpsp"] = train_step(model, hazy, gt, dpsp)
    out["cli"] = {name: _cli(argv) for name, argv in clis}
    return out


def run_tp_cases(mesh, scan_cases, ss2d_cases, train_case):
    """The 2-rank ``(data, model) = (1, 2)`` world of the tensor-parallel
    tests: the channel-split scan of each of ``scan_cases`` (y and the
    gradients of ``sum(y * dy)``), the channel-split SS2D of each of
    ``ss2d_cases``, and one train step of the tiny model with channel-split
    scans."""
    out = {}
    for name, (arrays, dy, reverse, accum) in scan_cases.items():
        names = SCAN_NAMES + (("y_accum",) if accum else ())
        leaves = [torch.tensor(arrays[k], requires_grad=True) for k in names]
        y = selective_scan_tp(*leaves[:7], True, mesh=mesh, reverse=reverse,
                              y_accum=leaves[7] if accum else None)
        (y * torch.tensor(dy)).sum().backward()
        out[name] = y.detach().numpy(), [t.grad.numpy() for t in leaves]

    for name, (ss2d_kw, state, x) in ss2d_cases.items():
        ss2d = SS2D(**ss2d_kw, seq_mesh=mesh, tp_axis="model")
        ss2d.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        out[name] = ss2d_out_grads(ss2d, x)

    seed, hazy, gt = train_case
    model = build_net("1mlp_g2", device="cpu", generator=torch.Generator().manual_seed(seed),
                      seq_mesh=mesh, tp_axis="model", data_axis="data", **TINY)
    out["train"] = train_step(model, hazy, gt, mesh)
    return out
