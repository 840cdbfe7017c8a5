"""Process mesh and launcher over ``torch.distributed`` (counterpart of
``focalnet_tpu/parallel/mesh.py``).

The JAX package lays a mesh with named axes over the devices of one
program; here each point of the mesh is a process (a rank) with a
``torch.distributed`` process group, launched on one node by
:func:`spawn` with ``torch.multiprocessing`` (one process per rank).  Rank
``r`` runs on ``cuda:(r % device_count)``, or on the CPU.  The backend is
NCCL when every rank has a card of its own, and gloo when ranks share one
(NCCL refuses two ranks on one device) or run on the CPU; either way the
kernels run on the card in every rank, and gloo's collectives go through
the host.

The shapes are JAX's: ``(N,)`` over ``("data",)`` (data parallelism),
``(D, M)`` over ``("data", "seq")`` (dp x sp) and, through the API,
``(D, T)`` over ``("data", "model")`` (dp x tp, the channel-split scan).
Ranks are laid out row-major.  Every collective runs over one named axis
(this rank's row of it: a process group of its own, made for every row by
:func:`make_mesh`) or over the whole mesh.  The autograd Functions at the
end take one rank's shard of a replicated tensor and gather the shards
back, with the gradients the sharded scans need.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# A collective that waits longer fails its rank: between two collectives the
# ranks do the same work, apart from rank 0's logs and checkpoints.
COLLECTIVE_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the process mesh: the axis sizes (``shape``, a
    dict like a JAX mesh's), this rank, its device, the collective backend,
    this rank's process group along each axis (``groups``; None: the default
    group) and the whole mesh's (``group``; None: the default group)."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (ranks are row-major); 0
        along an axis the mesh does not have."""
        if axis not in self.shape:
            return 0
        names = list(self.shape)
        stride = math.prod(self.shape[a] for a in names[names.index(axis) + 1:])
        return self.rank // stride % self.shape[axis]


def parse_mesh_shape(text: str) -> Optional[Tuple[int, ...]]:
    """``--mesh_shape``'s comma ints, as the JAX CLI parses them; '' -> None."""
    return tuple(int(s) for s in text.split(",") if s) or None


def default_axes(shape: Sequence[int]) -> Tuple[str, ...]:
    """The JAX CLI's axis names for a ``--mesh_shape``: ``("data",)`` for
    one int, ``("data", "seq")`` for two."""
    return ("data",) if len(shape) == 1 else ("data", "seq")


def check_shape(shape: Sequence[int], axes: Optional[Sequence[str]] = None) -> None:
    """Raise ValueError unless ``shape`` is one or two positive ints with as
    many axis names (JAX cannot build the others either)."""
    axes = tuple(axes or default_axes(shape))
    if len(shape) not in (1, 2) or len(axes) != len(shape) or min(shape) < 1:
        raise ValueError(f"mesh shape {tuple(shape)} over axes {axes}: the port runs "
                         "(N,) over ('data',) or (D, M) over ('data', <axis>), sizes >= 1")


def auto_mesh_shape(batch_size: int, n_devices: int) -> Tuple[int]:
    """The JAX trainer's default for ``--mesh_shape ''``: the largest device
    count dividing the batch, all on ``data``."""
    n = n_devices
    while n > 1 and batch_size % n != 0:
        n -= 1
    return (n,)


def local_rows(n: int, mesh: Optional[Mesh], axis: str = "data") -> slice:
    """This rank's rows of a batch of ``n`` sharded over ``axis``: ``n / D``
    consecutive rows when D divides n (JAX's ``shard_batch``); otherwise the
    first ``n % D`` ranks take one row more, and with ``n < D`` the last
    ranks take none.  All rows without a mesh or such an axis."""
    if mesh is None or axis not in mesh.shape:
        return slice(0, n)
    q, r = divmod(n, mesh.shape[axis])
    i = mesh.axis_index(axis)
    start = i * q + min(i, r)
    return slice(start, start + q + (i < r))


def make_mesh(shape: Sequence[int], device: Optional[torch.device] = None,
              axes: Optional[Sequence[str]] = None) -> Optional[Mesh]:
    """This rank's :class:`Mesh` of ``shape`` over ``axes`` (default: the
    JAX CLI's names) on the first ``prod(shape)`` ranks of the initialised
    default process group.  Every rank of the group calls it, since each
    axis row gets a process group of its own (``dist.new_group`` is
    collective); a rank outside the mesh gets None."""
    axes = tuple(axes or default_axes(shape))
    check_shape(shape, axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (see spawn)")
    size, world, rank = math.prod(shape), dist.get_world_size(), dist.get_rank()
    if world < size:
        raise ValueError(f"mesh shape {tuple(shape)} over a world of {world}")
    whole = None if size == world else dist.new_group(list(range(size)))
    grid = torch.arange(size).reshape(tuple(shape))  # ranks, row-major
    groups = {}
    for k, axis in enumerate(axes):
        for ranks in grid.movedim(k, -1).reshape(-1, shape[k]).tolist():
            # a row that is the whole world is the default group; one of a
            # single rank needs no group (its collectives copy)
            if len(ranks) == world or len(ranks) == 1:
                g = None
            else:
                g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    if rank >= size:
        return None
    return Mesh(shape=dict(zip(axes, shape)), rank=rank, device=torch.device(device or "cpu"),
                backend=dist.get_backend(), groups=groups, group=whole)


def choose_backend(device_type: str, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % cards)``, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _host(shape, t: torch.Tensor) -> torch.Tensor:
    """An empty host tensor of ``t``'s dtype for gloo; page-locked when ``t``
    is on the card, so that the copies to and from it run at the bus's rate
    (PyTorch caches such blocks)."""
    return torch.empty(shape, dtype=t.dtype, pin_memory=t.is_cuda)


def _over(mesh: Mesh, axis: Optional[str]):
    """(ranks, process group) of a collective over ``axis`` (None: the
    whole mesh)."""
    if axis is None:
        return mesh.size, mesh.group
    return mesh.shape[axis], mesh.groups[axis]


def all_gather(t: torch.Tensor, mesh: Mesh, axis: Optional[str]) -> torch.Tensor:
    """The ``t`` of every rank of this rank's row of ``axis`` (None: of the
    whole mesh), stacked along a new first axis in their order, on ``t``'s
    device (no autograd).  Under gloo the tensors go through the host."""
    n, group = _over(mesh, axis)
    if n == 1:
        return t.detach()[None].clone()
    if mesh.backend == "nccl":
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.detach().contiguous(), group=group)
        return out
    host = _host(t.shape, t)
    host.copy_(t.detach())
    parts = _host((n,) + tuple(t.shape), t)
    dist.all_gather(list(parts), host, group=group)
    return parts.to(t.device)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """The sum of ``t`` over this rank's row of ``axis`` (None: over the
    whole mesh), on ``t``'s device, as a new tensor (no autograd).  Under
    gloo the tensor goes through the host."""
    n, group = _over(mesh, axis)
    if n == 1:
        return t.detach().clone()
    if mesh.backend == "nccl":
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out
    host = _host(t.shape, t)
    host.copy_(t.detach())
    dist.all_reduce(host, group=group)
    return host.to(t.device)


def take_shard(x: torch.Tensor, dim: int, groups: int, n: int, i: int) -> torch.Tensor:
    """Shard ``i`` of ``n`` of ``x`` along ``dim``: that dimension seen as
    ``(groups, size / groups)``, block ``i`` of each group's run (groups=1:
    one contiguous block), contiguous."""
    s = x.shape
    w = s[dim] // groups // n
    v = x.reshape(*s[:dim], groups, s[dim] // groups, *s[dim + 1:])
    return v.narrow(dim + 1, i * w, w).reshape(*s[:dim], groups * w, *s[dim + 1:]).contiguous()


def join_shards(parts: torch.Tensor, dim: int, groups: int) -> torch.Tensor:
    """The inverse of :func:`take_shard` over every shard: ``parts`` (n,
    *shard shape) stacked in shard order -> the whole tensor."""
    n, s = parts.shape[0], parts.shape[1:]
    v = parts.reshape(n, *s[:dim], groups, s[dim] // groups, *s[dim + 1:]).movedim(0, dim + 1)
    return v.reshape(*s[:dim], groups * n * (s[dim] // groups), *s[dim + 1:])


class TakeShard(torch.autograd.Function):
    """A tensor replicated over ``axis`` -> this rank's shard along ``dim``
    (:func:`take_shard`); backward: the shards' gradients all-gathered into
    the whole (every rank's layers before the cut need all of it)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, groups):
        ctx.args = (mesh, axis, dim % x.dim(), groups)
        return take_shard(x, dim % x.dim(), groups, mesh.shape[axis], mesh.axis_index(axis))

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, groups = ctx.args
        return join_shards(all_gather(g.contiguous(), mesh, axis), dim, groups), None, None, None, None


class GatherShards(torch.autograd.Function):
    """Each rank's shard along ``dim`` -> the whole tensor on every rank of
    ``axis``; backward: this rank's shard of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, groups):
        ctx.args = (mesh, axis, dim % x.dim(), groups)
        return join_shards(all_gather(x.contiguous(), mesh, axis), dim % x.dim(), groups)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, groups = ctx.args
        return (take_shard(g, dim, groups, mesh.shape[axis], mesh.axis_index(axis)),
                None, None, None, None)


class SumOverAxis(torch.autograd.Function):
    """The identity on a tensor replicated over ``axis`` that each rank uses
    for part of the work; backward: the gradients summed over ``axis``."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), *ctx.args), None, None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, shape, axes, device_type, backend, port, collective_s, queue, args):
    """One rank: join the process group, build its mesh, run
    ``fn(mesh, *args)`` and send ``(rank, result)`` to the parent.  Ranks
    other than 0 print nothing to stdout."""
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # one intra-op thread a rank: the ranks share the host's cores, and
        # with several threads each the plain scan's results varied from run
        # to run (at 1e-5) in about one rank world of five
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=math.prod(shape),
        rank=rank, timeout=datetime.timedelta(seconds=collective_s))
    try:
        result = fn(make_mesh(shape, device, axes), *args)
        queue.put((rank, result))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, shape: Sequence[int], device_type: str = "cuda",
          args: tuple = (), timeout_s: Optional[float] = None,
          axes: Optional[Sequence[str]] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``prod(shape)`` new processes, one per rank
    of a mesh of ``shape`` over ``axes`` (default: the JAX CLI's names) on
    this node, and return their results by rank.  ``fn`` and its results must pickle (a module-level
    function; numbers, strings, numpy arrays).

    Raises if a rank raises or dies, and after ``timeout_s`` seconds (None:
    no limit); a collective that waits longer than ``timeout_s`` or
    :data:`COLLECTIVE_TIMEOUT_S`, the smaller, fails its rank.  Every
    process is stopped either way."""
    import torch.multiprocessing as mp

    axes = tuple(axes or default_axes(shape))
    check_shape(shape, axes)
    world = math.prod(shape)
    backend = choose_backend(device_type, world)
    print(f"mesh {dict(zip(axes, shape))}: {world} ranks on {device_type} over {backend}",
          flush=True)
    queue = mp.get_context("spawn").SimpleQueue()
    collective_s = min(COLLECTIVE_TIMEOUT_S, timeout_s or COLLECTIVE_TIMEOUT_S)
    ctx = mp.start_processes(
        _rank_main, args=(fn, tuple(shape), axes, device_type, backend, _free_port(), collective_s,
                          queue, args),
        nprocs=world, join=False, start_method="spawn")
    results = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while True:
            while not queue.empty():  # drained while waiting: a rank blocks on a full pipe
                rank, result = queue.get()
                results[rank] = result
            if ctx.join(timeout=0.2):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks did not finish in {timeout_s} s")
        while not queue.empty():
            rank, result = queue.get()
            results[rank] = result
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5)
    missing = sorted(set(range(world)) - set(results))
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [results[r] for r in range(world)]
