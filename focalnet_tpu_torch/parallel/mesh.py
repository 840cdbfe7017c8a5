"""Process mesh and launcher over ``torch.distributed`` (counterpart of
``focalnet_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, seq)`` mesh over the devices of one
program; here each point of the mesh is a process (a rank) with a
``torch.distributed`` process group, launched on one node by
:func:`spawn` with ``torch.multiprocessing`` (one process per rank).  Rank
``r`` runs on ``cuda:(r % device_count)``, or on the CPU.  The backend is
NCCL when every rank has a card of its own, and gloo when ranks share one
(NCCL refuses two ranks on one device) or run on the CPU; either way the
kernels run on the card in every rank, and gloo's collectives go through
the host (:func:`all_gather`, :func:`all_reduce`).

Only the ``(1, M)`` shape runs: sequence parallelism over ``M`` ranks at a
``data`` axis of 1, so every collective runs over the whole (default)
process group.  Data parallelism (``data > 1``) raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import socket
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "seq")
NOT_PORTED = ("data parallelism (a 'data' axis > 1) is not ported yet: "
              "ROADMAP.md Queue 1 item 6")
# A collective that waits longer fails its rank: between two collectives the
# ranks do the same work, apart from rank 0's logs and checkpoints.
COLLECTIVE_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the process mesh: the axis sizes (``shape``, a
    dict like a JAX mesh's), this rank, its device and the collective
    backend."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (ranks are row-major)."""
        names = list(self.shape)
        stride = math.prod(self.shape[a] for a in names[names.index(axis) + 1:])
        return self.rank // stride % self.shape[axis]


def parse_mesh_shape(text: str) -> Optional[Tuple[int, ...]]:
    """``--mesh_shape``'s comma ints, as the JAX CLI parses them; '' -> None."""
    return tuple(int(s) for s in text.split(",") if s) or None


def check_shape(shape: Sequence[int]) -> None:
    """Raise unless ``shape`` is a ``(1, M)`` ``(data, seq)`` mesh; a one-axis
    shape (JAX's data parallelism) or a ``data`` axis above 1 is not ported."""
    if len(shape) == 1 or (len(shape) == 2 and shape[0] > 1):
        raise NotImplementedError(f"mesh shape {tuple(shape)}: {NOT_PORTED}")
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"mesh shape {tuple(shape)}: the port runs a (data, seq) mesh")


def make_mesh(shape: Sequence[int], device: Optional[torch.device] = None) -> Mesh:
    """This rank's :class:`Mesh` over the initialised default process group,
    whose size must be ``prod(shape)``."""
    check_shape(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (see spawn)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh shape {tuple(shape)} over a world of {dist.get_world_size()}")
    return Mesh(shape=dict(zip(AXES, shape)), rank=dist.get_rank(),
                device=torch.device(device or "cpu"), backend=dist.get_backend())


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


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` stacked along a new first axis, on ``t``'s device
    (no autograd).  Under gloo the tensors go through the host."""
    n = mesh.shape["seq"]
    if mesh.backend == "nccl":
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.detach().contiguous())
        return out
    host = _host(t.shape, t)
    host.copy_(t.detach())
    parts = _host((n,) + tuple(t.shape), t)
    dist.all_gather(list(parts), host)
    return parts.to(t.device)


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of every rank's ``t``, on ``t``'s device, as a new tensor (no
    autograd).  Under gloo the tensor goes through the host."""
    if mesh.backend == "nccl":
        out = t.detach().clone()
        dist.all_reduce(out)
        return out
    host = _host(t.shape, t)
    host.copy_(t.detach())
    dist.all_reduce(host)
    return host.to(t.device)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, shape, device_type, backend, port, collective_s, queue, args):
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
        result = fn(make_mesh(shape, device), *args)
        queue.put((rank, result))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, shape: Sequence[int], device_type: str = "cuda",
          args: tuple = (), timeout_s: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``prod(shape)`` new processes, one per rank
    of a ``(data, seq)`` mesh of ``shape`` on this node, and return their
    results by rank.  ``fn`` and its results must pickle (a module-level
    function; numbers, strings, numpy arrays).

    Raises if a rank raises or dies, and after ``timeout_s`` seconds (None:
    no limit); a collective that waits longer than ``timeout_s`` or
    :data:`COLLECTIVE_TIMEOUT_S`, the smaller, fails its rank.  Every
    process is stopped either way."""
    import torch.multiprocessing as mp

    check_shape(shape)
    world = math.prod(shape)
    backend = choose_backend(device_type, world)
    print(f"mesh {dict(zip(AXES, shape))}: {world} ranks on {device_type} over {backend}",
          flush=True)
    queue = mp.get_context("spawn").SimpleQueue()
    collective_s = min(COLLECTIVE_TIMEOUT_S, timeout_s or COLLECTIVE_TIMEOUT_S)
    ctx = mp.start_processes(
        _rank_main, args=(fn, tuple(shape), device_type, backend, _free_port(), collective_s,
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
