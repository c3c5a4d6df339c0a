"""The ranks of a run as a device mesh, on ``torch.distributed``.

Counterpart of ``imagined_speech_decoding_tpu/parallel/mesh.py``. Where a
JAX mesh lays out the devices of one program, the port runs one process a
rank: a ``Mesh`` names the axes of a grid of ranks and holds one process
group per axis (the ranks that differ only in that axis's coordinate), over
NCCL for the card and gloo for the CPU. Three strategies, as in JAX:

  * ``model``: the (subject x fold) stack split over the ranks, each
    training its rows with no collective in the step;
  * ``data``: the stack on every rank and every model's batch split over
    the ranks, with the gradients, the batch-norm statistics and the
    metrics summed across them, so that the result is the unsharded one;
  * ``2d``: both, over a ``(model, data)`` grid.

``StackShard`` is how a stack of M models maps onto a mesh: the rows this
rank trains (the stack padded with replicas of its last model to a
multiple of the model axis), the columns of a batch it takes, and the
gathering of its rows back into the whole stack. Every collective here is
an ``all_reduce``, a ``broadcast`` or a ``barrier``, so the same code runs
on NCCL and on gloo with CUDA tensors (two ranks sharing one card).

JAX's ``batch_spec`` and ``replicated_spec`` return ``PartitionSpec``s,
which have no counterpart here (ROADMAP.md: decided non-ports).
"""

from __future__ import annotations

import contextlib
import os
import socket
import warnings
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..devices import require_device

STRATEGIES = ("model", "data", "2d")
TIMEOUT = timedelta(minutes=10)  # a collective that waits longer raises
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_LOCALHOST = ("localhost", "127.0.0.1")


def free_port() -> int:
    """A TCP port on localhost that is free now (for a rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_backend(backend: str) -> None:
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the NCCL backend was asked for, but this PyTorch has no NCCL")
    if backend == "gloo" and not dist.is_gloo_available():
        raise RuntimeError("the gloo backend was asked for, but this PyTorch has no gloo")


def _loopback(addr: str) -> None:
    """Ranks that meet on this host talk over the loopback interface."""
    if addr in _LOCALHOST:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")


def init_world(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the run's default process group, once, and return this rank's
    device. Under ``torchrun`` (its ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``) the ranks come from its
    environment; without it the world is this one process. ``backend``:
    NCCL for CUDA and gloo for the CPU unless named (gloo over CUDA tensors
    lets ranks share one card); every group of the run takes it. A CUDA
    rank takes card ``LOCAL_RANK`` (or its rank) modulo the cards visible,
    so ranks beyond the cards share them. A failed start raises, as does CUDA without a
    card."""
    device = require_device(device)
    if not dist.is_initialized():
        backend = backend or default_backend(device)
        _check_backend(backend)
        if all(k in os.environ for k in TORCHRUN_ENV):
            _loopback(os.environ["MASTER_ADDR"])
            dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        else:
            _loopback("localhost")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                    timeout=TIMEOUT)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _rank_main(rank: int, fn, world: int, port: int, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args) -> None:
    """Run ``fn(*args)`` in ``world`` new processes, the ranks of one run on
    this host, each with ``torchrun``'s environment (``init_world`` joins
    them); returns when all have ended, and raises if one failed. ``fn``
    must be importable (a module-level function)."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main, args=(fn, world, free_port(), args), nprocs=world,
                       start_method="spawn")


def is_lead() -> bool:
    """Whether this process writes results and prints: rank 0, or a run
    without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


class Mesh:
    """A grid of ranks: ``axis_names``, ``shape`` (row-major over ranks
    ``0 .. prod(shape) - 1``), this process's ``rank`` and ``device``, its
    coordinate on each axis, and ``groups``: each axis's process group
    holding this rank (None for a mesh made without one, e.g. to compute
    a shard's rows). A rank beyond the grid is no ``member``: it takes part
    in no group's work, as JAX leaves devices out of a mesh."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], rank: int,
                 device="cpu", groups: Optional[dict] = None, group=None):
        self.axis_names, self.shape = tuple(axis_names), tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} do not match shape {self.shape}")
        self.rank, self.device = rank, torch.device(device)
        self.member = rank < int(np.prod(self.shape))
        coords = np.unravel_index(rank, self.shape) if self.member else (0,) * len(self.shape)
        self.coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        self.groups = groups or {}
        self.group = group  # the whole grid's

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, rank={self.rank})"


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Tuple[int, ...]] = None,
              device="cuda") -> Mesh:
    """A mesh over the run's ranks (``init_world``): by default one axis
    over all of them; ``shape`` lays the first ``prod(shape)`` ranks out in
    row-major order. Every rank must call it, in the same order as the
    others (it makes the groups of every axis, on the world's backend)."""
    device = init_world(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    used = int(np.prod(shape))
    if used > world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {used} ranks; "
                         f"the world has {world}")
    backend = dist.get_backend()
    grid = np.arange(used).reshape(shape)
    groups = {}
    for ax, name in enumerate(axis_names):
        for line in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]):
            g = dist.new_group(line.tolist(), backend=backend, timeout=TIMEOUT)
            if rank in line:
                groups[name] = g
    whole = dist.new_group(list(range(used)), backend=backend, timeout=TIMEOUT)
    return Mesh(axis_names, shape, rank, device, groups, whole)


def _map_leaves(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` broadcast from the grid's rank 0 (in place;
    numpy leaves come back as new arrays)."""

    def bcast(v):
        t = torch.as_tensor(v, device=mesh.device)
        dist.broadcast(t, src=0, group=mesh.group)
        return t.cpu().numpy() if isinstance(v, np.ndarray) else t

    return _map_leaves(bcast, tree)


def _even_part(n: int, parts: int, i: int) -> Tuple[int, int]:
    """``[start, stop)`` of part ``i`` of ``n`` in ``parts`` contiguous
    pieces, the first ``n % parts`` one longer (``torch.tensor_split``)."""
    base, extra = divmod(n, parts)
    start = i * base + min(i, extra)
    return start, start + base + (i < extra)


def shard_leading_axis(mesh: Mesh, tree, axis_name: str = "data"):
    """This rank's slice of every leaf's leading axis, split over
    ``axis_name`` (which must divide it)."""
    k, i = mesh.size(axis_name), mesh.index(axis_name)

    def part(v):
        if v.shape[0] % k:
            raise ValueError(f"a leading axis of {v.shape[0]} does not split over {k} ranks")
        return v[i * (v.shape[0] // k):(i + 1) * (v.shape[0] // k)]

    return _map_leaves(part, tree)


class StackShard:
    """A stack of ``m_count`` models on ``mesh``: split over
    ``stack_axis`` (padded to a multiple of it with replicas of the last
    model; ``rows`` are this rank's ``[start, stop)`` of the padded
    stack) and each model's batch over ``data_axis`` (``batch_cols``).
    Either axis may be None."""

    def __init__(self, mesh: Mesh, m_count: int, stack_axis: Optional[str] = None,
                 data_axis: Optional[str] = None):
        self.mesh, self.m_count = mesh, m_count
        k = mesh.size(stack_axis) if stack_axis else 1
        self.m_padded = m_count + (-m_count) % k
        per, i = self.m_padded // k, (mesh.index(stack_axis) if stack_axis else 0)
        self.rows = (i * per, (i + 1) * per)
        self.stack_group = mesh.groups.get(stack_axis) if stack_axis else None
        self.stacked = stack_axis is not None and k > 1
        self.data_group = mesh.groups.get(data_axis) if data_axis else None
        self.data_size = mesh.size(data_axis) if data_axis else 1
        self.data_index = mesh.index(data_axis) if data_axis else 0
        self.split_batch = data_axis is not None

    @property
    def m_local(self) -> int:
        return self.rows[1] - self.rows[0]

    def row_index(self) -> np.ndarray:
        """This rank's rows as indices into the unpadded stack (padding
        rows repeat the last model)."""
        return np.minimum(np.arange(*self.rows), self.m_count - 1)

    def rows_of(self, tree):
        """This rank's rows of every leaf's leading (model) axis; leaves
        are numpy arrays or tensors, containers dicts, lists and tuples."""
        idx = self.row_index()

        def take(v):
            if isinstance(v, torch.Tensor):
                return v[torch.as_tensor(idx, device=v.device)]
            return np.asarray(v)[idx]

        return _map_leaves(take, tree)

    def batch_cols(self, b: int) -> Tuple[int, int]:
        """This rank's ``[start, stop)`` of a batch of ``b`` trials: even
        contiguous parts, so a batch shorter than the data axis leaves
        ranks with none."""
        return _even_part(b, self.data_size, self.data_index)

    def gather(self, t):
        """The whole stack (``m_count`` rows) from each rank's rows of
        ``t`` (a tensor, or a numpy array, which comes back as one): a
        zeroed buffer that each rank fills with its rows, summed over the
        stack axis."""
        if not self.stacked:
            return t
        if isinstance(t, np.ndarray):
            return self.gather(torch.as_tensor(t, device=self.mesh.device)).cpu().numpy()
        kind = t.dtype
        src = t.to(torch.uint8) if kind == torch.bool else t
        buf = torch.zeros((self.m_padded,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        buf[self.rows[0]:self.rows[1]] = src
        dist.all_reduce(buf, group=self.stack_group)
        buf = buf[: self.m_count]
        return buf.to(kind) if kind == torch.bool else buf


def shard_model_stack(mesh_axis: str, m_count: int, stacked_trees, replicated_trees=(),
                      mesh: Optional[Mesh] = None, device="cuda"):
    """``([this rank's rows of each stacked tree], [each replicated tree
    broadcast from rank 0], m_padded)``: the stacks padded to a multiple of
    ``mesh_axis`` with replicas of their last model, as JAX
    ``shard_model_stack`` places them. ``mesh``: an existing (possibly
    two-axis) mesh; else a new one-axis mesh over the world on ``device``."""
    if mesh is None:
        mesh = make_mesh((mesh_axis,), device=device)
    shard = StackShard(mesh, m_count, mesh_axis)
    return ([shard.rows_of(t) for t in stacked_trees],
            [replicate(mesh, t) for t in replicated_trees], shard.m_padded)


def mesh_shape(mesh_axis: str, n: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """``(axis names, shape)`` of a strategy over ``n`` ranks; '2d' is
    ``(max(n // 2, 1), 2 if n > 1 else 1)`` and warns when an odd count
    leaves a rank out."""
    if mesh_axis in ("model", "data"):
        return (mesh_axis,), (n,)
    if mesh_axis == "2d":
        shape = (max(n // 2, 1), 2 if n > 1 else 1)
        used = shape[0] * shape[1]
        if used < n:
            warnings.warn(
                f"mesh strategy '2d' uses {used} of {n} devices "
                f"(shape {shape}); an odd device count idles the rest — "
                "prefer --mesh model or an even slice",
                stacklevel=3,
            )
        return ("model", "data"), shape
    raise ValueError(f"unknown mesh strategy {mesh_axis!r} (use model/data/2d)")


# (strategy, device) -> (the default group a mesh was made in, the mesh)
_MESHES: dict = {}


def mesh_strategy(mesh_axis: Optional[str], device="cuda"):
    """A CLI strategy name as ``(mesh, stack_axis, data_axis)`` over the
    run's ranks (``init_world``): the mesh, the axis the model stack is
    split over (None under 'data') and the axis each model's batch is
    split over (None under 'model'); ``(None, None, None)`` for none. A
    strategy's mesh is made once in a run (the first call, which every
    rank makes) and served again after that."""
    if not mesh_axis:
        return None, None, None
    if mesh_axis not in STRATEGIES:
        raise ValueError(f"unknown mesh strategy {mesh_axis!r} (use model/data/2d)")
    device = init_world(device)
    names, shape = mesh_shape(mesh_axis, dist.get_world_size())
    world, mesh = _MESHES.get((mesh_axis, device), (None, None))
    if world is not dist.group.WORLD:  # none yet in this run
        mesh = make_mesh(names, shape, device)
        _MESHES[(mesh_axis, device)] = (dist.group.WORLD, mesh)
    return (mesh, "model" if "model" in names else None, "data" if "data" in names else None)


class _AllReduceSum(torch.autograd.Function):
    """A sum over ``group`` whose backward sums the cotangents over it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, differentiable: the gradient of a loss
    that every rank computes from the sum is the sum of their gradients."""
    return _AllReduceSum.apply(t, group)


def group_total(n: int, group, device) -> int:
    """The sum of an integer over ``group`` (each rank's share of a batch)."""
    t = torch.tensor([n], dtype=torch.int64, device=device)
    dist.all_reduce(t, group=group)
    return int(t.item())


def any_rank(flag: bool, group, device) -> bool:
    """Whether ``flag`` is set on any rank of ``group`` (every rank calls
    it: it is also a barrier)."""
    return group_total(int(flag), group, device) > 0


@contextlib.contextmanager
def fail_together(mesh: Optional[Mesh]):
    """Run a block on every rank of ``mesh`` (rank 0 writing files, say)
    and leave it on all of them together: if it raised on any rank, every
    rank raises (that one its own error) once all have left it, so none
    goes on into a collective that the others never join. ``None``: no
    mesh, and the block runs as it is."""
    err = None
    try:
        yield
    except BaseException as e:  # noqa: BLE001 -- re-raised below, after the vote
        err = e
    if mesh is not None and any_rank(err is not None, mesh.group, mesh.device) and err is None:
        raise RuntimeError("another rank of the mesh failed; this one stops with it")
    if err is not None:
        raise err


def all_reduce_flat_(tensors, group) -> None:
    """Sum ``tensors`` (one dtype and device) over ``group`` in place,
    in one collective over their flat concatenation."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
