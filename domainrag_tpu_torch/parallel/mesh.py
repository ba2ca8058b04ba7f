"""Process meshes over ``torch.distributed`` (port of
``domainrag_tpu/parallel/mesh.py``).

The JAX package scales out with one controller over a ``jax.sharding.Mesh``
of devices, and GSPMD or ``shard_map`` split the work. The port runs one
process per card, and a mesh is a grid of process ranks with a process
group per axis. The JAX mesh maps onto processes so:

- Without ``--distributed``, the processes launched together
  (``torchrun --nproc_per_node G``, one per card) form the mesh, as JAX's
  one process over ``jax.devices()`` does (its
  ``pipeline/orchestrator.py:74-92``). Every rank runs the same program
  over the same samples; each takes its share of the work from the mesh
  (a slice of the batch, its heads, its blocks, its bank rows) and the
  collectives put the results together, so every rank ends with the
  whole result. Rank 0 alone writes artifacts, and the file tree is the
  one a single-device run writes.
- A process that has no group runs on one card, as it always did: a mesh
  built there has one rank, and never one per ``torch.cuda.device_count()``.
- With ``--distributed``, each host is one worker over a disjoint sample
  slice: the processes of one host (torchrun's ``LOCAL_WORLD_SIZE``) are
  that worker's mesh, as JAX's multihost worker meshes its
  ``jax.local_devices()`` (``parallel.multihost.worker_mesh``).
  ``parallel.multihost.barrier`` and ``shared_timestamp`` go through the
  whole group.

The group is NCCL on cards and gloo on the CPU (where the tests run it).
An axis of size 1 needs no group: its collectives return their input.

Under autograd the collectives need a rule for their gradient, which
depends on what the ranks compute around them. :func:`reduce_from` and
:func:`copy_to` are Megatron's conjugate pair for tensor parallelism: the
sum of a row-sharded layer's partial outputs (all-reduce forward,
identity backward) and the replicated input of a column-sharded layer, or
a replicated weight used on the rank's own heads (identity forward,
all-reduce of the gradient backward). :func:`gather_from` all-gathers
with the reduce-scatter (:meth:`Mesh.reduce_scatter`) as its gradient:
FSDP's weight gather, where every rank's loss is a share of the whole.
The raw collectives of :class:`Mesh` refuse a tensor that requires
grad, so that no gradient goes through one unruled.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None) -> None:
    """Start this process's group: at ``coordinator`` (``host:port``, or a
    ``tcp://`` / ``file://`` address) with ``num_processes`` and
    ``process_id``, else from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``). Without either, and with a group
    already started, nothing happens: one process on one card. NCCL when
    ``device`` (default the card) is CUDA, pinned to ``LOCAL_RANK``'s
    card; gloo on the CPU. A failed start raises."""
    if dist.is_initialized():
        return
    from ..core import device as device_mod
    if coordinator is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return
        init, world, rank = ("env://", int(os.environ["WORLD_SIZE"]),
                             int(os.environ["RANK"]))
    else:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init, world_size=world,
                                rank=rank)
    else:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """A grid of process ranks with named axes (the JAX ``Mesh``):
    ``devices`` is the ndarray of global ranks, ``axis_names`` its axes.
    ``shape`` is a dict of axis sizes, as the JAX mesh's, so
    ``mesh.shape.get(axis, 1)`` reads the same. Each axis has this rank's
    process group (:meth:`group`, ``None`` for an axis of size 1) and this
    rank's place along it (:meth:`index`). Every process of the group must
    build every mesh, in the same order: ``torch.distributed.new_group``
    is collective."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d ranks for axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        world = _world()
        if self.devices.size > world:
            raise ValueError(
                f"a mesh of {self.devices.size} ranks needs a process group "
                f"of as many; this one has {world} (start the processes "
                "with torchrun, one per card, or pass --distributed)")
        me = _rank()
        where = np.argwhere(self.devices == me)
        self._coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups: Dict[str, Tuple[object, List[int]]] = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, i, -1).reshape(
                -1, self.devices.shape[i])
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if me in ranks:
                    self._groups[axis] = (group, ranks)
        # a mesh over part of the group (a worker's) fences and broadcasts
        # over its own ranks
        every = sorted(int(r) for r in self.devices.flat)
        self._all = (dist.new_group(every)
                     if 1 < len(every) < world else None)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def contains_me(self) -> bool:
        return self._coords is not None

    def index(self, axis: str) -> int:
        """This rank's place along ``axis`` (``jax.lax.axis_index``)."""
        if self._coords is None:
            raise ValueError(f"rank {_rank()} is not in {self}")
        return self._coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self._groups[axis][0]

    def ranks(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in order."""
        return self._groups[axis][1]

    def is_writer(self) -> bool:
        """True on the rank that writes the mesh's artifacts (rank 0)."""
        return _rank() == int(self.devices.flat[0])

    # -- collectives over one axis (the identity on an axis of size 1) --

    @staticmethod
    def _no_grad(x: torch.Tensor, what: str) -> None:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError(
                f"Mesh.{what} has no gradient rule: under autograd use "
                "parallel.mesh.reduce_from / copy_to / gather_from, "
                "whose rule states what the ranks compute")

    def all_reduce(self, x: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """The sum (or ``"max"``) of ``x`` over the ranks of ``axis``, on
        every one of them; reduces ``x`` in place when it is contiguous."""
        if self.shape[axis] == 1:
            return x
        self._no_grad(x, "all_reduce")
        x = x.contiguous()
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group(axis))
        return x

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in
        the axis's order (``jax.lax.all_gather`` then a reshape)."""
        n = self.shape[axis]
        if n == 1:
            return x
        self._no_grad(x, "all_gather")
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int = 0) -> torch.Tensor:
        """This rank's slice along ``dim`` of the sum of ``x`` over the
        ranks of ``axis`` (NCCL's reduce-scatter; gloo has none, so there
        an all-reduce and this rank's slice)."""
        n = self.shape[axis]
        if n == 1:
            return x
        self._no_grad(x, "reduce_scatter")
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} ({x.shape[dim]}) not divisible by "
                             f"{axis}={n}")
        piece = x.shape[dim] // n
        if dist.get_backend(self.group(axis)) == "nccl":
            x = x.movedim(dim, 0).contiguous()
            out = torch.empty((piece,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, x, group=self.group(axis))
            return out.movedim(0, dim)
        x = self.all_reduce(x.clone(), axis)
        return x.narrow(dim, self.index(axis) * piece, piece).contiguous()

    def broadcast(self, x: torch.Tensor, axis: str,
                  src: int = 0) -> torch.Tensor:
        """Rank ``src`` of ``axis``'s ``x`` on every rank of it (in place
        on the others' ``x``, which must have its shape)."""
        if self.shape[axis] == 1:
            return x
        self._no_grad(x, "broadcast")
        x = x.contiguous()
        dist.broadcast(x, src=self.ranks(axis)[src], group=self.group(axis))
        return x

    def exchange(self, axis: str, sends, recvs) -> List[torch.Tensor]:
        """One round of point-to-point transfers over ``axis``, posted
        together (``batch_isend_irecv``, so that a ring of sends cannot
        deadlock on NCCL's ordered streams): ``sends`` are (tensor, to)
        and ``recvs`` (like, frm) pairs of places along the axis, in an
        order that the peers' calls mirror. Returns the received tensors,
        in ``recvs``' order."""
        group, ranks = self.group(axis), self.ranks(axis)
        ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[to], group=group)
               for x, to in sends]
        got = [torch.empty_like(like, memory_format=torch.contiguous_format)
               for like, _ in recvs]
        ops += [dist.P2POp(dist.irecv, out, ranks[frm], group=group)
                for out, (_, frm) in zip(got, recvs)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got

    def broadcast_object(self, obj):
        """The mesh's rank 0's ``obj`` (picklable) on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=int(self.devices.flat[0]),
                                   group=self._all)
        return box[0]

    def barrier(self) -> None:
        """Fence every rank of the mesh."""
        if self.size > 1:
            dist.barrier(group=self._all)


# ---------------------------------------------------------------------------
# collectives with a gradient rule (Megatron's conjugate operators)
# ---------------------------------------------------------------------------

def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g.contiguous(), ctx.axis, ctx.dim),
                None, None, None)


def reduce_from(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Megatron's "reduce": the sum of ``x`` over ``axis`` (each rank's
    partial output of a row-sharded layer); the gradient passes through
    unchanged, since every rank's loss sees the whole sum."""
    if mesh.shape[axis] == 1:
        return x
    if not _wants_grad(x):
        return mesh.all_reduce(x, axis)
    return _Reduce.apply(x, mesh, axis)


def copy_to(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Megatron's "copy": ``x`` itself (a replicated input that each rank
    uses on its own share: a column-sharded layer's input, a norm weight
    applied to the rank's heads); the gradient is summed over ``axis``,
    since each rank's holds only its share's part."""
    if mesh.shape[axis] == 1 or not _wants_grad(x):
        return x
    return _Copy.apply(x, mesh, axis)


def gather_from(mesh, x: torch.Tensor, axis: str, dim: int = 0
                ) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim``; the
    gradient is this rank's slice of the gradients summed over ``axis``
    (a reduce-scatter): FSDP's gather of a weight that each rank then
    uses on its own rows of the batch."""
    if mesh.shape[axis] == 1:
        return x
    if not _wants_grad(x):
        return mesh.all_gather(x, axis, dim)
    return _Gather.apply(x, mesh, axis, dim)


def create_mesh(model_parallel: int = 1,
                devices: Optional[Sequence[int]] = None,
                data_axis: str = "data", model_axis: str = "model") -> Mesh:
    """(data, model) mesh over ``devices`` (global ranks; default every
    rank of the group, or this one process without a group).
    ``model_parallel`` must divide their count; data gets the rest."""
    devices = list(devices if devices is not None else range(_world()))
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by TP={model_parallel}")
    arr = np.asarray(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, (data_axis, model_axis))


class PartitionSpec(tuple):
    """The JAX ``PartitionSpec``: per dimension, the mesh axis it is split
    over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` on a mesh (the JAX ``NamedSharding``): which
    share of a tensor each rank takes."""
    mesh: Mesh
    spec: PartitionSpec


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Leading-dim sharding for batches of samples."""
    return NamedSharding(mesh, P(axis))


def local_rows(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's share of a whole ``x`` under a leading-dim
    ``sharding``: the rows of its place along the spec's axis, or all of
    ``x`` for ``P()``. Rows that do not divide over the axis raise, as
    JAX's ``device_put`` of such a batch does."""
    if not sharding.spec or sharding.spec[0] is None:
        return x
    axis = sharding.spec[0]
    n = sharding.mesh.shape.get(axis, 1)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows are not divisible over "
                         f"{axis}={n}")
    if n == 1:
        return x
    piece = x.shape[0] // n
    return x.narrow(0, sharding.mesh.index(axis) * piece, piece)
