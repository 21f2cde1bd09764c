"""Process meshes and batch sharding on ``torch.distributed``.

The counterpart of ``yoloface_tpu.parallel.mesh``, in PyTorch's idiom: one
process a device, NCCL between cards, gloo on the CPU (or between processes
that share one card).  JAX's 1-D ``("data",)`` mesh of devices becomes a
:class:`Mesh` of ranks; a batch sharded over it (``P("data")``) becomes a
:class:`ShardedBatch`, this rank's contiguous block of the global batch:
rank ``i`` of ``n`` holds rows ``[i*B/n, (i+1)*B/n)``.

  * :func:`init_distributed` joins the process group (``init_method``,
    ``world_size`` and ``rank`` given by the caller, as
    ``jax.distributed.initialize`` takes a coordinator) and returns the
    mesh over every rank; with no arguments and no group it is JAX's
    no-op: a world of one, with no process group and no collectives;
  * :func:`make_mesh` takes the first ``n`` ranks (``ValueError`` when
    there are fewer);
  * :func:`shard_batch` gives this rank its block of a host or device
    batch (a pytree of arrays: dicts, lists, tuples);
    :func:`global_batch_from_host_local` takes each rank's own frames as
    its block (the multi-host camera case);
  * :func:`replicate` broadcasts tensors, modules and plain values from
    rank 0 in place.

Rank ``r`` computes on ``cuda:(local_rank % device_count)``
(``LOCAL_RANK`` from the environment, else the rank), unless the caller
asks for the CPU.  On gloo, tensors on the card travel through host
copies; each rank's compute stays on its device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from yoloface_tpu_torch.core.precision import device_or_raise

DATA_AXIS = "data"
_DEVICE: Optional[torch.device] = None     # set by init_distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks, one device each; JAX's ``Mesh`` over processes.

    ``axis_names`` and ``shape`` as JAX's (``("data",)``, or
    ``("data", "sp")`` for spatial partitioning); ``ranks`` the global
    ranks in row-major order; ``rank`` this process's position in it
    (None when it holds no position); ``group`` the process group (None for
    a world of one without one)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    ranks: Tuple[int, ...]
    rank: Optional[int]
    device: torch.device
    group: Any = None
    backend: Optional[str] = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(name, 1)

    def coord(self, name: str) -> int:
        """This rank's coordinate on axis ``name`` (0 on an absent axis)."""
        if name not in self.axis_names:
            return 0
        return int(np.unravel_index(self.rank, self.shape)[
            self.axis_names.index(name)])

    @property
    def collective(self) -> bool:
        """Whether collectives run: in a process group, even of one rank
        (a world of one on NCCL still calls it)."""
        return self.group is not None

    def host(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor as the backend takes it: a host copy on gloo."""
        return t.cpu() if self.backend == "gloo" else t


def device_for_rank(local_rank: int, device="cuda") -> torch.device:
    """``cuda:(local_rank % device_count)`` for a CUDA device, else the
    device as given."""
    device = device_or_raise(device, "device_for_rank")
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *, device="cuda",
                     backend: Optional[str] = None,
                     timeout: float = 300.0) -> Mesh:
    """Join the process group and return the 1-D ``("data",)`` mesh over
    every rank.

    ``init_method`` is ``torch.distributed``'s (``tcp://host:port`` or
    ``file:///path``); the backend defaults to NCCL on the card and gloo
    on the CPU.  Called with no ``init_method`` it initialises nothing:
    the mesh of the group already joined, or a world of one (JAX's no-op
    initialize)."""
    global _DEVICE
    if init_method is not None and not dist.is_initialized():
        if world_size is None or rank is None:
            raise ValueError("init_distributed: pass world_size and rank "
                             "with init_method")
        local = int(os.environ.get("LOCAL_RANK", rank))
        _DEVICE = device_for_rank(local, device)
        if _DEVICE.type == "cuda":
            torch.cuda.set_device(_DEVICE)
        backend = backend or ("nccl" if _DEVICE.type == "cuda" else "gloo")
        dist.init_process_group(
            backend, init_method=init_method, world_size=int(world_size),
            rank=int(rank), timeout=datetime.timedelta(seconds=timeout),
            device_id=_DEVICE if backend == "nccl" else None)
    elif _DEVICE is None:
        _DEVICE = device_or_raise(device, "init_distributed")
    return make_mesh()


def world() -> Tuple[int, int]:
    """(world size, this rank): (1, 0) without a process group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _mesh(axis_names, shape, device=None) -> Mesh:
    need = int(np.prod(shape))
    n_world, me = world()
    if n_world < need:
        raise ValueError(f"need {need} devices, have {n_world}")
    if device is None:
        device = _DEVICE if _DEVICE is not None else "cuda"
    device = device_or_raise(device, "make_mesh")
    group = backend = None
    if dist.is_initialized():
        # every rank creates the subgroup, members or not (new_group's rule)
        group = (dist.group.WORLD if need == n_world
                 else dist.new_group(list(range(need))))
        backend = dist.get_backend()
    return Mesh(tuple(axis_names), tuple(int(s) for s in shape),
                tuple(range(need)), me if me < need else None, device, group,
                backend)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D data-parallel mesh over the first ``n_devices`` ranks (every
    rank by default)."""
    if n_devices is None:
        n_devices = world()[0]
    return _mesh((DATA_AXIS,), (n_devices,), device)


# --------------------------------------------------------------- batches
@dataclasses.dataclass
class ShardedBatch:
    """This rank's block ``local`` of a batch sharded over the data axis:
    rows ``[start, start + len(local))`` of ``global_size``."""

    local: torch.Tensor
    start: int
    global_size: int

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global shape, as a sharded ``jax.Array`` reports it."""
        return (self.global_size,) + tuple(self.local.shape[1:])


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


def batch_block(n: int, mesh: Mesh) -> Tuple[int, int]:
    """Rows ``[start, stop)`` of a global batch of ``n`` this rank holds;
    ``ValueError`` when the data axis does not divide ``n``."""
    dp = mesh.axis_size(DATA_AXIS)
    if n % dp:
        raise ValueError(f"global batch {n} not divisible by the data axis "
                         f"({dp} ranks)")
    per = n // dp
    start = mesh.coord(DATA_AXIS) * per
    return start, start + per


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh):
    """A global batch (a pytree of numpy arrays or tensors, every rank
    holding the same) -> this rank's :class:`ShardedBatch` of each, on the
    mesh's device."""
    def one(x):
        x = _as_tensor(x)
        start, stop = batch_block(x.shape[0], mesh)
        return ShardedBatch(x[start:stop].to(mesh.device), start,
                            x.shape[0])
    return _tree_map(one, batch)


def global_batch_from_host_local(local_batch, mesh: Mesh):
    """Each rank's own frames (a pytree of arrays) -> its block of the
    global batch they make together, in rank order: the multi-host
    analogue of :func:`shard_batch`.  Every rank must hold the same
    number of frames."""
    def one(x):
        x = _as_tensor(x)
        n = x.shape[0]
        counts = [n]
        if mesh.collective:
            counts = [None] * mesh.size
            dist.all_gather_object(counts, n, group=mesh.group)
        if len(set(counts)) != 1:
            raise ValueError(f"ranks hold different frame counts {counts}")
        return ShardedBatch(x.to(mesh.device), mesh.coord(DATA_AXIS) * n,
                            n * mesh.axis_size(DATA_AXIS))
    return _tree_map(one, local_batch)


def local_block(x, mesh: Mesh) -> torch.Tensor:
    """A :class:`ShardedBatch`'s block, or this rank's block of a global
    batch, on the mesh's device."""
    if isinstance(x, ShardedBatch):
        return x.local.to(mesh.device)
    return shard_batch(x, mesh).local


def global_size(x) -> int:
    return x.global_size if isinstance(x, ShardedBatch) else x.shape[0]


# ----------------------------------------------------------- collectives
def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the mesh in place (nothing to do on a world of
    one)."""
    if mesh.collective:
        h = mesh.host(t)
        dist.all_reduce(h, group=mesh.group)
        if h is not t:
            t.copy_(h)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over the mesh; its gradient is the sum of the ranks'
    gradients (``torch.distributed.nn.functional.all_reduce``'s rule,
    without that module's deprecation)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(t.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh), None


def all_reduce_autograd(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh, its gradient the sum of the
    gradients."""
    if not mesh.collective:
        return t
    return _AllReduceSum.apply(t, mesh)


def _broadcast_tensor(t: torch.Tensor, mesh: Mesh) -> None:
    h = mesh.host(t.detach())
    dist.broadcast(h, src=mesh.ranks[0], group=mesh.group)
    if h is not t:
        with torch.no_grad():
            t.copy_(h)


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's picklable value on every rank."""
    if not mesh.collective:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.group)
    return box[0]


def replicate(tree, mesh: Mesh):
    """Rank 0's tree on every rank: tensors, the parameters and buffers
    of a module, and dicts, lists and tuples of them are overwritten in
    place; other values (ints, floats) come back as rank 0's.  Returns the
    tree."""
    if not mesh.collective:
        return tree
    if isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            _broadcast_tensor(t, mesh)
        return tree
    if isinstance(tree, torch.Tensor):
        _broadcast_tensor(tree, mesh)
        return tree
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            tree[k] = replicate(tree[k], mesh)
        return tree
    if isinstance(tree, list):
        tree[:] = [replicate(v, mesh) for v in tree]
        return tree
    if isinstance(tree, tuple):
        return tuple(replicate(v, mesh) for v in tree)
    return broadcast_object(tree, mesh)


def barrier(mesh: Mesh) -> None:
    if mesh.collective:
        dist.barrier(group=mesh.group)


def ranks_of(mesh: Mesh, axis: str) -> Sequence[int]:
    """The global ranks that share every coordinate with this rank but
    ``axis``'s, in order along ``axis`` (this rank among them)."""
    idx = list(np.unravel_index(mesh.rank, mesh.shape))
    k = mesh.axis_names.index(axis)
    out = []
    for c in range(mesh.shape[k]):
        idx[k] = c
        out.append(mesh.ranks[int(np.ravel_multi_index(idx, mesh.shape))])
    return out
