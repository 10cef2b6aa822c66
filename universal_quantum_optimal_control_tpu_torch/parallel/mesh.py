r"""The ``(data, mc)`` mesh on ``torch.distributed`` (port of ``parallel/mesh.py``).

The JAX package drives every device of a mesh from one process and shards
arrays over it.  The PyTorch idiom is one process (rank) per cell of the
mesh: rank ``r`` sits at ``(data, mc) = divmod(r, mc)``, the layout of the
JAX package's ``np.reshape(devices, (data, mc))``.  A :class:`Mesh` holds
the rank's coordinates and two process groups: its *mc row* (the ranks that
share its data index, over which Monte-Carlo means reduce) and its *data
column* (the ranks that share its mc index, over which target rows gather).

The target batch is sharded over ``data`` and the disorder over
``(data, mc)``; :func:`shard_spec` cuts the rank's block of a tensor that
every rank holds whole.  The reductions :meth:`Mesh.all_mean` and
:meth:`Mesh.gather` give every rank the same value, and pass the gradient
straight through to the rank's own block, as each rank's gradient were that
of its block alone; the trainer then sums the parameters' gradients over
all ranks (:meth:`Mesh.all_reduce_many_`) and scales them by the
objective's ``grad_scale``.

Collectives use only ``all_reduce`` and ``broadcast``, which the gloo
backend supports on CUDA tensors as well as on CPU ones, so one code path
runs on gloo (the CPU, or ranks that share one card: NCCL refuses two
ranks on one device) and on NCCL (a card per rank).  Without an initialized
process group the mesh is the trivial 1 × 1 one and every collective is the
identity.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "mesh_shape", "DATA_AXIS", "MC_AXIS", "Mesh", "ShardSpec",
           "replicated", "shard_spec", "init_distributed", "default_backend",
           "rank_device", "mesh_from_flag"]

DATA_AXIS = "data"
MC_AXIS = "mc"
_AXES = (DATA_AXIS, MC_AXIS)


def default_backend(device="cuda", world_size: Optional[int] = None) -> str:
    """The backend for ranks on ``device``: ``"nccl"`` where it is a card
    and every rank of this host has one of its own, else ``"gloo"`` (the
    CPU, or ranks that share a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size or 1))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> Optional[str]:
    """Join the process group; returns its backend, or ``None`` where there
    is nothing to join.

    ``coordinator_address``: ``host:port`` (TCP), or an ``init_method`` URL
    such as ``file:///path/store``; ``None`` reads ``MASTER_ADDR`` and
    ``MASTER_PORT`` as ``torchrun`` sets them.  ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``.  The backend is
    :func:`default_backend` of the ranks' ``device``.  With every argument
    ``None`` and no launcher's environment this does nothing; an
    initialized group is kept as it is.
    """
    if dist.is_initialized():
        return dist.get_backend()
    from_env = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if coordinator_address is None and num_processes is None and not from_env:
        return None
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    backend = default_backend(device, world)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return backend


def rank_device(device: str = "cuda") -> torch.device:
    """The rank's device: ``cuda`` without an index becomes
    ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` defaults to the
    rank); anything else is returned as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not torch.cuda.is_available():
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def mesh_shape(n: int, data: Optional[int] = None,
               mc: Optional[int] = None) -> Tuple[int, int]:
    """The JAX package's factorization of ``n`` devices: with neither axis
    given, ``data`` is the largest power of two ≤ √n that divides n and
    ``mc`` the rest; one axis given, the other is n over it.  Raises
    ``ValueError("mesh {data}x{mc} != {n} devices")`` where they disagree."""
    if data is None and mc is None:
        data = 2 ** int(math.log2(max(int(math.sqrt(n)), 1)))
        while n % data != 0:
            data //= 2
        mc = n // data
    elif data is None:
        data = n // mc
    elif mc is None:
        mc = n // data
    if data * mc != n:
        raise ValueError(f"mesh {data}x{mc} != {n} devices")
    return data, mc


class _Replace(torch.autograd.Function):
    """Forward: ``value`` (a reduction of ``x`` over ranks); backward: the
    cotangent as it is (``x``'s gradient is that of the rank's block)."""

    @staticmethod
    def forward(ctx, x, value):
        return value

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gathered(torch.autograd.Function):
    """Forward: the gathered rows ``full``; backward: the cotangent's rows
    ``[lo, lo + n)``, those of ``x``."""

    @staticmethod
    def forward(ctx, x, full, lo):
        ctx.rows = (lo, x.shape[0])
        return full

    @staticmethod
    def backward(ctx, g):
        lo, n = ctx.rows
        return g[lo:lo + n], None, None


class Mesh:
    """One rank's view of a ``data × mc`` mesh: its coordinates, the process
    groups of its mc row and its data column, and the collectives the
    sharded objectives and the trainer need."""

    def __init__(self, data: int, mc: int) -> None:
        self.data, self.mc = data, mc
        self.distributed = dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        self.data_index, self.mc_index = divmod(self.rank, mc)
        self.backend = dist.get_backend() if self.distributed else None
        self._groups = {DATA_AXIS: None, MC_AXIS: None}
        if self.distributed:
            # every rank creates every group, in the same order
            for i in range(data):
                g = dist.new_group([i * mc + j for j in range(mc)])
                if i == self.data_index:
                    self._groups[MC_AXIS] = g
            for j in range(mc):
                g = dist.new_group([i * mc + j for i in range(data)])
                if j == self.mc_index:
                    self._groups[DATA_AXIS] = g

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MC_AXIS: self.mc}

    @property
    def size(self) -> int:
        return self.data * self.mc

    def __repr__(self) -> str:
        return (f"Mesh({self.data}x{self.mc}, rank {self.rank} at (data {self.data_index}, "
                f"mc {self.mc_index}), backend {self.backend})")

    # -- blocks ------------------------------------------------------------

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _as_axes(axes))

    def block(self, n: int, axis: str) -> slice:
        """The rank's block of ``n`` entries sharded over ``axis``; ``n``
        must divide by the axis' size, as JAX refuses uneven shards."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"an axis of {n} entries does not shard evenly over "
                             f"{axis!r} of size {size}")
        k = n // size
        lo = k * (self.data_index if axis == DATA_AXIS else self.mc_index)
        return slice(lo, lo + k)

    # -- collectives -------------------------------------------------------

    def _reduce_group(self, axes):
        axes = _as_axes(axes)
        if not self.distributed or self.axis_size(axes) == 1:
            return False, None
        if set(axes) == set(_AXES):
            return True, dist.group.WORLD
        return True, self._groups[axes[0]]

    def all_reduce_(self, x: torch.Tensor, axes=_AXES) -> torch.Tensor:
        """In-place sum of ``x`` over the ranks along ``axes``."""
        active, group = self._reduce_group(axes)
        if active:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    def all_mean(self, x: torch.Tensor, axes=_AXES) -> torch.Tensor:
        """The mean of ``x`` over the ranks along ``axes``, the same on each;
        the gradient passes to ``x`` as it is."""
        active, _ = self._reduce_group(axes)
        if not active:
            return x
        value = self.all_reduce_(x.detach().clone(), axes) / self.axis_size(axes)
        return _Replace.apply(x, value)

    def gather(self, x: torch.Tensor, axis: str = DATA_AXIS) -> torch.Tensor:
        """The rows of ``x`` from every rank along ``axis``, in mesh order,
        as one tensor on each; the gradient passes to ``x``'s own rows.

        gloo has no ``all_gather`` for CUDA tensors, so each rank writes its
        rows into a zero-filled buffer and the buffers are summed."""
        active, _ = self._reduce_group(axis)
        if not active:
            return x
        n = x.shape[0]
        lo = n * (self.data_index if axis == DATA_AXIS else self.mc_index)
        full = x.new_zeros((n * self.shape[axis],) + tuple(x.shape[1:]))
        full[lo:lo + n] = x.detach()
        return _Gathered.apply(x, self.all_reduce_(full, axis), lo)

    def all_reduce_many_(self, tensors: Sequence[torch.Tensor], scale: float = 1.0) -> None:
        """Each of ``tensors``, in place, summed over all ranks and times
        ``scale``, in one all-reduce of their concatenation."""
        if not self.distributed or self.size == 1 or not tensors:
            return
        _flat_(tensors, lambda flat: self.all_reduce_(flat).mul_(scale))

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite ``tensors`` on every rank with rank 0's, in place, in
        one broadcast of their concatenation."""
        if not self.distributed or self.size == 1 or not tensors:
            return
        _flat_(tensors, lambda flat: dist.broadcast(flat, src=0))


@torch.no_grad()
def _flat_(tensors: Sequence[torch.Tensor], op) -> None:
    """Apply the in-place collective ``op`` to the concatenation of
    ``tensors`` and copy the result back into them."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    op(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _as_axes(axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in _AXES:
            raise ValueError(f"unknown mesh axis {a!r} (want {DATA_AXIS!r} or {MC_AXIS!r})")
    return axes


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              mc: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, mc)`` mesh over the ranks of the process group.

    Every rank is one cell, so the mesh spans the world: ``n_devices``
    (default: the world size; 1 without a process group) and ``len(devices)``
    must equal it.  The factorization is :func:`mesh_shape`'s, the JAX
    package's, which favours the MC axis.  Of ``devices`` only the count is
    read: each rank picks its own device (:func:`rank_device`).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None:
        n = len(devices)
    else:
        n = world if n_devices is None else n_devices
    data, mc = mesh_shape(n, data, mc)
    if n != world:
        raise ValueError(f"mesh {data}x{mc} != {world} devices")
    return Mesh(data, mc)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Which mesh axis, if any, shards each leading dimension of a tensor;
    calling it on a tensor every rank holds whole returns the rank's block."""

    mesh: Mesh
    axes: Tuple[Optional[str], ...]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        index = tuple(slice(None) if a is None else self.mesh.block(x.shape[k], a)
                      for k, a in enumerate(self.axes))
        return x[index].contiguous() if index else x


def replicated(mesh: Mesh) -> ShardSpec:
    """Every rank holds the whole tensor."""
    return ShardSpec(mesh, ())


def shard_spec(mesh: Mesh, *axes: Optional[str]) -> ShardSpec:
    """Shard dimension k over ``axes[k]`` (``None``: not sharded)."""
    for a in axes:
        if a is not None:
            _as_axes(a)
    return ShardSpec(mesh, tuple(axes))


def mesh_from_flag(flag: Optional[str], device: str):
    """The training CLIs' ``--mesh data,mc``: join the launcher's process
    group (``torchrun``, or any launcher that sets ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``) with :func:`default_backend` of
    ``device``, build
    the mesh, and say so on rank 0.  Returns ``(mesh, the rank's device,
    whether this call started the group)``; ``(None, device, False)``
    without the flag.  Where the mesh is not the world size (no launcher:
    one process) it raises ``ValueError("mesh {data}x{mc} != {n} devices")``."""
    if not flag:
        return None, torch.device(device), False
    data, mc = (int(x) for x in flag.split(","))
    started = not dist.is_initialized()
    init_distributed(device=device)
    try:
        mesh = make_mesh(data=data, mc=mc)
    except ValueError:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        raise
    dev = rank_device(device)
    if mesh.rank == 0:
        print(f"mesh {data}x{mc} over {mesh.backend or 'one process'}; rank 0 on {dev}",
              flush=True)
    return mesh, dev, started
