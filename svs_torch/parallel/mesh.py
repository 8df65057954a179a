"""The data mesh as a ``torch.distributed`` process group (port of
``svs_tpu/parallel/mesh.py`` and of the single-process distributor of
``svs_tpu/parallel/multihost.py``).

svs_tpu's mesh is a 1-D array of devices, and XLA inserts every collective
from the sharding annotations.  Here the mesh is one process per device in
a process group, and each reduction over the batch axis is written out:

- :class:`Mesh` is one rank's view of the group: the process group, the
  rank, the size, this rank's device, the axis name and the hosts (the
  ``torchrun`` nodes, each a run of consecutive ranks of one size);
- :func:`make_mesh` joins ``torchrun``'s group (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``; the hosts from ``GROUP_RANK`` and
  ``LOCAL_WORLD_SIZE``), or makes a world of one;
  :func:`make_2d_mesh` views that group as a ``(data, model)`` mesh whose
  rows and columns are 1-D meshes of their own (:class:`Mesh2D`, for
  tensor parallelism);
- :func:`shard_batch` and :func:`global_batch_from_global` pad a global
  host batch with zero rows to a multiple of the size, append the 0/1
  ``weight`` and return this rank's contiguous block of rows;
- :func:`all_sum` is the batch-crossing sum: a differentiable all-reduce
  whose adjoint is the all-reduce of the upstream gradient;
- :func:`all_gather` puts the ranks' slices of a tensor back together, and
  its adjoint gives each rank its slice of the all-reduced gradient;
  :func:`gather_state` gathers a sharded state to the host, leaf by leaf;
- :func:`halo_exchange` gives each rank's block of a time-sharded
  activation its neighbours' edge columns (context parallelism,
  ``parallel/halo.py``), differentiably;
- :func:`agree` makes one host flag (a SIGTERM) the same on every rank.

Every collective here is an all-reduce or a broadcast, the two that NCCL
and gloo both run on CUDA tensors (two ranks on one card must use gloo).
So a gather is an all-reduce of zero-filled full tensors, each rank's
block written into its own: adding zeros is exact, so every rank holds
the same full tensor, at N times the bytes of a true all-gather over N
ranks.  A group of one rank crosses no rank: its sums are the local ones,
and the step then runs the single-device code and bits.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from svs_torch.utils.device import DeviceLike, resolve_device

# a collective that waits longer than this has lost a rank
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D data mesh."""
    group: object        # the torch.distributed process group
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"
    backend: str = "gloo"
    # a gloo group for host-side flags where the group is NCCL's
    host_group: Optional[object] = None
    # the hosts (svs_tpu's processes): runs of size // hosts consecutive
    # ranks, host h holding ranks h * local_size .. (h + 1) * local_size - 1
    hosts: int = 1

    @property
    def local_size(self) -> int:
        """The ranks of one host (svs_tpu's local devices)."""
        return self.size // self.hosts

    @property
    def host(self) -> int:
        """This rank's host (svs_tpu's ``process_index``)."""
        return self.rank // self.local_size

    @property
    def local_rank(self) -> int:
        """This rank's place among its host's ranks."""
        return self.rank % self.local_size

    @property
    def shape(self) -> Dict[str, int]:
        """svs_tpu's ``mesh.shape``: the axis name and its size."""
        return {self.axis_name: self.size}

    @property
    def is_primary(self) -> bool:
        """Rank 0 alone writes files (svs_tpu's ``is_primary``)."""
        return self.rank == 0

    @property
    def src(self) -> int:
        """The global rank of the group's rank 0 (a broadcast's source)."""
        return dist.get_global_rank(self.group, 0)


_host_groups: Dict[int, object] = {}


def _default_backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _local_device(dev: torch.device) -> torch.device:
    """``cuda`` without an index becomes ``cuda:LOCAL_RANK`` (modulo the
    card count, so that ranks may share one card)."""
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        return torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _host_layout(rank: int, size: int, group) -> int:
    """The hosts of the default group: ``torchrun``'s nodes, from its
    ``GROUP_RANK``, ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` (one host
    without them).  Checked once across the group with one all-reduce
    (the collective that gloo ranks sharing a card run): the ranks must be
    host-major, ``RANK == GROUP_RANK * LOCAL_WORLD_SIZE + LOCAL_RANK``,
    every host of one size; any other layout is refused on every rank."""
    env = os.environ if _torchrun() else {}
    local = int(env.get("LOCAL_WORLD_SIZE", size))
    host = int(env.get("GROUP_RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", rank - host * local))
    bad = int(local < 1 or not 0 <= local_rank < local
              or rank != host * local + local_rank)
    t = torch.tensor([local, -local, bad], dtype=torch.int64)
    if size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    if int(t[0]) != -int(t[1]) or int(t[2]) or size % local:
        raise ValueError(
            "the ranks must be host-major, RANK == GROUP_RANK * "
            "LOCAL_WORLD_SIZE + LOCAL_RANK, every host of one size: rank "
            f"{rank} of {size} has GROUP_RANK {host}, LOCAL_WORLD_SIZE "
            f"{local}, LOCAL_RANK {local_rank}, and the hosts' sizes run "
            f"from {-int(t[1])} to {int(t[0])}")
    return size // local


def world_size() -> int:
    """The ranks of the process group :func:`make_mesh` joins or makes,
    known before it does: the group's, ``torchrun``'s, or one."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if _torchrun() else 1


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", *,
              device: DeviceLike = None,
              backend: Optional[str] = None) -> Mesh:
    """The mesh of every rank of the default process group, joined or made
    here: under ``torchrun``'s environment the group it names (``env://``),
    its hosts from ``GROUP_RANK`` and ``LOCAL_WORLD_SIZE``
    (:func:`_host_layout`), else a world of one.  ``device``: ``cuda``
    (this rank's card, from ``LOCAL_RANK``) unless the caller asks for the
    CPU; ``backend``: NCCL on CUDA and gloo on the CPU unless asked
    otherwise.  ``n_devices``, if given, must be the group's size."""
    dev = _local_device(resolve_device(device))
    if not dist.is_initialized():
        backend = backend or _default_backend(dev)
        if _torchrun():
            dist.init_process_group(backend, init_method="env://",
                                    timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=TIMEOUT)
    have = dist.get_backend()
    if backend is not None and have != backend:
        raise ValueError(f"the process group runs {have}, not {backend}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} ranks, the process group "
                         f"has {size}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host = None
    if have != "gloo" and size > 1:
        # one gloo group a process group, made by every rank in turn
        key = id(dist.group.WORLD)
        if key not in _host_groups:
            _host_groups[key] = dist.new_group(backend="gloo")
        host = _host_groups[key]
    hosts = _host_layout(rank, size, host or dist.group.WORLD)
    return Mesh(dist.group.WORLD, rank, size, dev, axis_name, have, host,
                hosts)


@dataclasses.dataclass
class Mesh2D(Mesh):
    """One rank's view of a 2-D ``(data, model)`` mesh (svs_tpu
    ``tp.make_2d_mesh``): as a :class:`Mesh`, the whole world (its
    flags, files and broadcasts); ``data`` and ``model``, the 1-D meshes
    of this rank's column and row, which the collectives take.  Global
    rank ``d * n_model + m`` is data row ``d``, model rank ``m``.  The data
    mesh has the world's hosts where every model group lies within one
    host (``model_crosses_hosts`` false)."""
    data: Optional[Mesh] = None
    model: Optional[Mesh] = None

    @property
    def model_crosses_hosts(self) -> bool:
        """Whether a model group spans two hosts."""
        return self.local_size % self.model.size != 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.size, "model": self.model.size}


def _sub_mesh(world: Mesh, groups: List[List[int]], axis_name: str,
              hosts: int = 1) -> Mesh:
    """This rank's 1-D mesh among ``groups`` (disjoint lists of global
    ranks that cover the world), of ``hosts`` hosts: every rank makes
    every group, in one order, as ``dist.new_group`` needs; a group of the
    whole world is the world's, and one of a single rank crosses nothing
    and needs none."""
    mine = next(g for g in groups if world.rank in g)
    if len(mine) == world.size:
        group = world.group
    elif len(mine) == 1:
        group = None
    else:
        made = [dist.new_group(g) for g in groups]
        group = made[groups.index(mine)]
    return Mesh(group, mine.index(world.rank), len(mine), world.device,
                axis_name, world.backend, hosts=hosts)


def make_2d_mesh(n_data: int, n_model: int, *, device: DeviceLike = None,
                 backend: Optional[str] = None) -> Mesh2D:
    """The ``(data, model)`` mesh of the default process group
    (:func:`make_mesh`'s, joined or made here), data-major: the ranks of
    one model group are contiguous, as svs_tpu's process-major order
    keeps a model axis within a host.  The group must have exactly
    ``n_data * n_model`` ranks: a rank cannot sit idle as a spare JAX
    device does."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh dims must be positive, got "
                         f"({n_data}, {n_model})")
    world = make_mesh(device=device, backend=backend)
    if world.size != n_data * n_model:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the process group has "
                         f"{world.size}")
    rows = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    cols = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
    # a model group within one host keeps each host's ranks whole data
    # rows, so the data axis spans the hosts
    within = world.local_size % n_model == 0
    return Mesh2D(**{f.name: getattr(world, f.name)
                     for f in dataclasses.fields(Mesh)},
                  data=_sub_mesh(world, cols, "data",
                                 world.hosts if within else 1),
                  model=_sub_mesh(world, rows, "model"))


def crosses(group: Optional[Mesh]) -> bool:
    """Whether a reduction over ``group``'s batch crosses ranks."""
    return group is not None and group.size > 1


def host_collectives(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh``'s collectives run on the host while its tensors lie
    on a CUDA device: gloo across ranks (ranks that share one card, which
    NCCL refuses).  No CUDA graph can hold such a collective."""
    return (crosses(mesh) and mesh.device.type == "cuda"
            and mesh.backend == "gloo")


class _AllSum(torch.autograd.Function):
    """All-reduce SUM whose adjoint is the all-reduce SUM of the upstream
    gradient: every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, differentiably; ``x`` itself
    when the group is None or of one rank.

    The gradient rule: every rank computes the same global loss ``L`` from
    such sums, so backpropagating ``L`` on every rank and summing the
    parameter gradients over the ranks gives ``size * dL/dparams`` (the
    adjoint sums the ``size`` equal upstream gradients).  The DP step
    backpropagates ``L / size`` (``dp.dp_loss_and_grads``)."""
    if not crosses(group):
        return x
    return _AllSum.apply(x, group.group)


class _AllGather(torch.autograd.Function):
    """The ranks' slices of a tensor along ``dim``, put back together (a
    zero-padded all-reduce); the adjoint all-reduces the upstream gradient
    and returns this rank's slice of it."""

    @staticmethod
    def forward(ctx, shard, dim, mesh, reduced):
        ctx.dim, ctx.mesh, ctx.reduced = dim, mesh, reduced
        return _gather(shard, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        if ctx.reduced is not None:
            ctx.reduced.append(g)
        return (local_block(g, ctx.dim, ctx.mesh).contiguous(), None, None,
                None)


def local_block(full: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``full`` along ``dim`` (a view)."""
    k = full.shape[dim] // mesh.size
    return full.narrow(dim, mesh.rank * k, k)


def _gather(shard: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    shape = list(shard.shape)
    shape[dim] *= mesh.size
    full = shard.new_zeros(shape)
    with torch.no_grad():
        local_block(full, dim, mesh).copy_(shard)
    dist.all_reduce(full, group=mesh.group)
    return full


def all_gather(shard: torch.Tensor, dim: int, mesh: Optional[Mesh],
               reduced: Optional[List[torch.Tensor]] = None
               ) -> torch.Tensor:
    """The full tensor whose block ``rank`` along ``dim`` is each rank's
    ``shard`` (every rank's of one shape), the same bits on every rank;
    ``shard`` itself in a world of one.  Differentiable: every rank
    backpropagates ``L / size`` (``dp.dp_loss_and_grads``' gradient rule),
    so the adjoint's all-reduce of the upstream gradient is ``dL/dfull``,
    and this rank's slice of it is the gradient of its shard.  ``reduced``,
    if given, receives that all-reduced full gradient in the backward."""
    if not crosses(mesh):
        return shard
    return _AllGather.apply(shard, dim, mesh, reduced)


def _edges(x: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's two edges of ``h`` time columns (dim 3): a zero-filled
    (size, 2, B, C, F, h) buffer whose row ``rank`` holds this rank's
    ``(x[..., :h], x[..., -h:])``, all-reduced.  Adding zeros is exact."""
    buf = x.new_zeros((mesh.size, 2) + tuple(x.shape[:3]) + (h,))
    with torch.no_grad():
        buf[mesh.rank, 0].copy_(x[..., :h])
        buf[mesh.rank, 1].copy_(x[..., -h:])
    dist.all_reduce(buf, group=mesh.group)
    return buf


class _Halo(torch.autograd.Function):
    """The halo exchange over ranks that hold contiguous time blocks; the
    adjoint adds each halo column's gradient back onto the edge column of
    the rank that owns it."""

    @staticmethod
    def forward(ctx, x, h, mesh):
        ctx.h, ctx.mesh = h, mesh
        buf = _edges(x, h, mesh)
        r, zero = mesh.rank, x.new_zeros(tuple(x.shape[:3]) + (h,))
        left = buf[r - 1, 1] if r > 0 else zero
        right = buf[r + 1, 0] if r < mesh.size - 1 else zero
        return torch.cat([left, x, right], dim=3)

    @staticmethod
    def backward(ctx, g):
        h, mesh, r = ctx.h, ctx.mesh, ctx.mesh.rank
        # row r of the buffer: the gradients of this rank's halo columns,
        # which belong to the left neighbour's right edge and the right
        # neighbour's left edge
        buf = _edges(g, h, mesh)
        gx = g[..., h:-h].clone()
        if r > 0:
            gx[..., :h] += buf[r - 1, 1]
        if r < mesh.size - 1:
            gx[..., -h:] += buf[r + 1, 0]
        return gx, None, None


def halo_exchange(x: torch.Tensor, h: int, mesh: Optional[Mesh]
                  ) -> torch.Tensor:
    """``x`` (B, C, F, T_loc), this rank's contiguous block of the time
    axis, with ``h`` columns from each neighbouring rank on either side:
    (B, C, F, T_loc + 2h), zeros at the ends of the song (svs_tpu
    halo.py:61).  A world of one (or no mesh) zero-pads.  Differentiable:
    the adjoint is the exact transpose (no ``L / size`` scaling), each
    halo column's gradient added onto the edge column it came from.

    One all-reduce of a (size, 2, B, C, F, h) buffer delivers every
    neighbour's edges, as :func:`all_gather` is written on all-reduce:
    the one collective that gloo ranks sharing a card run beside NCCL's.
    ``h`` must not exceed ``T_loc``."""
    if not crosses(mesh):
        return torch.nn.functional.pad(x, (h, h))
    if not 0 < h <= x.shape[3]:
        raise ValueError(f"a halo of {h} needs 1 <= h <= T_loc "
                         f"({x.shape[3]})")
    return _Halo.apply(x, h, mesh)


def gather_state(leaves: Iterable[Tuple[torch.Tensor, Optional[int]]],
                 mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Host copies of the full tensors of ``(tensor, dim)`` leaves: a leaf
    with a ``dim`` is this rank's slice along it and is gathered, one
    leaf at a time so that the device holds one full leaf beyond the
    state; a leaf without one is held whole (svs_tpu multihost.py:251-275).
    A collective: every rank calls it at the same point with the same
    leaves, before rank 0 writes."""
    out = []
    with torch.no_grad():
        for t, dim in leaves:
            full = t if dim is None else all_gather(t.detach(), dim, mesh)
            out.append(full.detach().to("cpu", copy=True))
    return out


def agree(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True on every rank when it is true on any: a flag that one rank
    acts on alone would leave the others in a collective forever."""
    if not crosses(mesh):
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=mesh.host_group or mesh.group)
    return bool(t.item())


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


def rows_block(batch, lo: int, per: int, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """Rows ``lo .. lo + per`` of every array of ``batch``, past its end
    zero rows, as float32 on ``device``."""
    out = {}
    for k, v in batch.items():
        own = _as_tensor(v)[lo:lo + per]
        if own.shape[0] < per:
            own = torch.cat([own, own.new_zeros((per - own.shape[0],)
                                                + tuple(own.shape[1:]))])
        out[k] = own.to(device=device, dtype=torch.float32)
    return out


def _block(mesh: Mesh, batch, n_rows: int, weight) -> Dict[str,
                                                           torch.Tensor]:
    """This rank's contiguous block of ``n_rows // size`` rows of the batch
    (and ``weight``), past its end zero rows, as float32 on the mesh's
    device."""
    per = n_rows // mesh.size
    return rows_block(dict(batch, weight=weight), mesh.rank * per, per,
                      mesh.device)


def _rows(batch) -> int:
    return int(next(iter(batch.values())).shape[0])


def shard_batch(mesh: Mesh, batch) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (numpy arrays or tensors, the
    same on every rank): zero rows pad the batch to a multiple of the
    mesh's size, and the ``weight`` 0/1 vector marks the real rows, so the
    weighted reductions give the unpadded batch's loss, gradients and
    BatchNorm statistics (svs_tpu mesh.py:42-69)."""
    b = _rows(batch)
    padded = -(-b // mesh.size) * mesh.size
    weight = np.zeros(padded, np.float32)
    weight[:b] = 1.0
    return _block(mesh, {k: v for k, v in batch.items() if k != "weight"},
                  padded, weight)


def global_batch_from_global(mesh: Mesh, batch,
                             pad_rows_to: Optional[int] = None
                             ) -> Dict[str, torch.Tensor]:
    """The validation distributor (svs_tpu multihost.py:78-118, one
    process): a batch every rank holds in full, padded with zero rows to
    ``max(rows, pad_rows_to)`` rounded up to the size, its own ``weight``
    (ones if absent) extended with zeros; this rank's block of it.  A fixed
    ``pad_rows_to`` gives a remainder batch the full batches' shape."""
    batch = dict(batch)
    b = _rows(batch)
    padded = -(-max(b, pad_rows_to or 0) // mesh.size) * mesh.size
    weight = batch.pop("weight", None)
    weight = (np.ones(b, np.float32) if weight is None
              else _as_tensor(weight).float().cpu().numpy())
    weight = np.concatenate([weight, np.zeros(padded - b, np.float32)])
    return _block(mesh, batch, padded, weight)
