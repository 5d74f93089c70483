"""The port's device mesh and its collectives, over ``torch.distributed``.

``repro`` spreads this over ``repro.shardmap`` (meshes, the ambient mesh)
and the ``jax.lax`` collectives its ``shard_map`` bodies call.  Here one
process runs per device (a rank), a :class:`Mesh` names the ranks' axes
(``"pod"``, ``"data"``, ``"model"``) over a
``torch.distributed.device_mesh.DeviceMesh``, and the collectives keep
JAX's semantics:

=====================================  =====================================
here                                   ``jax.lax``
=====================================  =====================================
``all_gather(x, axes, dim, tiled)``    ``all_gather(x, axes, axis=dim,
                                       tiled=tiled)``
``reduce_scatter(x, axes, dim)``       ``psum_scatter(x, axes,
                                       scatter_dimension=dim, tiled=True)``
``all_to_all(x, axes, split_dim,       ``all_to_all(..., tiled=True)``
concat_dim)``
``psum`` / ``pmean`` / ``pmax`` /      the same names (``pmin`` of ``jnp``
``pmin``                               reductions)
``ppermute(x, axis, perm)``            ``ppermute``: a rank nobody sends to
                                       gets zeros
``Mesh.axis_index`` / ``axis_size``    ``axis_index`` / ``psum(1, axes)``
=====================================  =====================================

``all_gather``, ``reduce_scatter``, ``all_to_all``, ``ppermute`` and
``psum`` / ``pmean`` are differentiable; their backward is JAX's
transpose: a tiled ``all_gather``'s is the ``reduce_scatter`` of the
cotangent (a stacked one's the same over the stacking axis), a
``reduce_scatter``'s the tiled ``all_gather``, the reverse
``all_to_all``, the inverse permutation, and ``psum`` again.
Collectives over several axes order the ranks row-major over the axes
in mesh order, as JAX's do.

This is the only module of the port that calls ``torch.distributed``.
The backend is chosen in one place, :func:`backend_for`, from the ranks
that share this rank's host: ``"nccl"`` when each of them has a card of
its own, ``"gloo"`` on the CPU or when several ranks share a card.  A
failed init raises: there is no fallback to another backend or to the
CPU.  Gloo refuses CUDA tensors in point-to-point sends and receives, so
under gloo the ops in :data:`STAGED_OPS` copy their payload through host
memory and back; the compute stays on the card (:func:`staged_ops` says
what a group stages).

A collective over an axis of one rank is the identity and is elided, as
XLA elides it; inside :func:`through_group` it runs through the group all
the same, which checks a group's transport at world size 1.  :data:`issued`
counts the ops this process hands to ``torch.distributed``.

A :class:`CountingMesh` has a :class:`Mesh`'s axes and one rank's
place on them (rank 0 by default) and no process group: it stands for a
mesh of 256 or 512 ranks that exists only to be counted on ``meta``.  On
it every collective returns an output of the right shape and dtype and
calls nothing of ``torch.distributed``; it refuses any tensor that is not
on ``meta``, so that its made-up values never pass for real ones.

On either mesh each collective, forward and backward, reports its bytes
to the active :class:`repro_torch.analysis.count.Counter`, by ``repro``'s
convention (``analysis/hlo.py``): an all-gather the bytes of its result,
a reduce-scatter, an all-reduce (``psum``, ``pmax``, ``pmin``), an
all-to-all and a ``ppermute`` (XLA's collective-permute) those of their
operand.  The bytes are counted per call, the same on every rank whatever
its part in a permute, so rank 0 stands for every rank.  An elided
collective counts nothing.  Both meshes allocate a collective's result
the same way; what moves the payload between ranks
(``torch.distributed``'s ops, gloo's staging through host memory) runs
under :func:`repro_torch.analysis.count.transport`, unseen by the
counter, so a rank counts op for op what the counting mesh counts.

Beside the data group, :func:`init` makes one gloo group, the control
channel: :func:`broadcast_object` sends a pickled host object from rank 0
over it (a served engine call's record, for instance), so that it neither
needs a CUDA tensor under NCCL nor waits behind a frontier exchange.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import math
import os
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

from repro_torch.analysis import count

# Ops whose payload crosses a gloo group through host memory when it lies
# on a card: gloo's send / recv take host tensors only (every other op it
# takes on the card, checked on an H100 with torch 2.11).
STAGED_OPS = ("ppermute",)

# The ops handed to ``torch.distributed`` in this process, by kind
# ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "send",
# "recv", "broadcast_object"); the caller clears it.
issued: collections.Counter = collections.Counter()


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading dimension of
    a leaf, ``None`` (whole), an axis name or a tuple of axis names (split
    over their ranks, row-major in mesh order)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def entry_axes(entry) -> tuple[str, ...]:
    """A spec entry's axis names (``()`` for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def filter_spec(spec: PartitionSpec, names: Sequence[str]) -> PartitionSpec:
    """``spec`` with the axes that are not in ``names`` dropped (an entry
    left with none is None)."""
    def keep(entry):
        if isinstance(entry, str):
            return entry if entry in names else None
        kept = tuple(a for a in entry_axes(entry) if a in names)
        return kept if kept else None

    return PartitionSpec(*(keep(e) for e in spec))


def axis_sizes(mesh: "Mesh | None") -> dict[str, int]:
    """``mesh``'s axis sizes by name (``{}``: no mesh)."""
    return dict(mesh.shape) if mesh is not None else {}


def local_shape(shape: Sequence[int], spec: PartitionSpec,
                sizes: dict[str, int]) -> tuple[int, ...]:
    """The shape of a rank's slice of a leaf of ``shape`` split by
    ``spec`` over a mesh of axis ``sizes`` (``{}``: no mesh).  Raises
    when a dimension does not split evenly."""
    out = list(shape)
    for d, entry in enumerate(filter_spec(spec, tuple(sizes))):
        if entry is None:
            continue
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry} ({n} ranks)")
        out[d] //= n
    return tuple(out)


def split_axes(spec: PartitionSpec, mesh: "Mesh") -> tuple[str, ...]:
    """The axes of ``mesh`` that a leaf of ``spec`` is split over, in
    mesh order."""
    named = {a for e in spec for a in entry_axes(e)}
    return tuple(a for a in mesh.axis_names if a in named)


INIT_TIMEOUT_S = 300       # a collective that waits longer raises
# How long a rank waits on the control channel: a follower waits there
# for the next record while its service is idle.  A rank that exits
# closes its sockets, so a dead peer still raises at once.
CHANNEL_TIMEOUT_S = 7 * 24 * 3600

_CHANNEL = None            # the control channel's gloo group

_MESH: contextvars.ContextVar["Mesh | None"] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_THROUGH: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_through_group", default=False)


# --------------------------------------------------------------------------
# Process group
# --------------------------------------------------------------------------


def backend_for(device_type: str, local_world_size: int,
                cards: int | None = None) -> str:
    """The backend of a group whose ranks run ``local_world_size`` to a
    host on ``device_type``: ``"nccl"`` when each of them has a card of
    its own (``cards``: the host's, by default
    ``torch.cuda.device_count()``), else ``"gloo"`` (NCCL refuses two
    ranks on one device).  The ranks on other hosts do not count: each
    host has its own cards."""
    if cards is None:
        cards = torch.cuda.device_count()
    if device_type == "cuda" and local_world_size <= cards:
        return "nccl"
    return "gloo"


def init(rank: int, world_size: int, init_method: str, *,
         device_type: str = "cuda", local_rank: int | None = None,
         local_world_size: int | None = None) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` and return this
    rank's device: ``cuda:<local_rank % cards>`` or the CPU.
    ``local_rank`` / ``local_world_size``: this rank's index among the
    ranks of its host and their number (default: every rank on this
    host).  Raises on any failure (no backend or device fallback)."""
    import datetime

    if local_rank is None:
        local_rank = rank
    if local_world_size is None:
        local_world_size = world_size
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("comm.init(device_type='cuda') needs a card")
    backend = backend_for(device_type, local_world_size)
    if device_type == "cuda":
        device = torch.device("cuda",
                              local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S), **kwargs)
    global _CHANNEL
    _CHANNEL = dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=CHANNEL_TIMEOUT_S))
    return device


_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT")


def init_from_env(device_type: str = "cuda") -> torch.device:
    """:func:`init` from torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    for name in _TORCHRUN_VARS:
        if name not in os.environ:
            raise RuntimeError(
                f"{name} is not set: launch with torchrun --nproc-per-node N")
    return init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                "env://", device_type=device_type,
                local_rank=int(os.environ["LOCAL_RANK"]),
                local_world_size=int(os.environ["LOCAL_WORLD_SIZE"]))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def backend() -> str | None:
    """The group's backend name, or None without a group."""
    return dist.get_backend() if is_initialized() else None


def staged_ops(device: torch.device) -> tuple[str, ...]:
    """The ops that stage their payload through host memory in this
    group, for tensors on ``device``: :data:`STAGED_OPS` under gloo on a
    card, none under NCCL or on the CPU (or without a group)."""
    if backend() == "gloo" and torch.device(device).type == "cuda":
        return STAGED_OPS
    return ()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _CHANNEL
    if is_initialized():
        dist.destroy_process_group()
    _CHANNEL = None


@contextlib.contextmanager
def through_group() -> Iterator[None]:
    """Inside the block, a collective over an axis of one rank runs
    through the process group instead of being elided (a ``ppermute``
    there still copies locally: a rank sends nothing to itself).  The
    forward decides: a backward goes through the group wherever its
    forward did (autograd runs it on threads of its own)."""
    token = _THROUGH.set(True)
    try:
        yield
    finally:
        _THROUGH.reset(token)


def _elided(mesh: "Mesh", axes) -> bool:
    """Whether a collective over ``axes`` is the identity and skipped."""
    return mesh.axis_size(axes) == 1 and not _THROUGH.get()


def broadcast_object(obj=None, src: int = 0):
    """Rank ``src``'s ``obj`` (any picklable host object; the other ranks
    pass nothing) on every rank, over the control channel.  Without a
    group, or over one rank outside :func:`through_group`, it returns
    ``obj``."""
    if not is_initialized() or (world_size() == 1 and not _THROUGH.get()):
        return obj
    if _CHANNEL is None:
        raise RuntimeError("no control channel: join the group with "
                           "comm.init / comm.init_from_env")
    box = [obj if rank() == src else None]
    issued["broadcast_object"] += 1
    dist.broadcast_object_list(box, src=src, group=_CHANNEL)
    return box[0]


# --------------------------------------------------------------------------
# Mesh
# --------------------------------------------------------------------------


class Mesh:
    """Named axes over every rank of the group, row-major (rank ``r`` sits
    at ``unravel(r, shape)``), as ``jax.make_mesh`` lays devices out.

    ``device_mesh`` is the ``torch.distributed`` ``DeviceMesh`` of the same
    layout; a group for every non-empty set of axes is made up front (all
    ranks must create groups together)."""

    counting = False           # a CountingMesh's collectives send nothing

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_type: str = "cuda") -> None:
        from torch.distributed.device_mesh import DeviceMesh

        if not is_initialized():
            raise RuntimeError("Mesh needs an initialised process group "
                               "(comm.init / comm.init_from_env)")
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        if math.prod(shape) != world_size():
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{math.prod(shape)} ranks; the group has "
                             f"{world_size()}")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.device_mesh = DeviceMesh(
            device_type, torch.arange(world_size()).reshape(shape),
            mesh_dim_names=axis_names)
        self.coords = dict(zip(axis_names, torch.unravel_index(
            torch.tensor(rank()), shape)))
        self.coords = {a: int(c) for a, c in self.coords.items()}
        self._groups: dict[tuple[str, ...], object] = {}
        for n_axes in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, n_axes):
                self._groups[axes] = self._make_group(axes)

    def _make_group(self, axes: tuple[str, ...]):
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        grid = torch.arange(world_size()).reshape(tuple(self.shape.values()))
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        # One group per point of the other axes, ranks row-major in ``axes``.
        rows = grid.permute(*rest, *keep).reshape(-1, math.prod(
            self.shape[a] for a in axes))
        mine = None
        for ranks in rows.tolist():
            group = dist.new_group(ranks)
            if rank() in ranks:
                mine = group
        return mine

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes(self, axes: str | Sequence[str] | None) -> tuple[str, ...]:
        """``axes`` as a tuple in mesh order (None: every axis)."""
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not in mesh "
                                 f"{self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} must follow the mesh order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes: str | Sequence[str] | None = None) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes: str | Sequence[str] | None = None) -> int:
        """This rank's row-major index over ``axes``."""
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: str | Sequence[str] | None = None):
        return self._groups[self.axes(axes)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


class CountingMesh(Mesh):
    """A mesh that exists only to be counted: ``shape`` over
    ``axis_names``, as :class:`Mesh` lays ranks out, seen from rank
    ``rank`` (0 by default), with no process group.  Its collectives
    (:data:`counting`) make outputs of the right shape and dtype on
    ``meta`` and report their bytes; they send nothing and refuse any
    tensor that is not on ``meta``."""

    counting = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0) -> None:
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axes {axis_names} differ "
                             "in length")
        if not 0 <= rank < math.prod(shape):
            raise ValueError(f"rank {rank} is not in a mesh of "
                             f"{math.prod(shape)} ranks")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.rank = rank
        self.coords = {a: int(c) for a, c in zip(axis_names, (
            torch.unravel_index(torch.tensor(rank), shape)))}

    def group(self, axes=None):
        raise RuntimeError("a CountingMesh has no process group")

    def __repr__(self) -> str:
        return f"CountingMesh({self.shape}, rank={self.rank})"


@contextlib.contextmanager
def mesh_scope(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh`` the ambient mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_mesh() -> Mesh | None:
    """The ambient mesh, or None outside :func:`mesh_scope` or, for a
    :class:`Mesh` of ranks, without a process group (``repro``'s
    ``get_abstract_mesh``).  A :class:`CountingMesh` needs no group."""
    mesh = _MESH.get()
    if mesh is None or not (mesh.counting or is_initialized()):
        return None
    return mesh


def _mesh(mesh: Mesh | None, x: torch.Tensor | None = None) -> Mesh:
    """``mesh``, else the ambient one; on a :class:`CountingMesh` ``x``
    must lie on ``meta``."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: pass mesh= or run under mesh_scope")
    if mesh.counting and x is not None and x.device.type != "meta":
        raise ValueError(f"a CountingMesh takes tensors on meta only, got "
                         f"one on {x.device}: its collectives make up "
                         f"their outputs")
    return mesh


# repro's names of the collectives (XLA's opcodes), by the port's op.
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "ppermute": "collective-permute"}


def _report(op: str, t: torch.Tensor, parts: int = 1) -> None:
    """One ``op`` call's bytes to the active counter, if any: those of
    ``t`` (its operand), times ``parts`` (an all-gather's result)."""
    c = count.active()
    if c is not None:
        c.add_collective(KINDS[op], parts * t.numel() * t.element_size(),
                         f"{str(t.dtype).replace('torch.', '')}"
                         f"{list(t.shape)}")


# --------------------------------------------------------------------------
# Reductions
# --------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes, op: str) -> torch.Tensor:
    _report("all_reduce", x)
    is_bool = x.dtype == torch.bool
    out = (x.to(torch.int32) if is_bool else x).contiguous().clone()
    if not mesh.counting:
        with count.transport():
            issued["all_reduce"] += 1
            dist.all_reduce(out, op=_OPS[op], group=mesh.group(axes))
    return out.bool() if is_bool else out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes, "sum"), None, None


def psum(x: torch.Tensor, axes=None, mesh: Mesh | None = None
         ) -> torch.Tensor:
    """Sum over the ranks of ``axes`` (differentiable; its transpose is
    ``psum``)."""
    mesh = _mesh(mesh, x)
    axes = mesh.axes(axes)
    if _elided(mesh, axes):
        return x.clone()
    return _PSum.apply(x, mesh, axes)


def pmean(x: torch.Tensor, axes=None, mesh: Mesh | None = None
          ) -> torch.Tensor:
    mesh = _mesh(mesh)
    return psum(x, axes, mesh) / mesh.axis_size(axes)


def _reduce(x: torch.Tensor, axes, mesh: Mesh | None, op: str
            ) -> torch.Tensor:
    """``op`` over the ranks of ``axes``, not differentiated."""
    mesh = _mesh(mesh, x)
    axes = mesh.axes(axes)
    if _elided(mesh, axes):
        return x.detach().clone()
    return _all_reduce(x.detach(), mesh, axes, op)


def pmax(x: torch.Tensor, axes=None, mesh: Mesh | None = None
         ) -> torch.Tensor:
    return _reduce(x, axes, mesh, "max")


def pmin(x: torch.Tensor, axes=None, mesh: Mesh | None = None
         ) -> torch.Tensor:
    return _reduce(x, axes, mesh, "min")


# --------------------------------------------------------------------------
# all_gather
# --------------------------------------------------------------------------


def _gather_parts(x: torch.Tensor, mesh: Mesh, axes) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axes))]
    _report("all_gather", x, len(parts))
    if not mesh.counting:
        with count.transport():
            issued["all_gather"] += 1
            dist.all_gather(parts, x, group=mesh.group(axes))
    return parts


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, tiled):
        ctx.mesh, ctx.axes, ctx.dim, ctx.tiled = mesh, axes, dim, tiled
        parts = _gather_parts(x, mesh, axes)
        return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

    @staticmethod
    def backward(ctx, g):
        out = _reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim)
        return (out if ctx.tiled else out.squeeze(ctx.dim)), None, None, \
            None, None


def all_gather(x: torch.Tensor, axes=None, dim: int = 0, tiled: bool = False,
               mesh: Mesh | None = None) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, in rank order: stacked on a new
    axis ``dim``, or with ``tiled`` concatenated along ``dim``."""
    mesh = _mesh(mesh, x)
    axes = mesh.axes(axes)
    dim = dim % (x.dim() + (0 if tiled else 1))
    if _elided(mesh, axes):
        return x if tiled else x.unsqueeze(dim)
    return _AllGather.apply(x, mesh, axes, dim, tiled)


def shard(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole ``x`` every rank holds: dimension
    ``d`` split over the ranks of ``spec[d]`` (axes ``mesh`` lacks
    dropped), the chunk at this rank's index kept."""
    for d, entry in enumerate(filter_spec(spec, mesh.axis_names)):
        if entry is None:
            continue
        n, i = mesh.axis_size(entry), mesh.axis_index(entry)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {entry} ({n} ranks)")
        w = x.shape[d] // n
        x = x.narrow(d, i * w, w)
    return x.contiguous()


def unshard(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh
            ) -> torch.Tensor:
    """The inverse of :func:`shard`: the whole leaf on every rank, from
    every rank's slice (tiled all-gathers)."""
    for d, entry in enumerate(filter_spec(spec, mesh.axis_names)):
        if entry is not None:
            x = all_gather(x, entry, dim=d, tiled=True, mesh=mesh)
    return x


# --------------------------------------------------------------------------
# reduce_scatter
# --------------------------------------------------------------------------


# ``reduce_scatter_tensor`` took the name ``reduce_scatter_single`` in
# torch 2.13; the two take the same arguments.
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int
                    ) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of ``x``, cut into one chunk a
    rank along ``dim``: this rank's chunk.  One reduce-scatter over the
    chunks laid out along dim 0."""
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    chunks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    shape = chunks.shape[1:]
    # The group takes the chunks concatenated along dim 0.
    chunks = chunks.reshape(n * shape[0], *shape[1:]) if shape else \
        chunks.contiguous()
    _report("reduce_scatter", x)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if mesh.counting:
        return out
    with count.transport():
        staged = "reduce_scatter" in staged_ops(x.device)
        src, dst = (chunks.cpu(), torch.empty(shape, dtype=x.dtype)) \
            if staged else (chunks, out)
        issued["reduce_scatter"] += 1
        _REDUCE_SCATTER(dst, src, group=mesh.group(axes))
        if staged:
            out.copy_(dst)
    return out


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        parts = _gather_parts(g, mesh, axes)
        return torch.cat(parts, dim), None, None, None


def reduce_scatter(x: torch.Tensor, axes=None, dim: int = 0,
                   mesh: Mesh | None = None) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axes, scatter_dimension=dim,
    tiled=True)``: the sum over the ranks of ``axes``, of which this rank
    keeps chunk ``axis_index(axes)`` of ``dim`` (``x.shape[dim]`` must
    split evenly).  Its transpose is the tiled :func:`all_gather`."""
    mesh = _mesh(mesh, x)
    axes = mesh.axes(axes)
    dim = dim % x.dim()
    if _elided(mesh, axes):
        return x.clone()
    return _ReduceScatter.apply(x, mesh, axes, dim)


# --------------------------------------------------------------------------
# all_to_all
# --------------------------------------------------------------------------


def _all_to_all(x: torch.Tensor, mesh: Mesh, axes, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    # Chunk j of the split axis goes to rank j: lay the chunks out along
    # dim 0, exchange, and concatenate what arrives in source order.
    chunks = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
    chunks = chunks.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(chunks)
    _report("all_to_all", x)
    if not mesh.counting:
        with count.transport():
            issued["all_to_all"] += 1
            dist.all_to_all_single(out, chunks, group=mesh.group(axes))
    return torch.cat(list(out.unbind(0)), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return _all_to_all(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (_all_to_all(g, mesh, axes, concat_dim, split_dim),
                None, None, None, None)


def all_to_all(x: torch.Tensor, axes=None, split_dim: int = 0,
               concat_dim: int = 0, mesh: Mesh | None = None
               ) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: split ``split_dim`` into
    one chunk per rank, send chunk ``j`` to rank ``j``, and concatenate
    the chunks received along ``concat_dim`` in source order."""
    mesh = _mesh(mesh, x)
    axes = mesh.axes(axes)
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if _elided(mesh, axes):
        return x
    return _AllToAll.apply(x, mesh, axes, split_dim, concat_dim)


# --------------------------------------------------------------------------
# ppermute
# --------------------------------------------------------------------------


def _ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
              perm: tuple[tuple[int, int], ...]) -> torch.Tensor:
    _report("ppermute", x)
    me = mesh.axis_index(axis)
    # Zeros where nobody sends, this rank's own x where it keeps it.
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if (me, me) in perm:
        out.copy_(x.detach())
    if mesh.counting:
        return out
    with count.transport():
        group = mesh.group(axis)
        # Group ranks are global ranks; an axis index maps to the group's
        # rank of that index (groups order their ranks as the axis does).
        to_global = dist.get_process_group_ranks(group)
        staged = dist.get_backend(group) == "gloo" and x.is_cuda
        payload = x.detach().contiguous()
        recv = out
        if staged:
            payload = payload.cpu()
            recv = torch.zeros_like(payload)
        ops = []
        for src, dst in perm:
            if src == me and dst != me:
                issued["send"] += 1
                ops.append(dist.P2POp(dist.isend, payload, to_global[dst],
                                      group=group))
            elif dst == me and src != me:
                issued["recv"] += 1
                ops.append(dist.P2POp(dist.irecv, recv, to_global[src],
                                      group=group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if staged and any(d == me and s != me for s, d in perm):
            out.copy_(recv)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, perm)
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, perm = ctx.args
        inverse = tuple((dst, src) for src, dst in perm)
        return _ppermute(g, mesh, axis, inverse), None, None, None


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[tuple[int, int]], mesh: Mesh | None = None
             ) -> torch.Tensor:
    """``jax.lax.ppermute``: for each ``(src, dst)`` the rank at index
    ``src`` of ``axis`` sends ``x`` to the rank at ``dst``; a rank that
    nobody sends to gets zeros.  Under gloo a card's payload is staged
    through host memory (:data:`STAGED_OPS`)."""
    mesh = _mesh(mesh, x)
    (axis,) = mesh.axes(axis)
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    n = mesh.axis_size(axis)
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a partial permutation "
                         f"of {n} ranks")
    return _PPermute.apply(x, mesh, axis, perm)
