"""Count what one call costs: FLOPs, bytes and peak live memory, op by op.

The twin of what ``repro.analysis.hlo`` is for.  ``repro`` compiles a
cell and reads XLA's HLO; the port runs eagerly, so :class:`Counter` is a
``TorchDispatchMode`` that sees every aten op of one call (autograd's
backward included) and records per op:

- FLOPs, from ``torch.utils.flop_counter``'s formula registry (matrix
  products, convolutions, attention), by the dtype the product runs in;
- bytes in and out (views and metadata ops move nothing and are left
  out), summed as ``eager_bytes``: an eager op reads its inputs from HBM
  and writes its outputs back;
- the live tensor bytes, tracked through allocation (a new storage among
  an op's outputs) and free (the storage's death), and their peak.  On
  ``meta`` tensors, which hold no memory, this predicts what the card
  will hold.

The hand-written kernels are ctypes calls that no dispatch mode sees.
Each wrapper is decorated with :func:`reports`: under an active counter
it records the kernel's own work (FLOPs and bytes from
:mod:`repro_torch.analysis.roofline`'s formulas) and counts none of the
ops inside it (on the CPU its plain version's), though their allocations
still count toward the peak.

Like ``hlo.py``'s loop-trip multipliers, :func:`scaled` multiplies what
runs inside it by a trip count: the catalog's folded train step runs one
micro-batch under it, so a dry run never traces 128 micro-batches op by
op.

The collectives of :mod:`repro_torch.distributed.comm` report their
bytes by kind (:meth:`Counter.add_collective`, ``repro``'s names and
byte convention), on a mesh of ranks or on a
:class:`~repro_torch.distributed.comm.CountingMesh`.  What moves the
payload on a mesh of ranks (``torch.distributed``'s own ops, a gloo
group's staging through host memory) runs under :func:`transport` and is
not seen at all, so a collective is never also counted as device-memory
traffic and a rank counts op for op what the counting mesh counts.
:attr:`CountSummary.wire_bytes` weighs the kinds by ``repro``'s ring
factors (``hlo.py``'s ``total_collective_bytes``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

# Ops that allocate without writing: their output counts toward the live
# bytes, not toward the traffic.
_ALLOC_ONLY = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}
# Gathers: of their first input they read only the rows they return.
_GATHERS = {"embedding", "index_select", "index", "gather", "take_along_dim"}
# Per-rank wire bytes of each kind over its counted bytes: ring
# algorithms, an all-reduce a reduce-scatter then an all-gather
# (``repro.analysis.hlo.HLOSummary.total_collective_bytes``).
WIRE_FACTORS = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def wire_bytes(collective_bytes: dict) -> float:
    """The bytes a rank sends: each kind's bytes times its ring factor
    (:data:`WIRE_FACTORS`)."""
    return float(sum(WIRE_FACTORS[k] * v
                     for k, v in collective_bytes.items()))


def tensor_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of an argument tree: dicts, lists, tuples, dataclasses,
    an ``nn.Module``'s parameters and buffers, and any object with
    ``parts`` (a stacked leaf)."""
    out: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif hasattr(x, "parts"):
            walk(list(x.parts))

    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op moves for ``t``: its elements, or its storage where
    that is smaller (a broadcast view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def unique_bytes(tensors) -> int:
    """Bytes of the distinct tensors among ``tensors`` (one view counted
    once)."""
    seen, total = set(), 0
    for t in tensors:
        key = (_storage_key(t), t.storage_offset(), tuple(t.shape),
               t.dtype)
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (nested lists and
    tuples, dict values), in order: a flatten cheaper than pytree's."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


@dataclasses.dataclass
class OpStat:
    calls: float = 0.0
    flops: float = 0.0
    nbytes: float = 0.0


@dataclasses.dataclass
class CountSummary:
    """One call's count (``repro``'s ``HLOSummary`` counterpart)."""

    dot_flops: float              # the registry's products (x loop trips)
    flops_by_dtype: dict          # dot and kernel FLOPs by dtype
    kernel_flops: float           # the hand-written kernels' own work
    kernel_bytes: float
    kernel_calls: dict            # kernel name -> calls (x loop trips)
    eager_bytes: float            # every op's inputs + outputs
    min_bytes: float              # arguments read once, outputs written once
    arg_bytes: float
    peak_bytes: float             # live tensor bytes at their peak
    n_ops: float
    top_bytes: list               # (op, calls, bytes, flops), most bytes
    top_flops: list               # (op, calls, bytes, flops), most FLOPs
    multiplier: list              # the trip counts folded (scaled())
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    # (kind, operand, calls, bytes), most bytes first
    top_collectives: list = dataclasses.field(default_factory=list)

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def wire_bytes(self) -> float:
        return wire_bytes(self.collective_bytes)

    def as_row(self) -> dict:
        return {**dataclasses.asdict(self), "flops": self.flops,
                "wire_bytes": self.wire_bytes}


class Counter(TorchDispatchMode):
    """Counts every aten op run under it (``with Counter() as c:``).

    ``track(tree)`` adds tensors that exist before the call (its
    arguments) to the live bytes; :meth:`summary` reads the count."""

    def __init__(self, top: int = 12):
        super().__init__()
        self.top = top
        self.ops: dict[str, OpStat] = defaultdict(OpStat)
        self.flops_by_dtype: dict[str, float] = defaultdict(float)
        self.dot_flops = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: dict[str, float] = defaultdict(float)
        self.eager_bytes = 0.0
        self.n_ops = 0.0
        self.live = 0
        self.peak = 0
        self.folded: list[int] = []
        self.collective_bytes: dict[str, float] = defaultdict(float)
        self.collective_counts: dict[str, float] = defaultdict(float)
        self.collective_ops: dict[tuple, OpStat] = defaultdict(OpStat)
        self._mult = 1.0
        self._in_kernel = 0
        self._in_transport = 0
        self._storages: dict[int, Any] = {}
        self._arg_storages: dict[int, int] = {}   # key -> nbytes
        self._written: dict[int, int] = defaultdict(int)
        self._read: dict[int, int] = defaultdict(int)

    # -- live bytes --------------------------------------------------------

    def _free(self, key: int, nbytes: int, _ref=None) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= nbytes

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        nbytes = st.nbytes()
        self._storages[key] = weakref.ref(
            st, functools.partial(self._free, key, nbytes))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def track(self, tree: Any) -> None:
        """The call's arguments: live from the start, and the storages
        whose in-place writes :meth:`min_bytes` counts."""
        for t in tensor_leaves(tree):
            self._alloc(t)
            st = t.untyped_storage()
            self._arg_storages[st._cdata] = st.nbytes()

    def min_bytes(self, args: Any, result: Any) -> tuple[int, int]:
        """(the least bytes the call moves, its arguments' bytes): each
        argument byte the call reads read once (all of a weight a product
        reads; of a table a gather or a kernel reads from, the rows it
        reads), each byte of a new result written once, and each argument
        byte written in place once (a KV cache's new position, an
        optimizer's whole state)."""
        arg_bytes = unique_bytes(tensor_leaves(args))
        new = [t for t in tensor_leaves(result)
               if _storage_key(t) not in self._arg_storages]
        cap = self._arg_storages
        read = sum(min(n, cap[k]) for k, n in self._read.items())
        in_place = sum(min(n, cap[k]) for k, n in self._written.items())
        return read + unique_bytes(new) + in_place, arg_bytes

    def _note_reads(self, name: str, ins: list, outs: list) -> None:
        for i, t in enumerate(ins):
            key = _storage_key(t)
            if key in self._arg_storages:
                self._read[key] += (sum(o.numel() * o.element_size()
                                        for o in outs)
                                    if i == 0 and name in _GATHERS
                                    else _nbytes(t))

    # -- the dispatch hook -------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_transport:
            return out
        outs = _tensors(out, [])
        for t in outs:
            self._alloc(t)
        schema = func._schema
        if schema.is_mutable:
            self._note_writes(schema, args, kwargs)
        if self._in_kernel:
            return out
        name = func.__name__.split(".")[0]
        ins = _tensors(kwargs, _tensors(args, []))
        self._note_reads(name, ins, outs)
        if not schema.is_mutable:
            # A metadata op, or a view (an output on an input's storage:
            # ``_unsafe_view`` has no alias annotation): nothing moves.
            in_keys = {_storage_key(t) for t in ins}
            if not schema.returns or outs and all(
                    _storage_key(t) in in_keys for t in outs):
                return out
        m = self._mult
        stat = self.ops[name]
        stat.calls += m
        self.n_ops += m
        if name not in _ALLOC_ONLY:
            nbytes = (sum(_nbytes(t) for t in ins)
                      + sum(_nbytes(t) for t in outs)) * m
            stat.nbytes += nbytes
            self.eager_bytes += nbytes
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out) * m
            first = ins[0]
            stat.flops += flops
            self.dot_flops += flops
            self.flops_by_dtype[str(first.dtype).replace("torch.", "")] \
                += flops
        return out

    def _note_writes(self, schema, args, kwargs) -> None:
        """Bytes an in-place op writes into the call's arguments."""
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _tensors(val, []):
                key = _storage_key(t)
                if key in self._arg_storages:
                    self._written[key] += t.numel() * t.element_size()

    # -- kernels and folded loops -----------------------------------------

    def add_kernel(self, name: str, nbytes: float, flops: float,
                   dtype: torch.dtype, reads=()) -> None:
        """One kernel call's work; ``reads``: (tensor, bytes) of the
        tables it reads only in part (any other tensor argument of the
        call counts whole, as an op's input does)."""
        for t, n in reads:
            key = _storage_key(t)
            if key in self._arg_storages:
                self._read[key] += n
        m = self._mult
        stat = self.ops[f"kernel:{name}"]
        stat.calls += m
        stat.nbytes += nbytes * m
        stat.flops += flops * m
        self.n_ops += m
        self.kernel_calls[name] += m
        self.kernel_flops += flops * m
        self.kernel_bytes += nbytes * m
        self.eager_bytes += nbytes * m
        if flops:
            self.flops_by_dtype[str(dtype).replace("torch.", "")] += flops * m

    def add_collective(self, kind: str, nbytes: float,
                       operand: str = "") -> None:
        """One collective call of ``kind`` (``repro``'s name, e.g.
        ``"all-gather"``) and its bytes, times the loop trips;
        ``operand`` names what it moved (dtype and shape), for
        :attr:`CountSummary.top_collectives`."""
        self.collective_bytes[kind] += nbytes * self._mult
        self.collective_counts[kind] += self._mult
        stat = self.collective_ops[kind, operand]
        stat.calls += self._mult
        stat.nbytes += nbytes * self._mult

    def summary(self, min_bytes: float = 0.0, arg_bytes: float = 0.0
                ) -> CountSummary:
        rows = [(name, s.calls, s.nbytes, s.flops)
                for name, s in self.ops.items()]
        return CountSummary(
            dot_flops=self.dot_flops,
            flops_by_dtype=dict(self.flops_by_dtype),
            kernel_flops=self.kernel_flops, kernel_bytes=self.kernel_bytes,
            kernel_calls=dict(self.kernel_calls),
            eager_bytes=self.eager_bytes, min_bytes=min_bytes,
            arg_bytes=arg_bytes, peak_bytes=self.peak, n_ops=self.n_ops,
            top_bytes=sorted(rows, key=lambda r: -r[2])[:self.top],
            top_flops=[r for r in sorted(rows, key=lambda r: -r[3])
                       if r[3] > 0][:self.top],
            multiplier=list(self.folded),
            collective_bytes=dict(self.collective_bytes),
            collective_counts=dict(self.collective_counts),
            top_collectives=sorted(
                ((k, o, st.calls, st.nbytes)
                 for (k, o), st in self.collective_ops.items()),
                key=lambda r: -r[3])[:self.top])


def active() -> Counter | None:
    """The innermost :class:`Counter` on this thread, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Counter):
            return mode
    return None


@contextlib.contextmanager
def scaled(trips: int):
    """Count what runs inside ``trips`` times on the active counter:
    ``hlo.py``'s loop-trip multiplier for a loop body the caller runs
    once (a folded train step's micro-batch, ``launch/cells.py``).  It
    changes nothing that runs, and outside a counter it does nothing."""
    c = active()
    if c is None or trips == 1:
        yield
        return
    c._mult *= trips
    c.folded.append(int(trips))
    try:
        yield
    finally:
        c._mult /= trips


@contextlib.contextmanager
def transport():
    """What runs inside moves a collective's payload between ranks
    (``torch.distributed``'s ops, a gloo group's copies through host
    memory): the active counter sees none of it, since
    :mod:`repro_torch.distributed.comm` reports the collective's bytes by
    kind and allocates its result outside the block."""
    c = active()
    if c is None:
        yield
        return
    c._in_transport += 1
    try:
        yield
    finally:
        c._in_transport -= 1


def reports(name: str, work: Callable):
    """Decorator of a kernel wrapper: under an active counter the call
    records ``work(*args, **kwargs, result=result)`` -> (bytes, FLOPs,
    dtype[, reads]) as the kernel's (``reads``: (table, bytes) of what it
    gathers from a table, see :meth:`Counter.add_kernel`), and the ops
    inside it (the plain version's on
    the CPU, the formula's own) are not counted; outside a counter the
    wrapper runs as it is."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            c = active()
            if c is None:
                return fn(*args, **kwargs)
            c._in_kernel += 1
            try:
                result = fn(*args, **kwargs)
                nbytes, flops, dtype, *reads = work(*args, **kwargs,
                                                    result=result)
            finally:
                c._in_kernel -= 1
            reads = reads[0] if reads else ()
            partial = {id(t) for t, _ in reads}
            c._note_reads(name, [t for t in _tensors((args, kwargs), [])
                                 if id(t) not in partial], [])
            c.add_kernel(name, nbytes, flops, dtype, reads)
            return result

        return call

    return wrap


def count_call(fn: Callable, args: tuple, top: int = 12
               ) -> tuple[Any, CountSummary]:
    """Run ``fn(*args)`` under a fresh :class:`Counter` (its arguments
    live from the start) and return ``(result, summary)``, its
    ``min_bytes`` :meth:`Counter.min_bytes`'s."""
    with Counter(top=top) as c:
        c.track(args)
        result = fn(*args)
    min_bytes, arg_bytes = c.min_bytes(args, result)
    return result, c.summary(min_bytes=min_bytes, arg_bytes=arg_bytes)
