"""Gradient compression: the int8 ring all-reduce with error feedback (the
twin of ``repro.distributed.compression``).

Each leaf is flattened, padded to the ring size and reduced in ``repro``'s
two phases: a reduce-scatter of ``n - 1`` hops, each sending one int8
chunk and its f32 scale to the next rank (``comm.ppermute``), then an
all-gather of ``n - 1`` hops of the reduced chunks, quantized again per
hop.  The result is the mean over the axis; what quantization lost on
this rank (its input minus the mean it got back) is carried to the next
step (error feedback, Seide et al. '14 / EF21).

The ring body runs on a leading rank axis: one row on a rank of a mesh,
whose hop is ``comm.ppermute``, or every rank's row in one process (the
single-process twin, :func:`compressed_allreduce_twin`), whose hop is a
roll of that axis.  Both take the same steps in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.distributed import comm
from repro_torch.optim.optimizers import tree_map


@dataclasses.dataclass
class CompressionState:
    error: Any          # residual carry, same tree as the gradients (f32)


def init_compression(grads: Any) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads))


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``x`` [R, chunk]: int8 codes and the f32 scale
    ``max|x| / 127`` (at least 1e-12 / 127), as ``repro`` quantizes one
    chunk.  XLA compiles ``repro``'s ``/ 127.0`` as a multiply by the f32
    reciprocal, and so does this."""
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) * inv
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _ring_allreduce_int8(x: torch.Tensor, n: int, idx: torch.Tensor,
                         hop: Callable[[torch.Tensor], torch.Tensor]
                         ) -> torch.Tensor:
    """Two-phase ring all-reduce of ``x`` f32[R, n * chunk], rank ``idx[r]``
    in row ``r``; ``hop`` moves every row's payload to the next rank of
    the ring.  Returns the mean over the ring, f32[R, n * chunk]."""
    rows = x.shape[0]
    xs = x.reshape(rows, n, -1).clone()
    r = torch.arange(rows, device=x.device)
    # Phase 1: reduce-scatter.  After n - 1 hops rank i holds the full sum
    # of chunk (i + 1) mod n.
    for j in range(n - 1):
        q, s = _quantize(xs[r, (idx - j) % n])
        q, s = hop(q), hop(s)
        recv = (idx - j - 1) % n
        # XLA fuses repro's add of q * s into one rounding (a fused
        # multiply-add): q * s is exact in f64 (8 x 24 bits), so the sum
        # in f64 rounded once to f32 gives the same bits.
        xs[r, recv] = (xs[r, recv].double()
                       + q.double() * s.double()).float()
    # Phase 2: all-gather the reduced chunks around the ring.
    for j in range(n - 1):
        q, s = _quantize(xs[r, (idx + 1 - j) % n])
        q, s = hop(q), hop(s)
        xs[r, (idx - j) % n] = q.float() * s
    return xs.reshape(rows, -1) / n


def _leaf_reduce(g: torch.Tensor, e: torch.Tensor, n: int,
                 idx: torch.Tensor, hop: Callable
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf on a leading rank axis: ``g``, ``e`` [R, ...] -> (the mean
    in ``g``'s dtype, the new error), each [R, ...]."""
    rows = g.shape[0]
    x = g.reshape(rows, -1).float() + e.reshape(rows, -1)
    size = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, (-size) % n))
    red = _ring_allreduce_int8(xp, n, idx, hop)[:, :size]
    return (red.reshape(g.shape).to(g.dtype),
            (x - red).reshape(g.shape))


def _map_pairs(fn: Callable, a: Any, b: Any) -> tuple[Any, Any]:
    """``fn(leaf_a, leaf_b) -> (x, y)`` over two trees of the same shape,
    returned as two trees."""
    pairs = tree_map(fn, a, b)
    return (tree_map(lambda _, p: p[0], a, pairs),
            tree_map(lambda _, p: p[1], a, pairs))


def compressed_allreduce(grads: Any, state: CompressionState,
                         mesh: comm.Mesh, axis: str = "data",
                         ) -> tuple[Any, CompressionState]:
    """Mean-all-reduce this rank's ``grads`` over ``axis`` of ``mesh`` with
    the int8 ring and error feedback.  Returns them unchanged at axis size
    1, as ``repro`` does."""
    n = mesh.axis_size(axis)
    if n == 1:
        return grads, state
    ring = [(k, (k + 1) % n) for k in range(n)]

    def hop(t: torch.Tensor) -> torch.Tensor:
        return comm.ppermute(t, axis, ring, mesh=mesh)

    def leaf(g: torch.Tensor, e: torch.Tensor):
        idx = torch.tensor([mesh.axis_index(axis)], device=g.device)
        red, err = _leaf_reduce(g[None], e[None], n, idx, hop)
        return red[0], err[0]

    red, err = _map_pairs(leaf, grads, state.error)
    return red, CompressionState(error=err)


def compressed_allreduce_twin(grads: Any, state: CompressionState, n: int,
                              ) -> tuple[Any, CompressionState]:
    """The single-process twin of :func:`compressed_allreduce`: every leaf
    of ``grads`` and ``state.error`` carries a leading axis of the ``n``
    ranks' values, and each hop rolls that axis by one."""
    if n == 1:
        return grads, state

    def leaf(g: torch.Tensor, e: torch.Tensor):
        idx = torch.arange(n, device=g.device)
        return _leaf_reduce(g, e, n, idx,
                            lambda t: torch.roll(t, 1, dims=0))

    red, err = _map_pairs(leaf, grads, state.error)
    return red, CompressionState(error=err)
