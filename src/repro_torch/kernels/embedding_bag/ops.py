"""Wrappers of the EmbeddingBag kernels (``csrc/embedding_bag.cu``): the
multi-hot bag (:func:`embedding_bag`) and the grouped single-hot lookup of
several tables in one launch (:func:`embedding_bag_grouped`).

On a CPU tensor each takes its plain version (:mod:`.ref`); on a CUDA
tensor it launches the kernel or raises.  ``launches`` counts kernel
launches of both.
"""

from __future__ import annotations

import array

import torch

from repro_torch.analysis import count, roofline
from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_grouped_ref,
                                                   embedding_bag_ref)

MODES = {"sum": 0, "mean": 1}
MAX_FIELDS = 64     # table pointers that fit the grouped kernel's parameter

counter = LaunchCounter()


@count.reports("embedding_bag", roofline.embedding_bag_work)
def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """table f32[V, D]; ids int32[B, nnz] (an id outside ``[0, V)`` is
    padding: skipped, and not counted by ``"mean"``); weights f32[B, nnz]
    or None (all 1) -> f32[B, D], ``sum_j w_j * table[ids_j]`` per bag,
    divided by ``max(valid count, 1)`` for ``mode="mean"``.  All
    contiguous, on one device."""
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {sorted(MODES)}, "
                         f"got {mode!r}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"embedding_bag wants table [V, D] and ids [B, nnz], "
                         f"got {list(table.shape)} and {list(ids.shape)}")
    if table.dtype != torch.float32:
        raise ValueError(f"embedding_bag: the CUDA kernel supports float32 "
                         f"tables, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"embedding_bag wants int32 ids, got {ids.dtype} "
                         f"(convert explicitly)")
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != ids.shape):
        raise ValueError(f"embedding_bag wants float32 weights of the ids' "
                         f"shape {list(ids.shape)}, got {weights.dtype}"
                         f"{list(weights.shape)}")
    tensors = (table, ids) if weights is None else (table, ids, weights)
    if any(t.device != table.device for t in tensors):
        raise ValueError("embedding_bag: table, ids and weights must be on "
                         "one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("embedding_bag wants contiguous table, ids, weights")
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, weights, mode)
    if table.device.type == "meta":
        return table.new_empty(ids.shape[0], table.shape[1])
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {table.device}")
    (b, nnz), (v, d) = ids.shape, table.shape
    out = torch.empty(b, d, dtype=torch.float32, device=table.device)
    if b == 0 or d == 0:
        return out
    if nnz == 0:
        return out.zero_()
    fn = cuda_build.library("embedding_bag").embedding_bag_fwd
    err = fn(table.data_ptr(), v, d, ids.data_ptr(),
             None if weights is None else weights.data_ptr(), out.data_ptr(),
             b, nnz, MODES[mode],
             torch.cuda.current_stream(table.device).cuda_stream)
    counter.add()
    cuda_build.check(err, "embedding_bag")
    return out


@count.reports("embedding_bag_grouped", roofline.grouped_work)
def embedding_bag_grouped(tables, ids: torch.Tensor, out: torch.Tensor,
                          col0: int = 0, clip: bool = False,
                          prefix: torch.Tensor | None = None) -> torch.Tensor:
    """Single-hot lookups of F fields in one launch.

    tables: F f32 tensors [rows_f, D] (one D); ids int32[B, F]; out
    f32[B, ld] with ``ld >= col0 + F * D``: written in place, field f of
    request b at ``out[b, col0 + f*D : col0 + (f+1)*D] = tables[f][ids[b,
    f]]``; prefix f32[B, col0] or None: copied into ``out[:, :col0]`` in the
    same launch, or those columns are left as they are, like any column
    past the fields; returns ``out``.  ``clip`` clamps each id into ``[0,
    rows_f - 1]`` (every table then needs a row); otherwise an id outside
    its table is padding, a row of zeros.  1 <= F <= :data:`MAX_FIELDS`.
    All contiguous, on one device."""
    tables = list(tables)
    if ids.dim() != 2 or out.dim() != 2 or ids.shape[0] != out.shape[0]:
        raise ValueError(f"embedding_bag_grouped wants ids [B, F] and out "
                         f"[B, ld], got {list(ids.shape)} and "
                         f"{list(out.shape)}")
    b, f = ids.shape
    if len(tables) != f or not 1 <= f <= MAX_FIELDS:
        raise ValueError(f"embedding_bag_grouped wants one table per field "
                         f"and 1 to {MAX_FIELDS} fields, got {len(tables)} "
                         f"tables for ids {list(ids.shape)}")
    # One pass over the tables (a serving call runs this for every request).
    d = tables[0].shape[-1] if tables[0].dim() else -1
    dev, f32 = out.get_device(), torch.float32
    ptrs, rows = array.array("q"), array.array("q")
    for t in tables:
        shape = t.shape
        if len(shape) != 2 or shape[1] != d:
            raise ValueError(f"embedding_bag_grouped wants tables [rows, D] "
                             f"of one D, got {[list(t.shape) for t in tables]}")
        if t.dtype is not f32 or t.get_device() != dev \
                or not t.is_contiguous():
            raise ValueError("embedding_bag_grouped wants float32, contiguous "
                             "tables on the output's device")
        if clip and shape[0] == 0:
            raise ValueError("embedding_bag_grouped: clip needs every table "
                             "to have a row")
        ptrs.append(t.data_ptr())
        rows.append(shape[0])
    others = [out, ids] + ([] if prefix is None else [prefix])
    if out.dtype is not f32 or (prefix is not None and prefix.dtype is not f32):
        raise ValueError("embedding_bag_grouped: the CUDA kernel supports "
                         "float32 tables, prefix and output")
    if ids.dtype != torch.int32:
        raise ValueError(f"embedding_bag_grouped wants int32 ids, got "
                         f"{ids.dtype} (convert explicitly)")
    if d == 0 or col0 < 0 or col0 + f * d > out.shape[1]:
        raise ValueError(f"embedding_bag_grouped: {f} fields of D = {d} "
                         f"from column {col0} do not fit out "
                         f"{list(out.shape)}")
    if prefix is not None and tuple(prefix.shape) != (b, col0):
        raise ValueError(f"embedding_bag_grouped wants a prefix [{b}, "
                         f"{col0}], got {list(prefix.shape)}")
    if any(t.get_device() != dev for t in others):
        raise ValueError("embedding_bag_grouped: tables, ids, prefix and out "
                         "must be on one device")
    if not all(t.is_contiguous() for t in others):
        raise ValueError("embedding_bag_grouped wants contiguous ids, prefix "
                         "and out")
    if out.device.type == "cpu":
        return embedding_bag_grouped_ref(tables, ids, out, col0, clip, prefix)
    if out.device.type == "meta":
        return out
    if out.device.type != "cuda":
        raise ValueError(f"embedding_bag_grouped: unsupported device "
                         f"{out.device}")
    if b == 0:
        return out
    fn = cuda_build.library("embedding_bag").embedding_bag_grouped_fwd
    err = fn(ids.data_ptr(), b, f, ptrs.buffer_info()[0],
             rows.buffer_info()[0], d,
             None if prefix is None else prefix.data_ptr(), out.data_ptr(),
             out.shape[1], col0, int(clip),
             torch.cuda.current_stream(out.device).cuda_stream)
    counter.add()
    cuda_build.check(err, "embedding_bag_grouped")
    return out


def __getattr__(name: str):
    # ``ops.launches``: the total of ``counter`` over every thread (and,
    # for flash, ``ops.launches_by_route``), read like a plain attribute.
    if name == "launches":
        return counter.total
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
