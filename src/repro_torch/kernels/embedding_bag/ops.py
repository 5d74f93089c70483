"""Wrapper of the EmbeddingBag kernel (``csrc/embedding_bag.cu``).

On a CPU tensor it takes the plain version (:mod:`.ref`); on a CUDA tensor
it launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

MODES = {"sum": 0, "mean": 1}

launches = 0


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """table f32[V, D]; ids int32[B, nnz] (an id outside ``[0, V)`` is
    padding: skipped, and not counted by ``"mean"``); weights f32[B, nnz]
    or None (all 1) -> f32[B, D], ``sum_j w_j * table[ids_j]`` per bag,
    divided by ``max(valid count, 1)`` for ``mode="mean"``.  All
    contiguous, on one device."""
    global launches
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
    launches += 1
    cuda_build.check(err, "embedding_bag")
    return out
