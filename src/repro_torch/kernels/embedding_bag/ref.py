"""Plain torch version of the EmbeddingBag kernel (the CPU path and the
card-side oracle of ``csrc/embedding_bag.cu``): ``repro``'s
``kernels/embedding_bag/ref.py::embedding_bag_ref``, gather plus a masked,
weighted sum over each bag.

An id outside ``[0, V)`` is padding: ``-1`` as in ``repro``, and an id
``>= V`` too (``repro`` has no defined result there; the kernel skips such
an id and so does this version).
"""

from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor | None = None,
                      mode: str = "sum") -> torch.Tensor:
    """table [V, D]; ids [B, nnz]; weights [B, nnz] or None -> [B, D]:
    ``sum_j w_j * table[ids_j]`` over the bag's valid ids, divided by
    ``max(valid count, 1)`` for ``mode="mean"``."""
    b, nnz = ids.shape
    valid = (ids >= 0) & (ids < table.shape[0])
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()
    rows = table[safe.reshape(-1)].reshape(b, nnz, table.shape[1])
    if weights is not None:
        rows = rows * weights[..., None]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp(min=1)
    return out
