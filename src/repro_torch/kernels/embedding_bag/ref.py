"""Plain torch versions of the EmbeddingBag kernels (the CPU path and the
card-side oracles of ``csrc/embedding_bag.cu``): ``repro``'s
``kernels/embedding_bag/ref.py::embedding_bag_ref``, gather plus a masked,
weighted sum over each bag; and the grouped single-hot lookup, one gather
per field into its columns of a shared output.

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


def embedding_bag_grouped_ref(tables, ids: torch.Tensor, out: torch.Tensor,
                              col0: int = 0, clip: bool = False,
                              prefix: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """tables: F tensors [rows_f, D]; ids [B, F]; out [B, >= col0 + F*D],
    written in place and returned: ``out[:, col0 + f*D : col0 + (f+1)*D] =
    tables[f][ids[:, f]]``, and ``out[:, :col0] = prefix`` when a prefix is
    given.  ``clip`` clamps each id into ``[0, rows_f - 1]``; otherwise an
    id outside the table gives a row of zeros."""
    if prefix is not None:
        out[:, :col0] = prefix
    for f, table in enumerate(tables):
        rows, d = table.shape
        idx = ids[:, f]
        if clip:
            idx = torch.clamp(idx, 0, rows - 1)
        cols = out[:, col0 + f * d:col0 + (f + 1) * d]
        if rows == 0:
            cols.zero_()
            continue
        valid = (idx >= 0) & (idx < rows)
        got = table[torch.where(valid, idx, torch.zeros_like(idx)).long()]
        cols.copy_(torch.where(valid[:, None], got, torch.zeros_like(got)))
    return out
