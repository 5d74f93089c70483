"""Plain torch version of the subset-combine kernel (the CPU path and the
card-side oracle of ``csrc/subset_combine.cu``).

Semantics: for every row and every split a ⊎ b = t in popcount order,
``S[.., t] <- topk_unique(S[.., t] ∪ (S[.., a] ⊕ S[.., b]))`` — one
sequential sweep reaches the closure.
"""

from __future__ import annotations

import torch

from repro_torch.core.dks import map_node_chunks
from repro_torch.core.semiring import outer_combine, topk_merge
from repro_torch.core.spa import split_pairs


def subset_combine_ref(S: torch.Tensor, m: int) -> torch.Tensor:
    """S: [..., 2^m, K] -> closed table of the same shape (exact), over
    chunks of the row axis (``map_node_chunks``) where there is one."""
    if S.dim() < 3:
        return _sweep(S, m)
    return map_node_chunks(lambda s: _sweep(s, m), S)


def _sweep(S: torch.Tensor, m: int) -> torch.Tensor:
    S = S.clone()
    for t, a, b in split_pairs(m):
        cand = outer_combine(S[..., a, :], S[..., b, :])
        S[..., t, :] = topk_merge(S[..., t, :], cand)
    return S
