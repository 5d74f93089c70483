"""Top-K min-plus lattice operations on torch tensors.

Every node keeps, for every keyword-set, the top-K best partial-answer
path-lengths (the paper's ``S_K``, Sec. 4/5.1) as the last axis of a dense
tensor ``S[..., V, 2^m, K]``: a *sorted, duplicate-free, INF-padded*
K-vector.  Every value the lattice makes is a min, a compare, or one f32
add, so these functions agree with ``repro.core.semiring`` bit for bit.

- ``topk_merge``       — join of two K-vectors (Pregel "receive messages")
- ``outer_combine``    — min-plus product of two K-vectors (local-tree combine)
- ``segment_topk_min`` — top-K distinct min-reduce by segment id
"""

from __future__ import annotations

import torch

from repro_torch import INF


def sorted_unique_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sort ascending along the last axis, drop duplicate values, pad with
    INF, and keep the first ``k`` entries.  ``x``: (..., n), n >= k."""
    x = torch.sort(x, dim=-1).values
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    x = torch.where(dup, torch.full_like(x, INF), x)
    x = torch.sort(x, dim=-1).values
    return x[..., :k].contiguous()


def topk_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two sorted-unique K-vectors into one (idempotent lattice join)."""
    return sorted_unique_k(torch.cat([a, b], dim=-1), a.shape[-1])


def outer_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-plus product: all pairwise sums of two K-vectors, saturated at
    INF, reduced to the top-K distinct sums.  (..., K) x (..., K) -> (..., K).
    """
    k = a.shape[-1]
    s = a[..., :, None] + b[..., None, :]
    s = torch.clamp(s, max=INF)  # saturate so INF+x stays INF
    return sorted_unique_k(s.reshape(*s.shape[:-2], k * k), k)


def segment_topk_min(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    k: int,
) -> torch.Tensor:
    """Exact per-segment top-K smallest *distinct* values.

    ``values``: (N, ...F); ``segment_ids``: (N,) integer.  Returns
    (num_segments, ...F, k), sorted-unique-INF-padded.

    K rounds of (segment-min -> mask every candidate equal to its segment's
    minimum).  Each round starts from a tensor full of INF, so an empty
    segment yields exactly INF — the value ``repro`` gets by clamping
    ``jax.ops.segment_min``'s +inf.
    """
    seg = segment_ids.long()
    index = seg.reshape(-1, *([1] * (values.dim() - 1))).expand_as(values)
    vals = values
    outs = []
    for _ in range(k):
        cur = torch.full((num_segments, *values.shape[1:]), INF,
                         dtype=values.dtype, device=values.device)
        cur.scatter_reduce_(0, index, vals, "amin", include_self=True)
        outs.append(cur)
        vals = torch.where(vals <= cur[seg], torch.full_like(vals, INF),
                           vals)
    return torch.stack(outs, dim=-1)


def bump_to_inf(x: torch.Tensor, thresh: float = INF * 0.5) -> torch.Tensor:
    """Saturate any value that drifted past thresh back to exactly INF."""
    return torch.where(x >= thresh, torch.full_like(x, INF), x)
