"""Plain torch version of the lane-superstep kernel (the CPU path and the
card-side oracle of ``csrc/lane_superstep.cu``): edge-list relax with a
scatter-based segment top-K, merge with the old table, subset-combine
sweep, per-lane freeze, over chunks of destination nodes (each chunk's
in-edges are one range of the dst-sorted list), so that it fits the card
at bluk-bnb scale."""

from __future__ import annotations

import torch

from repro_torch.core import dks
from repro_torch.core.semiring import topk_merge
from repro_torch.kernels.subset_combine.ref import subset_combine_ref


def fused_lane_step_ref(S0: torch.Tensor, changed: torch.Tensor,
                        done: torch.Tensor, offsets: torch.Tensor,
                        src: torch.Tensor, w: torch.Tensor, m: int
                        ) -> torch.Tensor:
    """S0: f32[L, V, 2^m, K]; changed: bool[L, V]; done: bool[L];
    offsets: int64[V+1] (node v's in-edges are ``src/w[offsets[v]:
    offsets[v+1]]`` of the dst-sorted edge list).  Returns S1 like S0."""
    out = torch.empty_like(S0)
    # Two tables' rows a node: S0 and the relax's R.
    for rows in dks.node_chunks(S0.shape[1], 2 * S0[:, 0].numel() * 4):
        lo, hi = rows.start, rows.stop
        e0, e1 = int(offsets[lo]), int(offsets[hi])
        dst = torch.repeat_interleave(
            torch.arange(hi - lo, device=S0.device), offsets[lo:hi + 1].diff())
        R = dks.relax_edges(S0, changed, src[e0:e1], dst, w[e0:e1],
                            n_dst=hi - lo)
        S1 = subset_combine_ref(topk_merge(S0[:, rows], R), m)
        out[:, rows] = torch.where(done[:, None, None, None], S0[:, rows], S1)
    return out
