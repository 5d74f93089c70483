"""Plain torch version of the lane-superstep kernel (the CPU path and the
card-side oracle of ``csrc/lane_superstep.cu``): edge-list relax with a
scatter-based segment top-K, merge with the old table, subset-combine
sweep, per-lane freeze."""

from __future__ import annotations

import torch

from repro_torch.core.dks import relax_edges
from repro_torch.core.semiring import topk_merge
from repro_torch.kernels.subset_combine.ref import subset_combine_ref


def fused_lane_step_ref(S0: torch.Tensor, changed: torch.Tensor,
                        done: torch.Tensor, offsets: torch.Tensor,
                        src: torch.Tensor, w: torch.Tensor, m: int
                        ) -> torch.Tensor:
    """S0: f32[L, V, 2^m, K]; changed: bool[L, V]; done: bool[L];
    offsets: int64[V+1] (node v's in-edges are ``src/w[offsets[v]:
    offsets[v+1]]`` of the dst-sorted edge list).  Returns S1 like S0."""
    v = S0.shape[1]
    n_e = int(offsets[-1])
    dst = torch.repeat_interleave(
        torch.arange(v, device=S0.device), offsets.diff())
    R = relax_edges(S0, changed, src[:n_e], dst, w[:n_e])
    S1 = subset_combine_ref(topk_merge(S0, R), m)
    return torch.where(done[:, None, None, None], S0, S1)
