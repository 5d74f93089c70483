"""Baselines the paper compares against — the twin of
``repro.core.baselines``.

- :func:`vanilla_parallel_bfs` — plain frontier BFS touching the whole
  graph (the paper's Sec. 7.2 reference point: DKS should stay within a
  small factor of it while doing exponentially more per-node work).
- :func:`dks_no_early_exit` — DKS with the exit criterion disabled
  (ablation for the "effectiveness of early exit" experiments).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dks import DKSConfig, DKSState, run_dks
from repro_torch.graph.structure import DeviceGraph

UNREACHED = 1 << 30


def vanilla_parallel_bfs(graph: DeviceGraph, sources: torch.Tensor,
                         max_steps: int = 64
                         ) -> tuple[torch.Tensor, int]:
    """Frontier BFS from a source mask (bool[V_pad]); returns ``(hops
    i32[V_pad], supersteps)``, unreached nodes at 2^30.  A host loop over
    one segment-min per superstep."""
    v = graph.v_pad
    src, dst = graph.src.long(), graph.dst.long()
    unreached = torch.full((v,), UNREACHED, dtype=torch.int32,
                           device=graph.device)
    dist = torch.where(sources & graph.node_valid,
                       torch.zeros_like(unreached), unreached)
    frontier = sources & graph.node_valid
    steps = 0
    while bool(frontier.any()) and steps < max_steps:
        send = frontier[src] & graph.valid
        cand = torch.where(send, dist[src] + 1,
                           torch.full_like(dist[src], UNREACHED))
        new = unreached.clone().scatter_reduce_(0, dst, cand, "amin")
        improved = new < dist
        dist = torch.minimum(dist, new)
        frontier = improved & graph.node_valid
        steps += 1
    return dist, steps


def dks_no_early_exit(graph: DeviceGraph, kw_masks: torch.Tensor,
                      cfg: DKSConfig) -> DKSState:
    """DKS run to frontier exhaustion (``exit_mode="none"``)."""
    return run_dks(graph, kw_masks, dataclasses.replace(cfg,
                                                        exit_mode="none"))
