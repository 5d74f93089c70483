"""Fanout neighbor sampler (GraphSAGE-style) for the ``minibatch_lg`` shape.

Produces fixed-shape padded subgraphs (seed nodes + per-hop sampled
neighbors): node ids int32[N_sub], edge list int32[E_sub], valid masks.
Sampling runs on the host (numpy); the returned arrays are what a GNN train
step consumes once gathered to the device.  A numpy copy of
``repro.graph.sampler``: the same generator draws in the same order, so
the arrays are equal to ``repro``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import Graph


@dataclasses.dataclass
class SampledSubgraph:
    node_ids: np.ndarray    # int32[N_sub] global ids (0-padded)
    node_valid: np.ndarray  # bool[N_sub]
    edge_src: np.ndarray    # int32[E_sub] local indices into node_ids
    edge_dst: np.ndarray    # int32[E_sub]
    edge_valid: np.ndarray  # bool[E_sub]
    seed_count: int         # first seed_count nodes are the batch seeds

    @property
    def n_sub(self) -> int:
        return len(self.node_ids)


def plan_sizes(batch_nodes: int, fanout: list[int]) -> tuple[int, int]:
    """Padded (n_nodes, n_edges) of a fanout sample."""
    n = batch_nodes
    total_nodes = batch_nodes
    total_edges = 0
    for f in fanout:
        total_edges += n * f
        n = n * f
        total_nodes += n
    return total_nodes, total_edges


def sample_subgraph(
    g: Graph,
    seeds: np.ndarray,
    fanout: list[int],
    seed: int = 0,
) -> SampledSubgraph:
    """Uniform fanout sampling with replacement; fixed output shapes."""
    rng = np.random.default_rng(seed)
    n_pad, e_pad = plan_sizes(len(seeds), fanout)

    node_ids = np.zeros(n_pad, np.int32)
    node_valid = np.zeros(n_pad, bool)
    edge_src = np.zeros(e_pad, np.int32)
    edge_dst = np.zeros(e_pad, np.int32)
    edge_valid = np.zeros(e_pad, bool)

    node_ids[: len(seeds)] = seeds
    node_valid[: len(seeds)] = True
    frontier_lo, frontier_hi = 0, len(seeds)
    n_cursor, e_cursor = len(seeds), 0

    deg = np.diff(g.indptr)
    for f in fanout:
        width = frontier_hi - frontier_lo
        for i in range(frontier_lo, frontier_hi):
            v = int(node_ids[i])
            valid_v = bool(node_valid[i])
            d = int(deg[v]) if valid_v else 0
            for j in range(f):
                slot_n = n_cursor + (i - frontier_lo) * f + j
                slot_e = e_cursor + (i - frontier_lo) * f + j
                if d > 0:
                    pick = g.indices[g.indptr[v] + rng.integers(0, d)]
                    node_ids[slot_n] = pick
                    node_valid[slot_n] = True
                    edge_src[slot_e] = slot_n
                    edge_dst[slot_e] = i
                    edge_valid[slot_e] = True
        n_cursor += width * f
        e_cursor += width * f
        frontier_lo, frontier_hi = n_cursor - width * f, n_cursor
    return SampledSubgraph(
        node_ids=node_ids, node_valid=node_valid,
        edge_src=edge_src, edge_dst=edge_dst, edge_valid=edge_valid,
        seed_count=len(seeds),
    )
