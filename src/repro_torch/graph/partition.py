"""Node partitioning (the Pregel worker hash map).

Partitioning is a *relabeling*: nodes are permuted so that contiguous
blocks of size V/P land on each shard, edges are regrouped by destination
shard (messages to a shard are then a contiguous segment).  A numpy copy
of ``repro.graph.partition``, with equal outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import Graph, build_graph


@dataclasses.dataclass
class Partition:
    n_shards: int
    perm: np.ndarray       # new id -> old id
    inv_perm: np.ndarray   # old id -> new id
    shard_of: np.ndarray   # new id -> shard

    def relabel(self, node_ids: np.ndarray) -> np.ndarray:
        return self.inv_perm[node_ids]


def hash_partition(n_nodes: int, n_shards: int, seed: int = 0) -> Partition:
    """Pregel-style hash partition: random permutation, contiguous blocks."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_nodes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_nodes)
    block = -(-n_nodes // n_shards)
    shard_of = np.arange(n_nodes) // block
    return Partition(n_shards=n_shards, perm=perm, inv_perm=inv,
                     shard_of=shard_of.astype(np.int32))


def edge_cut(g: Graph, part: Partition) -> float:
    """Fraction of symmetric edges crossing shards (drives the collective
    term of the DKS roofline)."""
    deg = np.diff(g.indptr)
    src = np.repeat(np.arange(g.n_nodes), deg)
    dst = g.indices
    s_src = part.shard_of[part.inv_perm[src]]
    s_dst = part.shard_of[part.inv_perm[dst]]
    if len(src) == 0:
        return 0.0
    return float(np.mean(s_src != s_dst))


def apply_partition(g: Graph, part: Partition) -> Graph:
    """Relabel a host graph so device sharding = partition blocks."""
    new_src = part.inv_perm[g.src]
    new_dst = part.inv_perm[g.dst]
    labels = None
    if g.labels is not None:
        labels = [g.labels[part.perm[i]] for i in range(g.n_nodes)]
    return build_graph(new_src, new_dst, g.n_nodes, w=g.w, labels=labels)
