"""Exact Group-Steiner-Tree oracles (host-side, small graphs) for tests.

A numpy copy of ``repro.core.steiner_ref``.

- :func:`dreyfus_wagner` — textbook exact optimum (Dijkstra-based DW DP),
  independent of the DKS engine's tensor formulation.
- :func:`brute_force_topk` — enumerates *all minimal answer-trees* on tiny
  graphs (paper Def. 2.1/2.2) and returns the top-K distinct weights.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Sequence

import numpy as np

from repro_torch import INF
from repro_torch.graph.structure import Graph


def _multi_source_dijkstra(g: Graph, sources: Sequence[int]) -> np.ndarray:
    dist = np.full(g.n_nodes, INF, np.float64)
    heap = []
    for s in sources:
        dist[s] = 0.0
        heap.append((0.0, int(s)))
    heapq.heapify(heap)
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        nbrs, ws = g.neighbors(v)
        for u, w in zip(nbrs, ws):
            if w >= INF:
                continue
            nd = d + float(w)
            if nd < dist[u]:
                dist[u] = nd
                heapq.heappush(heap, (nd, int(u)))
    return dist


def _dijkstra_settle(g: Graph, init: np.ndarray) -> np.ndarray:
    """Settle arbitrary initial labels to shortest-path closure."""
    dist = init.copy()
    heap = [(float(d), int(v)) for v, d in enumerate(dist) if d < INF]
    heapq.heapify(heap)
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        nbrs, ws = g.neighbors(v)
        for u, w in zip(nbrs, ws):
            if w >= INF:
                continue
            nd = d + float(w)
            if nd < dist[u]:
                dist[u] = nd
                heapq.heappush(heap, (nd, int(u)))
    return dist


def dreyfus_wagner(g: Graph, groups: Sequence[Sequence[int]]) -> float:
    """Exact minimum Group Steiner Tree weight (INF if infeasible)."""
    m = len(groups)
    full = (1 << m) - 1
    dp = np.full((full + 1, g.n_nodes), INF, np.float64)
    for i, grp in enumerate(groups):
        if len(grp) == 0:
            return float(INF)
        dp[1 << i] = _multi_source_dijkstra(g, grp)
    masks = sorted(range(1, full + 1), key=lambda t: bin(t).count("1"))
    for t in masks:
        if bin(t).count("1") == 1:
            continue
        a = (t - 1) & t
        while a:
            b = t ^ a
            if a <= b:
                dp[t] = np.minimum(dp[t], dp[a] + dp[b])
            a = (a - 1) & t
        dp[t] = _dijkstra_settle(g, np.minimum(dp[t], INF))
    best = dp[full].min()
    return float(best if best < INF else INF)


def _is_tree(n_nodes_in_tree: int, edges: list[tuple[int, int]]) -> bool:
    if len(edges) != n_nodes_in_tree - 1:
        return False
    # Connectivity via union-find.
    parent: dict[int, int] = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in edges:
        ru, rv = find(u), find(v)
        if ru == rv:
            return False
        parent[ru] = rv
    return True


def brute_force_topk(
    g: Graph, groups: Sequence[Sequence[int]], k: int,
    max_edges: int | None = None,
) -> list[float]:
    """Top-K distinct weights over all *minimal* answer-trees (tiny graphs).

    Enumerates every subset of the symmetrized unique undirected edges whose
    induced subgraph is a tree covering all groups and is minimal (every leaf
    is required for coverage).
    """
    # Unique undirected edges with min weight.
    seen: dict[tuple[int, int], float] = {}
    for v in range(g.n_nodes):
        nbrs, ws = g.neighbors(v)
        for u, w in zip(nbrs, ws):
            if w >= INF:
                continue
            key = (min(v, int(u)), max(v, int(u)))
            if key not in seen or w < seen[key]:
                seen[key] = float(w)
    edges = list(seen.items())
    if max_edges is not None and len(edges) > max_edges:
        raise ValueError(f"graph too large for brute force: {len(edges)} edges")

    group_sets = [set(map(int, grp)) for grp in groups]
    weights: set[float] = set()

    # Single-node answers (a node containing every keyword).
    common = set(range(g.n_nodes))
    for gs in group_sets:
        common &= gs
    if common:
        weights.add(0.0)

    for r in range(1, len(edges) + 1):
        for combo in itertools.combinations(edges, r):
            es = [e for e, _ in combo]
            nodes = set()
            for u, v in es:
                nodes.add(u)
                nodes.add(v)
            if not _is_tree(len(nodes), es):
                continue
            if not all(nodes & gs for gs in group_sets):
                continue
            # Minimality: every leaf must be essential for coverage.
            deg: dict[int, int] = {}
            for u, v in es:
                deg[u] = deg.get(u, 0) + 1
                deg[v] = deg.get(v, 0) + 1
            minimal = True
            for leaf in [n for n, d in deg.items() if d == 1]:
                rest = nodes - {leaf}
                if all(rest & gs for gs in group_sets):
                    minimal = False
                    break
            if minimal:
                weights.add(round(sum(w for _, w in combo), 6))
    out = sorted(weights)[:k]
    return out + [float(INF)] * (k - len(out))
