"""Aggregator-side answer-tree reconstruction (the paper's ``V_K`` role).

The device loop produces the final table ``S[V, 2^m, K]``; answer *weights*
and *roots* are known on-device.  Recovering the actual answer-trees — and
deduplicating / re-ranking them exactly like the paper's ``A_A`` aggregator —
is the only genuinely ragged computation in DKS, so it runs on the host
(= Pregel master) against the final table:

  backtrace(v, ks, val):
    - singleton at a keyword node with val==0        -> leaf
    - val == S[u, ks, j] + w(u,v) for a neighbor u   -> tree edge (u,v)
    - val == S[v, a, i] + S[v, b, j], a ⊎ b = ks     -> split at v

Backtraced trees may be non-minimal (a branch's keyword may already be
covered elsewhere, paper Def. 2.1); :func:`prune_non_minimal` removes
redundant branches, the true weight is recomputed over the deduped edge set,
and identical trees found at different roots collapse.

A numpy copy of ``repro.core.reconstruct``: the port hands it the final
table as a host array, or (``collect_answers``' ``scan`` and
``backtrace_fn``) the device-sorted order and decomposition records of
:mod:`repro_torch.answers.batched`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch import INF
from repro_torch.graph.structure import Graph

_TOL = 1e-3


@dataclasses.dataclass(frozen=True)
class AnswerTree:
    root: int
    edges: tuple[tuple[int, int], ...]   # undirected, (min,max)-normalized
    weight: float
    raw_value: float                     # DP value before dedupe/prune
    nodes: tuple[int, ...]

    def key(self) -> tuple:
        return self.edges if self.edges else (("node", self.nodes),)


def _edge_weight(g: Graph, u: int, v: int) -> float:
    nbrs, ws = g.neighbors(u)
    hits = ws[nbrs == v]
    return float(hits.min()) if len(hits) else float(INF)


def backtrace(
    S: np.ndarray,
    g: Graph,
    kw_masks: np.ndarray,
    root: int,
    ks: int,
    val: float,
    _depth: int = 0,
) -> list[tuple[int, int]] | None:
    """Recover one tree achieving DP value ``val`` for keyword-set ``ks`` at
    ``root``.  Returns a list of undirected edges, or None if no exact
    decomposition exists (can happen for K>1 slots whose value is a walk
    artifact — callers simply drop those candidates)."""
    if _depth > 10_000:
        return None
    m = kw_masks.shape[0]
    if val <= _TOL and all(
        kw_masks[i, root] for i in range(m) if ks >> i & 1
    ):
        return []
    # Split decompositions at the root.
    a = (ks - 1) & ks
    while a:
        b = ks ^ a
        if a <= b:
            for i in range(S.shape[2]):
                va = S[root, a, i]
                if va > val + _TOL or va >= INF:
                    break
                for j in range(S.shape[2]):
                    vb = S[root, b, j]
                    if vb >= INF:
                        break
                    if abs(va + vb - val) <= _TOL:
                        left = backtrace(S, g, kw_masks, root, a, float(va), _depth + 1)
                        if left is None:
                            continue
                        right = backtrace(S, g, kw_masks, root, b, float(vb), _depth + 1)
                        if right is None:
                            continue
                        return left + right
        a = (a - 1) & ks
    # Edge decompositions, in the scalar scan's order: neighbours in CSR
    # order, slots until the first INF.  The tests are one numpy pass per
    # node (a hub has thousands of neighbours); each comparison is the
    # scalar one's, in f32 — NumPy 2 casts a Python float operand to the
    # array's f32, as it does for an f32 scalar.
    nbrs, ws = g.neighbors(root)
    keep = (ws < INF) & (ws <= val + _TOL)
    if keep.any():
        us = nbrs[keep].astype(np.int64)
        target = (val - ws[keep].astype(np.float64)).astype(np.float32)
        Su = S[us, ks, :]
        alive = np.cumprod(Su < INF, axis=1).astype(bool)
        match = alive & (np.abs(Su - target[:, None]) <= _TOL)
        for d, j in zip(*np.nonzero(match)):
            u = int(us[d])
            sub = backtrace(S, g, kw_masks, u, ks, float(Su[d, j]),
                            _depth + 1)
            if sub is not None:
                return sub + [(min(root, u), max(root, u))]
    return None


def prune_non_minimal(
    edges: Sequence[tuple[int, int]],
    kw_masks: np.ndarray,
    root: int,
) -> list[tuple[int, int]]:
    """Iteratively remove leaf branches not needed for keyword coverage
    (paper Def. 2.1 minimality).  The root is *not* exempt: a root that is
    itself a redundant leaf makes the tree non-minimal — after pruning it,
    the answer collapses onto the tree it contained (and dedupes there)."""
    edges = list(dict.fromkeys(edges))  # dedupe, keep order
    m = kw_masks.shape[0]
    while True:
        if not edges:
            return edges
        deg: dict[int, int] = {}
        for u, v in edges:
            deg[u] = deg.get(u, 0) + 1
            deg[v] = deg.get(v, 0) + 1
        nodes = set(deg)
        removed = False
        for leaf in [n for n, d in deg.items() if d == 1]:
            rest = nodes - {leaf}
            if all(any(kw_masks[i, n] for n in rest) for i in range(m)):
                edges = [e for e in edges if leaf not in e]
                removed = True
                break
        if not removed:
            return edges


def _spanning_tree(edges: list[tuple[int, int]], g: Graph) -> list[tuple[int, int]]:
    """Kruskal MST over the (possibly cyclic) union subgraph.

    Backtraced walk-unions can contain cycles; any answer tree inside the
    union with pruned leaves is a valid minimal answer, so we take the MST
    (cheapest spanning structure) and let the caller re-prune."""
    weighted = sorted(((_edge_weight(g, u, v), u, v) for u, v in edges))
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    out = []
    for w, u, v in weighted:
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
            out.append((u, v))
    return out


def finish_tree(
    edges: list[tuple[int, int]],
    g: Graph,
    kw_masks: np.ndarray,
    root: int,
    raw_value: float,
) -> AnswerTree:
    """Backtraced edge list -> finished :class:`AnswerTree`: prune to
    minimal, cycle-repair, recompute the true weight over the deduped edge
    set, re-root if the root itself was pruned."""
    orig_nodes = {n for e in edges for n in e}
    edges = prune_non_minimal(edges, kw_masks, root)
    # A walk-union may contain cycles: reduce to a spanning tree of the
    # union and re-prune (paper's V_K-based extraction never produces
    # cycles; this is our equivalent repair at the aggregator).
    if len({n for e in edges for n in e}) != len(edges) + (1 if edges else 0):
        edges = _spanning_tree(list(dict.fromkeys(edges)), g)
        edges = prune_non_minimal(edges, kw_masks, root)
    m = kw_masks.shape[0]
    if not edges and orig_nodes and not all(kw_masks[i, root]
                                            for i in range(m)):
        # Pruning collapsed the whole tree: the last prune left a single
        # node covering every keyword.  Re-root onto (a deterministic)
        # such survivor — keeping the original root would report a
        # zero-weight "tree" that covers nothing.
        root = min(c for c in orig_nodes
                   if all(kw_masks[i, c] for i in range(m)))
    weight = sum(_edge_weight(g, u, v) for u, v in edges)
    tree_nodes = {n for e in edges for n in e}
    if edges and root not in tree_nodes:
        # Root pruned away as a redundant leaf: re-root at the highest
        # degree remaining node (the connection node of what is left).
        degc: dict[int, int] = {}
        for u, v in edges:
            degc[u] = degc.get(u, 0) + 1
            degc[v] = degc.get(v, 0) + 1
        root = max(degc, key=degc.get)
    nodes = tuple(sorted(tree_nodes | {root}))
    return AnswerTree(
        root=root, edges=tuple(sorted(edges)), weight=round(weight, 6),
        raw_value=raw_value, nodes=nodes,
    )


class HostScan:
    """The collector's default scan: the full-set column's cells
    ``[V, K]`` in *stable* value-ascending order (ties at the lower cell
    index first), argsorted on the host.  ``scan[pos]`` is the
    ``(root, value)`` of the ``pos``-th cell; ``len(scan)`` counts every
    cell."""

    def __init__(self, column: np.ndarray) -> None:
        self.k = column.shape[1]
        self.flat = column.reshape(-1)
        # Stable: equal values scan in cell-index order (argpartition
        # would pick an arbitrary representative set at the window
        # boundary).
        self.order = np.argsort(self.flat, kind="stable")

    def __len__(self) -> int:
        return len(self.order)

    def __getitem__(self, pos: int) -> tuple[int, float]:
        fi = int(self.order[pos])
        return fi // self.k, float(self.flat[fi])


def collect_answers(
    S: np.ndarray | None,
    g: Graph,
    kw_masks: np.ndarray,
    k: int,
    candidate_factor: int = 4,
    backtrace_fn=None,
    scan=None,
) -> tuple[list[AnswerTree], bool]:
    """Global top-K minimal answer-trees from the final DP table, with an
    exhaustion flag.

    Mirrors the paper's aggregator A_A: collect candidate (root, value)
    pairs in a *stable* value-ascending order (ties broken by cell index,
    so host and device candidate selection agree bit-for-bit),
    reconstruct, prune to minimal, recompute true weights over the deduped
    edge set, drop duplicates, re-rank.

    Every candidate of the initial ``k * candidate_factor`` window is
    processed (recomputed weights can re-rank past the k-th tree).  When
    dedup / failed backtraces collapse that pool below ``k`` distinct
    trees, the scan *refills*: it keeps walking the value-ordered table
    until ``k`` distinct trees exist or the finite candidates run out.
    Returns ``(ranked[:k], exhausted)`` — ``exhausted`` is True when the
    table holds fewer than ``k`` distinct trees in total.

    ``backtrace_fn(pos, root, val)``: optional override returning an edge
    list (or None) for the candidate at scan position ``pos`` — the hook
    a device-batched backtracer plugs in; the default is the host
    :func:`backtrace`.  ``scan``: optional source of that order, indexed
    like :class:`HostScan` (the default, over ``S``'s full-set column) —
    the device-sorted order a batched backtracer hands in.  With both
    given, ``S`` is not read and may be None.
    """
    m = kw_masks.shape[0]
    full = (1 << m) - 1
    if scan is None:
        scan = HostScan(S[:, full, :])
    if backtrace_fn is None:
        def backtrace_fn(pos: int, root: int, val: float):
            return backtrace(S, g, kw_masks, root, full, val)
    n_cells = len(scan)
    window = min(n_cells, max(k, 1) * candidate_factor)
    answers: dict[tuple, AnswerTree] = {}
    pos = 0
    while pos < n_cells:
        if pos >= window and len(answers) >= k:
            break
        root, val = scan[pos]
        if val >= INF:
            break
        edges = backtrace_fn(pos, root, val)
        pos += 1
        if edges is None:
            continue
        tree = finish_tree(edges, g, kw_masks, root, val)
        answers.setdefault(tree.key(), tree)
    ranked = sorted(answers.values(), key=lambda t: (t.weight, t.root))
    return ranked[:k], len(answers) < k


def extract_answers(
    S: np.ndarray,
    g: Graph,
    kw_masks: np.ndarray,
    k: int,
    candidate_factor: int = 4,
) -> list[AnswerTree]:
    """:func:`collect_answers` without the exhaustion flag (the original
    aggregator surface; kept for callers that only want the trees)."""
    answers, _ = collect_answers(S, g, kw_masks, k, candidate_factor)
    return answers
