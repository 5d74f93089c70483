"""Diversified ranking over answer trees.

Weight-ranked top-K often returns K near-copies of the best tree (one
swapped leaf each).  Following the duplication-free top-K of "Effective
Keyword Search in Graphs" and KlusTree-style clustering (PAPERS.md), this
module re-orders a weight-ranked candidate list so the head of the list
covers *distinct* explanations:

- :func:`tree_distance` — Jaccard distance over the trees' node∪edge sets;
- :func:`diversified_order` — greedy maximal-marginal-relevance (MMR)
  permutation of the whole list (serving paginates over it);
- :func:`top_k_diverse` — the first ``k`` of that permutation;
- :func:`cluster_trees` — greedy leader clustering (each tree joins the
  first representative within ``threshold`` distance).

Everything here is pure host-side set algebra over already-extracted
trees; ranking never re-touches the device.  A copy of
``repro.answers.diversify``.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.reconstruct import AnswerTree


def _elements(tree: AnswerTree) -> frozenset:
    """The comparable identity of a tree: its nodes plus its edges (edges
    tagged so an edge (u, v) never collides with node ids)."""
    return frozenset(tree.nodes) | frozenset(("e", u, v) for u, v in tree.edges)


def tree_distance(a: AnswerTree, b: AnswerTree) -> float:
    """Jaccard distance over node∪edge sets: 0 = identical structure,
    1 = disjoint."""
    ea, eb = _elements(a), _elements(b)
    union = len(ea | eb)
    if union == 0:
        return 0.0
    return 1.0 - len(ea & eb) / union


def diversified_order(
    trees: Sequence[AnswerTree],
    lambda_: float = 0.5,
) -> list[int]:
    """Greedy MMR permutation of ``trees`` (assumed weight-ranked, best
    first).

    At each step pick the unselected tree maximizing
    ``lambda_ * relevance - (1 - lambda_) * max_similarity_to_selected``
    where relevance is the (normalized) inverse weight rank and similarity
    is ``1 - tree_distance``.  ``lambda_=1`` reproduces the input order;
    ``lambda_=0`` is pure farthest-point diversification.  Returns a full
    permutation of indices so callers can paginate without re-ranking.
    """
    n = len(trees)
    if n == 0:
        return []
    if not 0.0 <= lambda_ <= 1.0:
        raise ValueError(f"lambda_ must be in [0, 1], got {lambda_}")
    # Relevance from rank, not raw weight: scale-free across graphs.
    rel = [1.0 - i / n for i in range(n)]
    selected: list[int] = [0]  # the best tree always leads
    remaining = list(range(1, n))
    max_sim = {i: 1.0 - tree_distance(trees[i], trees[0]) for i in remaining}
    while remaining:
        best, best_score = None, None
        for i in remaining:
            score = lambda_ * rel[i] - (1.0 - lambda_) * max_sim[i]
            if best_score is None or score > best_score:
                best, best_score = i, score
        remaining.remove(best)
        selected.append(best)
        for i in remaining:
            sim = 1.0 - tree_distance(trees[i], trees[best])
            if sim > max_sim[i]:
                max_sim[i] = sim
    return selected


def top_k_diverse(
    trees: Sequence[AnswerTree],
    k: int,
    lambda_: float = 0.5,
) -> list[AnswerTree]:
    """The ``k`` most representative trees of a weight-ranked list (MMR
    order; see :func:`diversified_order`)."""
    order = diversified_order(trees, lambda_)
    return [trees[i] for i in order[: max(k, 0)]]


def cluster_trees(
    trees: Sequence[AnswerTree],
    threshold: float = 0.5,
) -> list[list[int]]:
    """Greedy leader clustering: scan in rank order; each tree joins the
    cluster of the first representative within ``threshold`` Jaccard
    distance, else founds a new cluster.  Returns clusters as index lists
    (cluster leaders are the answer-set's distinct explanations)."""
    clusters: list[list[int]] = []
    for i, t in enumerate(trees):
        for members in clusters:
            if tree_distance(t, trees[members[0]]) <= threshold:
                members.append(i)
                break
        else:
            clusters.append([i])
    return clusters
