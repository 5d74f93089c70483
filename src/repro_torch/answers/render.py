"""Servable answer-tree payloads: label rendering and pagination.

An :class:`~repro_torch.core.reconstruct.AnswerTree` is raw node ids —
fine for parity tests, useless for a client.  This module turns trees into
explanations: entity labels (the engine's ``node_label``), per-edge
weights, and a cursor-paginated page over a ranked list.  Host code, a
copy of ``repro.answers.render``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core.reconstruct import AnswerTree, _edge_weight
from repro_torch.graph.structure import Graph


@dataclasses.dataclass(frozen=True)
class RenderedEdge:
    u: int
    v: int
    u_label: str
    v_label: str
    weight: float
    # Provenance of the effective edge (typed graphs only): the predicate
    # name and confidence of the cheapest parallel entry — the one the
    # backtrace resolved.  None / 1.0 on untyped graphs.
    predicate: str | None = None
    confidence: float = 1.0


@dataclasses.dataclass(frozen=True)
class RenderedTree:
    """One label-rendered answer: the interconnection among the query
    entities, as served to a client."""

    root: int
    root_label: str
    weight: float
    nodes: tuple[int, ...]
    node_labels: tuple[str, ...]
    edges: tuple[RenderedEdge, ...]

    def describe(self) -> str:
        """One-line human rendering: root, weight, then each edge as
        ``label --w-- label`` (``label --w[predicate]-- label`` on typed
        graphs)."""
        if not self.edges:
            return f"[{self.weight:.3f}] {self.root_label} (single node)"

        def _edge(e: RenderedEdge) -> str:
            tag = f"{e.weight:.2f}"
            if e.predicate is not None:
                tag += f"[{e.predicate}]"
            return f"{e.u_label} --{tag}-- {e.v_label}"

        parts = " ; ".join(_edge(e) for e in self.edges)
        return f"[{self.weight:.3f}] root={self.root_label}: {parts}"


@dataclasses.dataclass(frozen=True)
class TreePage:
    """One page of ranked trees plus the cursor protocol.

    ``cursor`` is the rank offset this page starts at; ``next_cursor`` is
    None on the last page.  ``ranking`` records which order the cursor
    walks ("weight" or "diverse"); ``exhausted`` mirrors the collector's
    flag (True when the table holds fewer distinct trees than requested).
    """

    items: tuple[RenderedTree, ...]
    cursor: int
    next_cursor: int | None
    total: int
    ranking: str
    exhausted: bool


def default_label(v: int) -> str:
    return f"node:{v}"


def render_tree(
    tree: AnswerTree,
    label_fn: Callable[[int], str] | None = None,
    graph: Graph | None = None,
) -> RenderedTree:
    """Label-render one tree.  ``label_fn`` maps node id -> entity string
    (default ``node:<id>``); ``graph`` supplies true per-edge weights
    (omitted -> edge weights rendered as 0) and, when typed, the
    provenance tag (predicate name + confidence) of each effective edge.
    """
    label_fn = label_fn or default_label

    def _render_edge(u: int, v: int) -> RenderedEdge:
        weight = 0.0
        predicate: str | None = None
        confidence = 1.0
        if graph is not None:
            weight = round(_edge_weight(graph, u, v), 6)
            info = graph.edge_channel(u, v)
            if info is not None:
                predicate, confidence = info
        return RenderedEdge(
            u=u, v=v, u_label=label_fn(u), v_label=label_fn(v),
            weight=weight, predicate=predicate, confidence=confidence)

    edges = tuple(_render_edge(u, v) for u, v in tree.edges)
    return RenderedTree(
        root=tree.root,
        root_label=label_fn(tree.root),
        weight=tree.weight,
        nodes=tree.nodes,
        node_labels=tuple(label_fn(n) for n in tree.nodes),
        edges=edges,
    )


def paginate(
    trees: Sequence[AnswerTree],
    order: Sequence[int],
    cursor: int,
    page_size: int,
    ranking: str,
    exhausted: bool,
    label_fn: Callable[[int], str] | None = None,
    graph: Graph | None = None,
) -> TreePage:
    """Cut one :class:`TreePage` out of a ranked permutation.

    ``order`` is a permutation of ``range(len(trees))`` (from
    :func:`repro_torch.answers.diversified_order` or ``range(n)`` for weight
    order); ``cursor`` indexes into that permutation.  Rendering happens
    per page — only the served slice pays the label lookups."""
    total = len(order)
    cursor = max(0, min(int(cursor), total))
    page_size = max(1, int(page_size))
    sel = order[cursor:cursor + page_size]
    items = tuple(render_tree(trees[i], label_fn, graph) for i in sel)
    nxt = cursor + len(sel)
    return TreePage(
        items=items,
        cursor=cursor,
        next_cursor=nxt if nxt < total else None,
        total=total,
        ranking=ranking,
        exhausted=exhausted,
    )
