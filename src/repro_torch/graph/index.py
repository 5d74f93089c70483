"""Inverted index: token -> keyword-node ids (paper Sec. 4 pre-processing).

A numpy copy of ``repro.graph.index``: DKS starts from the keyword-nodes of
every query keyword, and this is the index that produces them.
"""

from __future__ import annotations

import numpy as np


def mid_df_tokens(index: "InvertedIndex", lo: int = 2,
                  hi: int = 200) -> list:
    """df-sorted vocabulary slice with ``lo <= df <= hi`` (the full
    df-sorted vocabulary when the band is empty)."""
    pairs = sorted(index.token_dfs(), key=lambda p: p[1])
    mid = [t for t, d in pairs if lo <= d <= hi]
    return mid or [t for t, _ in pairs]


class InvertedIndex:
    def __init__(self) -> None:
        self._post: dict[object, list[int]] = {}
        self._frozen: dict[object, np.ndarray] = {}

    @classmethod
    def from_token_matrix(cls, tokens: np.ndarray) -> "InvertedIndex":
        """tokens: int[V, L] token ids per node."""
        idx = cls()
        v, l = tokens.shape
        flat = tokens.reshape(-1)
        nodes = np.repeat(np.arange(v, dtype=np.int64), l)
        order = np.argsort(flat, kind="stable")
        flat, nodes = flat[order], nodes[order]
        bounds = np.flatnonzero(np.diff(flat)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(flat)]])
        for s, e in zip(starts, ends):
            idx._frozen[int(flat[s])] = np.unique(nodes[s:e]).astype(np.int32)
        return idx

    @classmethod
    def from_labels(cls, labels: list[str]) -> "InvertedIndex":
        idx = cls()
        for node, text in enumerate(labels):
            for tok in text.lower().split():
                idx._post.setdefault(tok, []).append(node)
        for tok, nodes in idx._post.items():
            idx._frozen[tok] = np.unique(np.asarray(nodes, np.int32))
        idx._post.clear()
        return idx

    def lookup(self, token) -> np.ndarray:
        return self._frozen.get(token, np.zeros(0, np.int32))

    def missing_tokens(self, query: list) -> list:
        """Tokens of ``query`` that match no node."""
        return [tok for tok in query if len(self.lookup(tok)) == 0]

    def keyword_masks(
        self, query: list, n_nodes: int, v_pad: int | None = None,
        on_missing: str = "raise",
    ) -> np.ndarray:
        """bool[m, v_pad or n_nodes] — keyword-node masks for a query.
        ``on_missing="raise"`` raises :class:`KeyError` naming tokens that
        match no node; ``"ignore"`` gives all-False rows for them."""
        if on_missing not in ("raise", "ignore"):
            raise ValueError(f"unknown on_missing={on_missing!r}")
        width = n_nodes if v_pad is None else v_pad
        if width < n_nodes:
            raise ValueError(f"v_pad={v_pad} smaller than n_nodes={n_nodes}")
        if on_missing == "raise":
            missing = self.missing_tokens(query)
            if missing:
                raise KeyError(
                    f"query keywords match no node in the index: {missing!r} "
                    "(pass on_missing='ignore' for best-effort masks)")
        masks = np.zeros((len(query), width), bool)
        for i, tok in enumerate(query):
            masks[i, self.lookup(tok)] = True
        return masks

    def vocabulary(self) -> list:
        return list(self._frozen)

    def df(self, token) -> int:
        return len(self.lookup(token))

    def token_dfs(self) -> list[tuple]:
        """All ``(token, df)`` pairs in one pass."""
        return [(tok, len(post)) for tok, post in self._frozen.items()]

    def to_postings(self) -> tuple[list, np.ndarray, np.ndarray]:
        """Frozen postings as flat arrays ``(tokens, offsets, nodes)``:
        sorted vocabulary; token ``i``'s postings are
        ``nodes[offsets[i]:offsets[i+1]]`` (int32, sorted unique)."""
        tokens = sorted(self._frozen)
        offsets = np.zeros(len(tokens) + 1, np.int64)
        for i, tok in enumerate(tokens):
            offsets[i + 1] = offsets[i] + len(self._frozen[tok])
        nodes = (np.concatenate([self._frozen[t] for t in tokens])
                 if tokens else np.zeros(0, np.int32))
        return tokens, offsets, nodes.astype(np.int32, copy=False)

    @classmethod
    def from_postings(cls, tokens: list, offsets: np.ndarray,
                      nodes: np.ndarray) -> "InvertedIndex":
        """Rebuild an index from :meth:`to_postings` arrays (posting lists
        are views into ``nodes``)."""
        if len(offsets) != len(tokens) + 1:
            raise ValueError(
                f"offsets length {len(offsets)} != n_tokens+1 "
                f"({len(tokens) + 1})")
        idx = cls()
        for i, tok in enumerate(tokens):
            idx._frozen[tok] = nodes[offsets[i]:offsets[i + 1]]
        return idx
