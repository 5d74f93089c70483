"""Synthetic graph generators (a numpy copy of ``repro.graph.generators``).

Power-law (R-MAT) entity graphs with Zipf-distributed token labels stand in
for the paper's Linked-Open-Data dumps.  Deterministic via explicit seeds:
the same seed gives the same arrays as ``repro``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph, build_graph


def rmat_edges(
    n_nodes: int,
    n_edges: int,
    seed: int = 0,
    a: float = 0.57, b: float = 0.19, c: float = 0.19,
    max_resample_rounds: int = 16,
) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT power-law edge generator (Chakrabarti et al., SDM'04).

    Self-loops are rejected and their slots resampled from the same rng
    stream, so the result carries exactly ``n_edges`` edges (except for
    pathological configs such as ``n_nodes == 1``).
    """
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n_nodes, 2))))

    def draw(n: int) -> tuple[np.ndarray, np.ndarray]:
        src = np.zeros(n, np.int64)
        dst = np.zeros(n, np.int64)
        for _level in range(scale):
            r = rng.random(n)
            # Quadrant probabilities a, b, c, d.
            go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
            go_down = r >= a + b
            src = src * 2 + go_down.astype(np.int64)
            dst = dst * 2 + go_right.astype(np.int64)
        src %= n_nodes
        dst %= n_nodes
        keep = src != dst
        return src[keep], dst[keep]

    src, dst = draw(n_edges)
    for _round in range(max_resample_rounds):
        deficit = n_edges - len(src)
        if deficit == 0:
            break
        s2, d2 = draw(max(2 * deficit, 64))
        src = np.concatenate([src, s2[:deficit]])
        dst = np.concatenate([dst, d2[:deficit]])
    return src.astype(np.int32), dst.astype(np.int32)


def lod_like_graph(
    n_nodes: int,
    n_edges: int,
    seed: int = 0,
    vocab: int = 1000,
    labels_per_node: int = 2,
    tau: int = 1001,
) -> tuple[Graph, np.ndarray]:
    """Power-law graph + Zipf token labels. Returns (graph, tokens[V, L])."""
    src, dst = rmat_edges(n_nodes, n_edges, seed=seed)
    g = build_graph(src, dst, n_nodes, tau=tau)
    rng = np.random.default_rng(seed + 1)
    # Zipf-ish token assignment: token frequency ~ 1/rank.
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    tokens = rng.choice(vocab, size=(n_nodes, labels_per_node), p=probs)
    return g, tokens.astype(np.int32)


def grid_graph(rows: int, cols: int, w: float = 1.0) -> Graph:
    """Unit-weight 2D grid (deterministic structure for exactness tests)."""
    def nid(r, c):
        return r * cols + c

    src, dst = [], []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                src.append(nid(r, c)); dst.append(nid(r, c + 1))
            if r + 1 < rows:
                src.append(nid(r, c)); dst.append(nid(r + 1, c))
    n = rows * cols
    return build_graph(src, dst, n, w=np.full(len(src), w, np.float32))


def random_weighted_graph(
    n_nodes: int, n_edges: int, seed: int = 0, max_w: int = 5
) -> Graph:
    """Random connected-ish multigraph with small integer weights (tests)."""
    rng = np.random.default_rng(seed)
    # A random spanning chain guarantees connectivity.
    perm = rng.permutation(n_nodes)
    chain_src = perm[:-1]
    chain_dst = perm[1:]
    extra = max(0, n_edges - (n_nodes - 1))
    es = rng.integers(0, n_nodes, extra)
    ed = rng.integers(0, n_nodes, extra)
    keep = es != ed
    src = np.concatenate([chain_src, es[keep]]).astype(np.int32)
    dst = np.concatenate([chain_dst, ed[keep]]).astype(np.int32)
    w = rng.integers(1, max_w + 1, len(src)).astype(np.float32)
    return build_graph(src, dst, n_nodes, w=w)
