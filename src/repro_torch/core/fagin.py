"""Fagin-style exit criteria (paper Sec. 6 / Theorem 1) — a copy of
``repro.core.fagin``.

The paper's literal Eq. 2 needs, per keyword-set, the largest
*constituent* path-length among the global top-K answers (``L_n``), which
requires decomposing each answer tree.  In Giraph this runs in the master
between supersteps; here it is a host-side ``exit_hook`` for
:func:`repro_torch.core.dks.run_dks_instrumented` and its sharded twin
(``QueryEngine.query_instrumented`` on either partitioning, one process
or one shard a rank).

The driver's own exit is the sound on-device bound of
``spa.nu_lower_bound``; the tests check that neither criterion ever misses
an optimum.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch import INF
from repro_torch.core.dks import DKSConfig, DKSState, node_rows
from repro_torch.graph.structure import Graph


def constituent_lengths(
    S: np.ndarray,
    g: Graph,
    kw_masks: np.ndarray,
    root: int,
    val: float,
) -> dict[int, float]:
    """Top-level decomposition of an answer at ``root`` into constituent
    keyword-sets and their path-lengths (the ``L`` set of Step 3).
    ``S``: node tables [rows, 2^m, K] on the host, of which only row
    ``root`` is read."""
    m = kw_masks.shape[0]
    full = (1 << m) - 1
    out: dict[int, float] = {}

    def walk(ks: int, v: float):
        # Prefer splits at the root: constituents are the split leaves.
        a = (ks - 1) & ks
        while a:
            b = ks ^ a
            if a <= b:
                for i in range(S.shape[2]):
                    va = float(S[root, a, i])
                    if va >= INF or va > v + 1e-3:
                        break
                    for j in range(S.shape[2]):
                        vb = float(S[root, b, j])
                        if vb >= INF:
                            break
                        if abs(va + vb - v) <= 1e-3:
                            walk(a, va)
                            walk(b, vb)
                            return
            a = (a - 1) & ks
        out[ks] = max(out.get(ks, 0.0), v)

    walk(full, val)
    return out


def paper_exit_hook(g: Graph, kw_masks: np.ndarray, cfg: DKSConfig,
                    e_min: float, graph: Any = None):
    """Literal paper Eq. 2: exit when for every keyword-set with an entry in
    L_n, the estimated next-superstep frontier minimum exceeds it.  The
    hook reads lane 0 of the 1-lane state the instrumented loop hands it,
    and of its table only the rows of the top-K roots.  ``graph``: the
    device graph the state runs on; on a
    :class:`~repro_torch.core.dks_sharded.FrontierGraph` split across
    ranks the roots' rows come over its mesh, so every rank answers the
    same."""

    def hook(state: DKSState) -> bool:
        topk_w = state.topk_w[0].cpu().numpy()
        topk_root = state.topk_root[0].cpu().numpy()
        if np.sum(topk_w < INF) < cfg.k:
            return False
        if graph is None and state.S.shape[1] < g.n_nodes:
            raise ValueError(
                "the state holds some of the node rows: pass graph=, the "
                "device graph split across ranks")
        roots = sorted({int(r) for w, r in zip(topk_w, topk_root)
                        if w < INF and r >= 0})
        rows = node_rows(graph, state.S[0], roots).cpu().numpy()
        L: dict[int, float] = {}
        for w, r in zip(topk_w, topk_root):
            if w >= INF or r < 0:
                continue
            for ks, ln in constituent_lengths(rows, g, kw_masks,
                                              roots.index(int(r)),
                                              float(w)).items():
                L[ks] = max(L.get(ks, 0.0), ln)
        s_front = state.s_front[0].cpu().numpy()
        shat = np.minimum(s_front + e_min, INF)
        return all(shat[ks] > ln for ks, ln in L.items())

    return hook
