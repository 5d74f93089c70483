"""Device-batched answer-tree backtrace (the paper's ``V_K`` role, on
device, for a whole lane bucket at once).

The host :func:`repro_torch.core.reconstruct.backtrace` recovers one tree
by a recursive first-match search over split decompositions (``val ==
S[v,a,i] + S[v,b,j]``, ``a ⊎ b = ks``) and edge decompositions (``val ==
S[u,ks,j] + w(u,v)``).  Per candidate that is a Python recursion of numpy
point lookups over a table that first has to reach the host.

This module runs the *same* search on the device over the final
lane-batched table ``S[L, V, 2^m, K]``, as ``repro.answers.batched`` does:

- **candidate selection**: a stable ``torch.sort`` of each lane's
  full-set column (value-ascending, ties at the lower cell index first —
  the host's stable argsort and ``lax.top_k``'s order); the first ``C``
  cells are the candidates;
- **the obligation walk**: every candidate walks a bounded obligation
  queue top-down, each obligation taking the host's first choice (leaf,
  then split, then edge), in one launch of the CUDA kernel
  (``kernels/batched_backtrace``) on ``backend="cuda"``, or its plain
  torch version on ``"torch"`` and on the CPU.

A fully resolved candidate is bit-identical to the host recursion.
Anything the bounded pass cannot prove — a dead-end obligation,
buffer overflow, a node with more neighbours than the degree window — is a
**ragged straggler**: the candidate re-runs the host ``backtrace``, so the
final answer set is always the host's.  The records are replayed on the
host into the host's exact edge order, then pruned / cycle-repaired /
deduped / ranked by the shared
:func:`repro_torch.core.reconstruct.collect_answers` collector, which
walks the device's sorted order (fetched in chunks) instead of sorting
the table again.  The host search of a straggler reads its lane's table
through :class:`LaneRows`, which copies only the rows the search visits
(a lane's table is 1.55 GB at bluk-bnb scale, m = 3, K = 3).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import INF
from repro_torch.core.dks import BACKENDS
from repro_torch.core.reconstruct import AnswerTree, backtrace, collect_answers
from repro_torch.device import host_tensor, resolve_device
from repro_torch.graph.structure import Graph
from repro_torch.kernels.batched_backtrace import ops as bt_ops
from repro_torch.kernels.batched_backtrace.ref import (EDGE, LEAF, SPLIT,
                                                       batched_backtrace_ref)


@functools.lru_cache(maxsize=16)
def split_pair_table(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Per keyword-subset ``ks``: the ordered ``(a, b)`` submask pairs the
    host split scan visits (``a`` descending from ``(ks-1) & ks``, only
    ``a <= b`` kept).  Padded with ``a = 0`` (never a valid submask).
    Shapes ``[2^m, P]`` with ``P >= 1``."""
    n_sets = 1 << m
    pairs: list[list[tuple[int, int]]] = []
    for ks in range(n_sets):
        row = []
        a = (ks - 1) & ks
        while a:
            b = ks ^ a
            if a <= b:
                row.append((a, b))
            a = (a - 1) & ks
        pairs.append(row)
    p_max = max(1, max(len(row) for row in pairs))
    pa = np.zeros((n_sets, p_max), np.int32)
    pb = np.zeros((n_sets, p_max), np.int32)
    for ks, row in enumerate(pairs):
        for i, (a, b) in enumerate(row):
            pa[ks, i], pb[ks, i] = a, b
    return pa, pb


@dataclasses.dataclass
class BatchedBacktrace:
    """Host copy of one device backtrace pass (all lanes, all candidates).

    ``cand_idx[L, C]`` are flat ``(root * K + slot)`` cell indices in the
    device's value-ascending scan order; ``fail[L, C]`` marks ragged
    stragglers (host fallback).  The per-obligation record arrays
    (``node/kind/child0/child1/edge_u``, each ``[L, C, B]``) replay into
    the host backtrace's exact edge order via :meth:`replay_edges`."""

    cand_idx: np.ndarray
    cand_val: np.ndarray
    fail: np.ndarray
    node: np.ndarray
    kind: np.ndarray
    child0: np.ndarray
    child1: np.ndarray
    edge_u: np.ndarray

    @property
    def n_candidates(self) -> int:
        return self.cand_idx.shape[1]

    def replay_edges(self, lane: int, cand: int) -> list[tuple[int, int]] | None:
        """Reconstruct the host-ordered edge list for one resolved
        candidate; None when the device pass flagged it ragged."""
        if self.fail[lane, cand]:
            return None
        kind = self.kind[lane, cand]
        node = self.node[lane, cand]
        child0 = self.child0[lane, cand]
        child1 = self.child1[lane, cand]
        edge_u = self.edge_u[lane, cand]
        out: list[tuple[int, int]] = []
        # Explicit stack replaying the host recursion's emit order: a split
        # emits left edges then right, an edge decomposition emits its
        # subtree first, then itself (post-order).
        stack: list[tuple[int, int]] = [(0, 0)]
        while stack:
            slot, phase = stack.pop()
            kd = int(kind[slot])
            if kd == LEAF:
                continue
            if kd == SPLIT:
                stack.append((int(child1[slot]), 0))
                stack.append((int(child0[slot]), 0))
            elif kd == EDGE:
                if phase == 0:
                    stack.append((slot, 1))
                    stack.append((int(child0[slot]), 0))
                else:
                    v, u = int(node[slot]), int(edge_u[slot])
                    out.append((min(v, u), max(v, u)))
            else:
                # Pending/fail slot on a "resolved" path: treat as ragged.
                return None
        return out


class _DeviceScan:
    """One lane's candidate scan for ``collect_answers``: the device's
    stable value-ascending order of the full-set column, indexed like
    :class:`~repro_torch.core.reconstruct.HostScan`.  It starts from the
    ``C`` candidates already on the host and copies a further chunk (at
    least doubling what it holds) only when the refill walks past it."""

    def __init__(self, vals: torch.Tensor, idx: torch.Tensor, k: int,
                 head_vals: np.ndarray, head_idx: np.ndarray) -> None:
        self._vals, self._idx, self._k = vals, idx, k
        self.vals, self.idx = head_vals, head_idx

    def __len__(self) -> int:
        return self._vals.shape[0]

    def __getitem__(self, pos: int) -> tuple[int, float]:
        if pos >= len(self.vals):
            end = min(len(self), max(2 * len(self.vals), pos + 1))
            start = len(self.vals)
            self.vals = np.concatenate(
                [self.vals, self._vals[start:end].cpu().numpy()])
            self.idx = np.concatenate(
                [self.idx, self._idx[start:end].cpu().numpy()])
        return int(self.idx[pos]) // self._k, float(self.vals[pos])


class LaneRows:
    """Row-wise host view of one lane's table ``S[lane]`` (``[V, 2^m, K]``,
    on any device), for :func:`~repro_torch.core.reconstruct.backtrace`:
    ``view.shape``, ``view[v, s, i]`` and ``view[us, ks, :]``.  The rows
    not yet held are gathered on the device and copied to the host in one
    piece, then kept; ``fetched`` counts them."""

    def __init__(self, S: torch.Tensor, lane: int) -> None:
        self._table = S[lane]
        self.shape = tuple(self._table.shape)
        self._nodes = np.zeros(0, np.int64)          # sorted
        self._rows = np.zeros((0, *self.shape[1:]), np.float32)
        self.fetched = 0

    def rows(self, nodes: np.ndarray) -> np.ndarray:
        """Host rows ``[len(nodes), 2^m, K]`` of ``nodes``."""
        nodes = np.asarray(nodes, np.int64)
        pos = np.searchsorted(self._nodes, nodes)
        held = pos < len(self._nodes)
        held[held] = self._nodes[pos[held]] == nodes[held]
        if not held.all():
            new = np.unique(nodes[~held])
            got = self._table.index_select(
                0, torch.from_numpy(new).to(self._table.device)).cpu().numpy()
            order = np.argsort(np.concatenate([self._nodes, new]))
            self._nodes = np.concatenate([self._nodes, new])[order]
            self._rows = np.concatenate([self._rows, got])[order]
            self.fetched += len(new)
            pos = np.searchsorted(self._nodes, nodes)
        return self._rows[pos]

    def __getitem__(self, key: tuple):
        v, *rest = key
        if np.ndim(v) == 0:
            return self.rows(np.array([v]))[(0, *rest)]
        return self.rows(v)[(slice(None), *rest)]


class BatchedBacktracer:
    """Per-graph device backtracer: candidate selection (a stable sort)
    and the obligation walk (one launch) per bucket.

    ``degree_cap`` bounds the per-obligation neighbour window (a node with
    more neighbours whose match lies beyond the window falls back to the
    host — correctness never depends on the cap).  ``buffer`` bounds the
    per-candidate obligation count (= tree edges + splits + leaves).
    ``device``: where the CSR lives and the walk runs (``None``: the
    card); ``backend``: ``"cuda"`` walks with the kernel (its plain
    version on CPU tensors), ``"torch"`` with the plain version.
    """

    def __init__(self, graph: Graph, degree_cap: int = 2048,
                 buffer: int = 64, device: str | torch.device | None = None,
                 backend: str = "cuda") -> None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.graph = graph
        self.device = resolve_device(device)
        self.backend = backend
        deg_max = int(np.diff(graph.indptr).max()) if graph.n_nodes else 1
        self.degree_cap = max(1, min(degree_cap, max(deg_max, 1)))
        self.buffer = buffer
        # Host CSR, device-resident: indices/ew in the exact neighbour
        # order the host backtrace scans (ascending neighbour id per node).
        # An edgeless graph keeps one sentinel entry (never selected: every
        # node's degree window is empty).
        indices = np.asarray(graph.indices, np.int32)
        ews = np.asarray(graph.ew, np.float32)
        if indices.size == 0:
            indices, ews = np.zeros(1, np.int32), np.full(1, INF, np.float32)

        self._indptr = host_tensor(np.asarray(graph.indptr, np.int64),
                                   self.device)
        self._esrc = host_tensor(indices, self.device)
        self._ew = host_tensor(ews, self.device)
        self._pairs: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # Introspection: how much the device pass actually resolved, and
        # what reached the host for the stragglers: rows of lane tables
        # (``rows_fetched``), never a whole table (``table_copies`` stays
        # 0 since the host search reads rows).
        self.device_resolved = 0
        self.host_fallbacks = 0
        self.table_copies = 0
        self.rows_fetched = 0

    def stats(self) -> dict[str, int]:
        """``{device_resolved, host_fallbacks}`` — obligation backtraces
        the device pass settled vs ragged stragglers that re-ran the host
        search (both monotone over the tracer's lifetime)."""
        return {"device_resolved": self.device_resolved,
                "host_fallbacks": self.host_fallbacks}

    # -- device pass ----------------------------------------------------

    def _walk_args(self, S: torch.Tensor, kw: torch.Tensor, k: int,
                   candidate_factor: int = 4):
        """Sort every lane's full-set column: ``(sorted values [L, V*K],
        sorted cells [L, V*K], the walk's arguments)``, the first
        ``C = k * candidate_factor`` cells of each lane the candidates."""
        L, vp, n_sets, K = S.shape
        m = n_sets.bit_length() - 1
        C = max(1, min(vp * K, max(k, 1) * candidate_factor))
        flat = S[:, :, n_sets - 1, :].reshape(L, vp * K)
        vals, idx = torch.sort(flat, dim=1, stable=True)
        if m not in self._pairs:
            self._pairs[m] = tuple(
                torch.from_numpy(t).to(self.device)
                for t in split_pair_table(m))
        return vals, idx, (S, kw, idx[:, :C].to(torch.int32),
                           vals[:, :C].contiguous(), self._indptr,
                           self._esrc, self._ew, *self._pairs[m],
                           self.buffer, self.degree_cap)

    def _walk(self, S: torch.Tensor, kw: torch.Tensor, k: int,
              candidate_factor: int):
        """Select the candidates and walk them: ``(sorted values, sorted
        cells, host copy of the candidates and records)``."""
        vals, idx, args = self._walk_args(S, kw, k, candidate_factor)
        walk = (bt_ops.batched_backtrace if self.backend == "cuda"
                else batched_backtrace_ref)
        recs = walk(*args)
        return vals, idx, BatchedBacktrace(
            cand_idx=args[2].cpu().numpy(), cand_val=args[3].cpu().numpy(),
            **{name: t.cpu().numpy() for name, t in recs.items()})

    def _inputs(self, S_lanes, kw_lanes) -> tuple[torch.Tensor, torch.Tensor]:
        S = torch.as_tensor(S_lanes, device=self.device).contiguous()
        kw = torch.as_tensor(kw_lanes, dtype=torch.bool, device=self.device)
        return S, kw.contiguous()

    def backtrace_lanes(self, S_lanes, kw_lanes, k: int,
                        candidate_factor: int = 4) -> BatchedBacktrace:
        """One device pass: top-``k * candidate_factor`` candidates per
        lane, backtraced.  ``S_lanes``: ``[L, Vp, 2^m, K]`` (a tensor or an
        array); ``kw_lanes``: ``[L, m, Vp]`` bool."""
        S, kw = self._inputs(S_lanes, kw_lanes)
        return self._walk(S, kw, k, candidate_factor)[2]

    def extract_lanes(
        self,
        S_lanes,
        kw_lanes,
        k: int,
        candidate_factor: int = 4,
        lanes: list[int] | None = None,
        n_nodes: int | None = None,
    ) -> list[tuple[list[AnswerTree], bool]]:
        """Device-batched :func:`collect_answers` for a whole bucket.

        Returns ``(ranked_answers, exhausted)`` per requested lane —
        bit-identical to the host path: device-resolved candidates replay
        the host's first-choice search, ragged stragglers re-run the host
        ``backtrace``, and collection/pruning/ranking is the shared host
        collector either way, walking the device's sorted order.
        ``lanes``: which lanes to collect (default all — serving passes
        the real lanes of a padded bucket).  ``n_nodes``: real node count
        (kw mask columns beyond it are padding)."""
        S, kw = self._inputs(S_lanes, kw_lanes)
        vals, idx, batch = self._walk(S, kw, k, candidate_factor)
        C = batch.n_candidates
        kw_host = (kw_lanes.cpu().numpy() if isinstance(
            kw_lanes, torch.Tensor) else np.asarray(kw_lanes, bool))
        kw_host = kw_host[:, :, : n_nodes if n_nodes is not None
                          else self.graph.n_nodes]
        L, _vp, n_sets, K = S.shape
        full = n_sets - 1
        out: list[tuple[list[AnswerTree], bool]] = []
        for lane in (range(L) if lanes is None else lanes):
            kw_lane = kw_host[lane]
            host_S: list[LaneRows] = []

            def from_device(pos: int, root: int, val: float, _lane=lane,
                            _kw=kw_lane, _host_S=host_S):
                # Use the device record only when the device's pos-th
                # candidate is the scan's pos-th cell (same cell, same
                # value); past the candidates, or for a ragged straggler,
                # re-run the host search on the lane's table.
                if pos < C:
                    ci = int(batch.cand_idx[_lane, pos])
                    cv = float(batch.cand_val[_lane, pos])
                    if ci // K == root and abs(cv - val) <= 1e-6:
                        edges = batch.replay_edges(_lane, pos)
                        if edges is not None:
                            self.device_resolved += 1
                            return edges
                self.host_fallbacks += 1
                if not _host_S:
                    _host_S.append(LaneRows(S, _lane))
                return backtrace(_host_S[0], self.graph, _kw, root, full,
                                 val)

            scan = _DeviceScan(vals[lane], idx[lane], K,
                               batch.cand_val[lane], batch.cand_idx[lane])
            out.append(collect_answers(
                None, self.graph, kw_lane, k, candidate_factor,
                backtrace_fn=from_device, scan=scan))
            self.rows_fetched += sum(view.fetched for view in host_S)
        return out
