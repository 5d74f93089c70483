"""QueryEngine — the one front door for DKS relationship queries.

The paper's end-to-end flow (Fig. 2c): inverted-index lookup ->
keyword-node masks -> DKS supersteps -> aggregator-side answer trees.  The
engine owns the device-resident graph, the inverted index and the
lane-batched driver (:mod:`repro_torch.core.driver`); ``query`` is its
1-lane case and ``query_batch`` runs each keyword-count bucket as one set
of lanes.  The twin of ``repro.engine.QueryEngine`` for the ``graph=`` /
``tokens=`` / ``index=`` entry modes::

    engine = QueryEngine.build(graph, tokens=tokens,
                               policy=ExecutionPolicy(backend="cuda"))
    result = engine.query([17, 42], k=3)
    results = engine.query_batch(queries, k=1)

``query_batch`` reconstructs a bucket's answer trees through the
device-batched backtracer (:mod:`repro_torch.answers`); ``query`` keeps the
host collector, as ``repro``'s does.  ``device=None`` puts the engine on
the card (``cuda:0``) and raises when there is no GPU; tests pass
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import INF
from repro_torch.answers.batched import BatchedBacktracer
from repro_torch.core.dks import DKSConfig, DKSState
from repro_torch.core.driver import lane_view, run_lanes
from repro_torch.core.reconstruct import collect_answers
from repro_torch.core.spa import spa_cover_dp, spa_ratio
from repro_torch.device import resolve_device
from repro_torch.engine.policy import ExecutionPolicy
from repro_torch.engine.result import QueryResult
from repro_torch.graph.index import InvertedIndex
from repro_torch.graph.structure import DeviceGraph, Graph
from repro_torch.graph.weights import apply_weight_policy


class QueryEngine:
    """Facade over index lookup, device residency and the lane driver.
    Build one per (graph, policy); serve many queries."""

    # Monotone build ids: cache keys of one build never match another's.
    _build_counter = itertools.count(1)

    def __init__(self, graph: Graph, index: InvertedIndex,
                 policy: ExecutionPolicy, device_graph: DeviceGraph) -> None:
        self.graph = graph
        self.index = index
        self.policy = policy
        self.device_graph = device_graph
        self.version = next(QueryEngine._build_counter)
        self._e_min = float(device_graph.e_min())
        self._execute_count = 0
        # The device-batched backtracers, one per backend a bucket ran
        # on (built at first use, on the engine's device).
        # ``batched_extraction = False`` sends query_batch through the host
        # collector instead — a debugging escape hatch, as in ``repro``.
        self._backtracers: dict[str, BatchedBacktracer] = {}
        self.batched_extraction = True

    @classmethod
    def build(
        cls,
        graph: Graph | None = None,
        tokens: np.ndarray | None = None,
        index: InvertedIndex | None = None,
        policy: ExecutionPolicy | None = None,
        device: str | torch.device | None = None,
    ) -> "QueryEngine":
        """Build an engine: inverted index + device-resident graph.

        ``graph=`` plus exactly one of ``tokens`` (int[V, L] token matrix)
        or ``index`` — or neither, when ``graph.labels`` is set.
        ``device``: where the graph and every query run; ``None`` is the
        card, and raises ``RuntimeError`` when there is none.
        """
        device = resolve_device(device)
        policy = policy or ExecutionPolicy()
        if graph is None:
            raise ValueError("QueryEngine.build needs graph=")
        if index is not None and tokens is not None:
            raise ValueError(
                "pass either tokens= or index=, not both (the tokens would "
                "be ignored in favor of the prebuilt index)")
        if index is None:
            if tokens is not None:
                index = InvertedIndex.from_token_matrix(np.asarray(tokens))
            elif graph.labels is not None:
                index = InvertedIndex.from_labels(graph.labels)
            else:
                raise ValueError(
                    "QueryEngine.build needs tokens=, index=, or graph.labels")
        # Fold the weight policy into the weights once, before packing.
        graph = apply_weight_policy(graph, policy.weights)
        return cls(graph, index, policy, graph.to_device(device))

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.device_graph.device

    @property
    def n_nodes(self) -> int:
        return self.graph.n_nodes

    @property
    def v_pad(self) -> int:
        return self.device_graph.v_pad

    @property
    def execute_count(self) -> int:
        """Driver runs dispatched by ``query`` / ``query_batch`` (one per
        query, one per keyword-count bucket)."""
        return self._execute_count

    @property
    def extraction_stats(self) -> dict[str, int]:
        """Device-batched backtracer counters — ``device_resolved``
        candidates whose trees the device pass reconstructed, vs
        ``host_fallbacks`` ragged stragglers that re-ran the host search.
        Zeros before the backtracer is first used (it builds lazily)."""
        out = {"device_resolved": 0, "host_fallbacks": 0}
        for bt in self._backtracers.values():
            for name, n in bt.stats().items():
                out[name] += n
        return out

    def node_label(self, v: int) -> str:
        """Entity string for a node: the graph's labels when present, else
        ``node:<id>`` — the label function answer rendering plugs in."""
        v = int(v)
        if self.graph.labels is not None:
            return str(self.graph.labels[v])
        return f"node:{v}"

    def edge_info(self, u: int, v: int) -> tuple[str | None, float] | None:
        """``(predicate_name, confidence)`` of the effective edge between
        ``u`` and ``v`` (the cheapest parallel entry — the one backtrace
        resolved), or None on untyped graphs."""
        return self.graph.edge_channel(int(u), int(v))

    def _backtracer(self, backend: str | None = None) -> BatchedBacktracer:
        """The lazily-built device-batched backtracer of ``backend``
        (default the policy's), shared across buckets."""
        backend = backend or self.policy.backend
        if backend not in self._backtracers:
            self._backtracers[backend] = BatchedBacktracer(
                self.graph, device=self.device, backend=backend)
        return self._backtracers[backend]

    def cache_token(self, keywords: Sequence, k: int = 1,
                    **overrides) -> tuple:
        """Hashable result-cache key for a query against THIS engine build:
        the keywords as a sorted multiset (answers are keyword-order
        invariant), ``k``, the effective policy, and the build version."""
        norm = tuple(sorted((type(t).__name__, t) for t in keywords))
        policy = self.policy
        if overrides:
            self._check_overrides(overrides)
            policy = dataclasses.replace(policy, **overrides)
        return (norm, int(k), policy, self.version)

    @staticmethod
    def _check_overrides(overrides: dict) -> None:
        """The weight policy is fixed at build: the device graph holds its
        effective weights."""
        if "weights" in overrides:
            raise ValueError(
                "the weight policy is fixed at engine build (the device "
                "graph is packed with its effective weights) — build an "
                "engine with ExecutionPolicy(weights=...) instead of "
                "overriding per call")

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------

    def query(
        self,
        keywords: Sequence,
        k: int = 1,
        *,
        extract: bool = True,
        extract_pool: int | None = None,
        keep_state: bool = False,
        strict: bool = True,
        **overrides,
    ) -> QueryResult:
        """Answer one relationship query (the 1-lane case of the driver).

        ``extract``: reconstruct ranked answer trees on the host.
        ``extract_pool``: reconstruct up to this many distinct trees onto
        ``answer_pool``.  ``keep_state``: keep the final state on the
        result.  ``strict``: raise :class:`KeyError` when a keyword matches
        no node.  ``overrides``: per-call policy overrides
        (``max_supersteps``, ``message_budget``, ``exit_mode``,
        ``backend``).
        """
        keywords = list(keywords)
        cfg = self._config(len(keywords), k, **overrides)
        masks, unmatched = self._masks(keywords, strict)
        t0 = time.perf_counter()
        states = self._run(cfg, masks[None])
        dt = time.perf_counter() - t0
        return self._make_result(keywords, masks, states, cfg, dt, extract,
                                 keep_state, unmatched=unmatched,
                                 own_time_s=dt, extract_pool=extract_pool)

    def query_batch(
        self,
        queries: Sequence[Sequence],
        k: int = 1,
        *,
        extract: bool = True,
        extract_pool: int | None = None,
        keep_state: bool = False,
        strict: bool = True,
        n_real: int | None = None,
        **overrides,
    ) -> list[QueryResult | None]:
        """Answer a batch of queries.  Queries are bucketed by keyword
        count ``m``; each bucket runs as one set of lanes through the
        driver.  Results come back in input order; ``wall_time_s`` is the
        bucket's time and ``own_time_s`` is None (lanes advance in
        lockstep).  Queries at index >= ``n_real`` are padding lanes: they
        ride in their bucket but come back as None.  Answer trees of the
        bucket's real lanes with a finite answer come from the
        device-batched backtracer (one sort and one walk per bucket; only
        ragged stragglers copy their lane's table to the host), or, with
        ``batched_extraction`` off, from the host :func:`collect_answers`,
        lane by lane."""
        n_real = len(queries) if n_real is None else n_real
        results: list[QueryResult | None] = [None] * len(queries)
        buckets: dict[int, list[int]] = {}
        for i, q in enumerate(queries):
            buckets.setdefault(len(q), []).append(i)
        for m, idxs in sorted(buckets.items()):
            cfg = self._config(m, k, **overrides)
            pairs = [self._masks(list(queries[i]), strict) for i in idxs]
            masks = np.stack([p[0] for p in pairs])
            t0 = time.perf_counter()
            states = self._run(cfg, masks)
            dt = time.perf_counter() - t0
            pre: dict[int, tuple] = {}
            if extract and self.batched_extraction:
                best = states.topk_w[:, 0].cpu().numpy()
                lanes = [bi for bi in range(len(idxs))
                         if idxs[bi] < n_real and best[bi] < INF]
                if lanes:
                    bt = self._backtracer(cfg.backend)
                    pre = dict(zip(lanes, bt.extract_lanes(
                        states.S, masks, k=max(cfg.k, extract_pool or 0),
                        lanes=lanes, n_nodes=self.n_nodes)))
            for bi, i in enumerate(idxs):
                if i >= n_real:
                    continue
                results[i] = self._make_result(
                    list(queries[i]), masks[bi], lane_view(states, bi), cfg,
                    dt, extract, keep_state, unmatched=pairs[bi][1],
                    extract_pool=extract_pool, answers_pre=pre.get(bi))
        return results

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    def _run(self, cfg: DKSConfig, masks: np.ndarray) -> DKSState:
        """One driver run over lane-batched masks (bool[L, m, V]), ended by
        a device synchronisation so that timings around it are honest."""
        self._execute_count += 1
        kw = torch.from_numpy(masks).to(self.device)
        states = run_lanes(self.device_graph, kw, cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return states

    def _config(self, m: int, k: int, **overrides) -> DKSConfig:
        if m < 1:
            raise ValueError("a query needs at least one keyword")
        policy = self.policy
        if overrides:
            self._check_overrides(overrides)
            policy = dataclasses.replace(policy, **overrides)
        return policy.dks_config(m, k)

    def _masks(self, keywords: list,
               strict: bool = True) -> tuple[np.ndarray, tuple]:
        """(masks, unmatched tokens); ``strict`` raises on unmatched."""
        masks = self.index.keyword_masks(
            keywords, self.n_nodes, v_pad=self.v_pad,
            on_missing="raise" if strict else "ignore")
        unmatched = () if strict else tuple(
            self.index.missing_tokens(keywords))
        return masks, unmatched

    def _make_result(
        self,
        keywords: list,
        masks: np.ndarray,
        state: DKSState,
        cfg: DKSConfig,
        wall_time_s: float,
        extract: bool,
        keep_state: bool = False,
        unmatched: tuple = (),
        own_time_s: float | None = None,
        extract_pool: int | None = None,
        answers_pre: tuple | None = None,
    ) -> QueryResult:
        """Result of one lane (``state`` has a lane axis of 1).
        ``answers_pre``: a ready ``(ranked, exhausted)`` pair from the
        batched backtracer; without it the host collector runs on a host
        copy of the lane's table."""
        weights = state.topk_w[0].cpu().numpy()
        roots = state.topk_root[0].cpu().numpy()
        budget_hit = bool(state.budget_hit[0])
        capped = bool(state.capped[0])
        # The SPA cover DP only informs the ratio on forced early exits.
        spa = None
        ratio = 0.0
        if budget_hit or capped:
            shat = torch.clamp(state.s_front[0] + self._e_min, max=INF)
            spa = float(spa_cover_dp(shat, cfg.m))
            ratio = float(spa_ratio(state.topk_w[0, 0], spa))
        answers: list = []
        answers_exhausted = pool_exhausted = False
        answer_pool = None
        if extract and weights[0] < INF:
            if answers_pre is not None:
                ranked, exhausted = answers_pre
            else:
                ranked, exhausted = collect_answers(
                    state.S[0].cpu().numpy(), self.graph,
                    masks[:, : self.n_nodes],
                    k=max(cfg.k, extract_pool or 0))
            answers = ranked[: cfg.k]
            answers_exhausted = len(ranked) < cfg.k
            if extract_pool:
                answer_pool = ranked
                pool_exhausted = exhausted
        elif extract:
            # No finite answer => no trees exist.
            answers_exhausted = True
            if extract_pool:
                answer_pool, pool_exhausted = [], True
        return QueryResult(
            query=tuple(keywords),
            m=cfg.m,
            k=cfg.k,
            answers=answers,
            weights=weights,
            roots=roots,
            kw_nodes=int(masks.sum()),
            supersteps=int(state.step[0]),
            msgs_bfs=float(state.msgs_bfs[0]),
            msgs_deep=float(state.msgs_deep[0]),
            # XLA's mean multiplies by the f32 reciprocal; so does this.
            explored_frac=float(
                state.visited[0, : self.n_nodes].sum().to(torch.float32)
                * torch.tensor(1.0 / self.n_nodes, dtype=torch.float32)),
            done=bool(state.done[0]),
            budget_hit=budget_hit,
            capped=capped,
            spa=spa,
            spa_ratio=ratio,
            wall_time_s=wall_time_s,
            state=state if keep_state else None,
            unmatched=tuple(unmatched),
            own_time_s=own_time_s,
            answers_exhausted=answers_exhausted,
            answer_pool=answer_pool,
            pool_exhausted=pool_exhausted,
        )
