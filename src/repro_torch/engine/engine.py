"""QueryEngine — the one front door for DKS relationship queries.

The paper's end-to-end flow (Fig. 2c): inverted-index lookup ->
keyword-node masks -> DKS supersteps -> aggregator-side answer trees.  The
engine owns the device-resident graph, the inverted index and the
lane-batched driver (:mod:`repro_torch.core.driver`).  The twin of
``repro.engine.QueryEngine``, with its ``graph=`` / ``tokens=`` /
``index=`` and ``artifact=`` entry modes::

    engine = QueryEngine.build(graph, tokens=tokens,
                               policy=ExecutionPolicy(backend="cuda"))
    result = engine.query([17, 42], k=3)
    results = engine.query_batch(queries, k=1)          # m-bucketed lanes
    for upd in engine.query_stream(query, k=1):         # per-superstep
        ...  # upd.weights + upd.spa_ratio: answers with a sound bound
    engine.query_deadline_batch(queries, deadline_s=.05)  # shared driver

Every surface is a host loop over the same two steps, ``lane_init`` and
``lane_superstep`` (on ``"cuda"`` one ``lane_superstep.cu`` launch per
superstep).  ``repro`` compiles two executables per ``DKSConfig``: the
**fused** driver (``query``, ``query_batch``) and the **stepwise**
``(init, superstep)`` pair (streaming, deadline).  torch has no jit; the
engine counts first uses per ``(DKSConfig, "fused" | "stepwise")`` so
that :meth:`trace_count` and :attr:`cache_stats` read as ``repro``'s do
(1 on first use of "fused", 2 for the "stepwise" pair).

``query_batch`` reconstructs a bucket's answer trees through the
device-batched backtracer (:mod:`repro_torch.answers`); ``query`` keeps the
host collector, as ``repro``'s does; ``query_deadline_batch`` overlaps the
host collector of frozen lanes with the remaining supersteps
(:class:`~repro_torch.answers.ExtractionOverlap`).  ``device=None`` puts
the engine on the card (``cuda:0``) and raises when there is no GPU; tests
pass ``device="cpu"``.

``ExecutionPolicy(partition="sharded")`` packs a
:class:`~repro_torch.core.dks_sharded.FrontierGraph` instead of the dense
:class:`DeviceGraph`; every surface runs on it unchanged (the driver
takes the frontier-compressed superstep), with the node axis padded to
``n_shards`` and the tables cut back to ``n_nodes`` rows for extraction.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch import INF
from repro_torch.answers.batched import BatchedBacktracer
from repro_torch.core.dks import DKSConfig, DKSState, run_dks_instrumented
from repro_torch.core.dks_sharded import (FrontierGraph, pack_frontier_graph,
                                          run_dks_frontier_instrumented)
from repro_torch.core.driver import (lane_init, lane_superstep, lane_view,
                                     run_lanes, run_lanes_telemetry)
from repro_torch.core.reconstruct import collect_answers
from repro_torch.core.spa import nu_lower_bound, spa_cover_dp, spa_ratio
from repro_torch.device import resolve_device
from repro_torch.engine.policy import ExecutionPolicy
from repro_torch.engine.result import QueryResult, StreamUpdate
from repro_torch.graph.index import InvertedIndex
from repro_torch.graph.structure import DeviceGraph, Graph
from repro_torch.graph.weights import apply_weight_policy
from repro_torch.obs.telemetry import SuperstepTelemetry


@dataclasses.dataclass(frozen=True)
class _StateBounds:
    """One DKS state's bound facts (see QueryEngine._state_bounds)."""

    best: float
    nu_full: float
    spa: float
    frontier: int
    opt_lb: float
    sound_lb: float


class QueryEngine:
    """Facade over index lookup, device residency and the lane driver.
    Build one per (graph, policy); serve many queries."""

    # Monotone build ids: cache keys of one build never match another's.
    # An engine built from a persisted artifact takes the artifact's
    # content hash instead: stable across rebuilds of the same artifact,
    # different for any other graph content.
    _build_counter = itertools.count(1)

    def __init__(self, graph: Graph, index: InvertedIndex,
                 policy: ExecutionPolicy,
                 device_graph: DeviceGraph | FrontierGraph,
                 graph_hash: str | None = None) -> None:
        self.graph = graph
        self.index = index
        self.policy = policy
        self.device_graph = device_graph
        self.graph_hash = graph_hash
        self.version: int | str = (
            f"artifact:{graph_hash}" if graph_hash is not None
            else next(QueryEngine._build_counter))
        # The artifact (or chain) the engine was built from: labels for
        # answer rendering.
        self.artifact: Any = None
        self._e_min = float(device_graph.e_min())
        # (DKSConfig, "fused" | "stepwise") -> preparations: repro's jit
        # trace counts (1 for the fused driver, 2 for the stepwise pair).
        self._trace_counts: dict[tuple, int] = {}
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
        artifact: Any = None,
        device: str | torch.device | None = None,
    ) -> "QueryEngine":
        """Build an engine: inverted index + device-resident graph.

        Two entry modes:

        - ``graph=`` plus exactly one of ``tokens`` (int[V, L] token
          matrix) or ``index`` — or neither, when ``graph.labels`` is set;
        - ``artifact=`` — a :class:`repro_torch.store.GraphArtifact` (or a
          path to one), or a :class:`repro_torch.store.GraphChain` (a base
          plus stacked deltas): graph and persisted index come straight
          off the mmapped buffers, and the artifact's ``content_hash``
          (for a chain, the chained hash) becomes ``version =
          "artifact:<hash>"``.

        ``device``: where the graph and every query run; ``None`` is the
        card, and raises ``RuntimeError`` when there is none.
        """
        device = resolve_device(device)
        policy = policy or ExecutionPolicy()
        graph_hash = None
        if artifact is not None:
            if graph is not None or tokens is not None or index is not None:
                raise ValueError(
                    "pass artifact= alone — it already carries the graph "
                    "and the persisted index")
            if isinstance(artifact, (str, Path)):
                from repro_torch.store import open_artifact
                artifact = open_artifact(artifact)
            graph = artifact.graph()
            index = artifact.index()
            graph_hash = artifact.content_hash
        if graph is None:
            raise ValueError("QueryEngine.build needs graph= or artifact=")
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
        # Fold the weight policy into the weights once, before packing:
        # the dense DeviceGraph, the sharded FrontierGraph, backtrace and
        # rendering all read the same effective weights.
        graph = apply_weight_policy(graph, policy.weights)
        if policy.partition == "sharded":
            n_shards = policy.n_shards
            if n_shards is None:
                n_shards = (torch.cuda.device_count()
                            if device.type == "cuda" else 1)
            device_graph = pack_frontier_graph(graph, n_shards,
                                               device=device)
        else:
            device_graph = graph.to_device(device)
        engine = cls(graph, index, policy, device_graph,
                     graph_hash=graph_hash)
        engine.artifact = artifact
        return engine

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
    def n_edges(self) -> int:
        """Symmetrized device edge count (the |E| of Fig. 14)."""
        return self.device_graph.n_edges

    @property
    def v_pad(self) -> int:
        return self.device_graph.v_pad

    _KINDS = {"fused": 1, "stepwise": 2}  # kind -> preparations per key

    def trace_count(self, m: int, k: int, kind: str = "fused",
                    **overrides) -> int:
        """How many times the executor for this query shape was prepared:
        1 after any number of same-shape "fused" queries (``query``,
        ``query_batch``; the telemetry driver on a telemetry engine), 2
        for the "stepwise" ``(init, superstep)`` pair — ``repro``'s jit
        trace count, read the same way by the serve layer's
        compile-vs-warm accounting.  (torch re-traces nothing, so a new
        lane count does not count again, where ``repro``'s jit would.)"""
        if kind not in self._KINDS:
            raise ValueError(f"unknown executor kind {kind!r}")
        return self._trace_counts.get((self._config(m, k, **overrides),
                                       kind), 0)

    @property
    def cache_stats(self) -> dict[str, int]:
        """{executables, traces}: prepared executors vs. preparations."""
        return {
            "executables": len(self._trace_counts),
            "traces": sum(self._trace_counts.values()),
        }

    @property
    def execute_count(self) -> int:
        """Device dispatches: one per ``query`` / ``query_batch`` bucket,
        one per superstep (init included) of the stepwise surfaces.  A
        serving layer's result-cache hit leaves it untouched.
        ``query_instrumented`` runs its own per-phase loop and is not
        counted."""
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
        the artifact's label blob (decoded per node, off the mmap), else
        ``node:<id>`` — the label function answer rendering plugs in."""
        v = int(v)
        if self.graph.labels is not None:
            return str(self.graph.labels[v])
        if self.artifact is not None and self.artifact.has_labels:
            return self.artifact.label(v)
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
        # Telemetry observes the run without changing the answer: it must
        # not fragment result caches.
        if policy.telemetry:
            policy = dataclasses.replace(policy, telemetry=False)
        return (norm, int(k), policy, self.version)

    @staticmethod
    def _check_overrides(overrides: dict) -> None:
        """The weight policy, the partition and telemetry are fixed at
        build: the device graph holds the effective weights in its
        partition's layout, and telemetry picks the fused executor's
        variant."""
        if "weights" in overrides:
            raise ValueError(
                "the weight policy is fixed at engine build (the device "
                "graph is packed with its effective weights) — build an "
                "engine with ExecutionPolicy(weights=...) instead of "
                "overriding per call")
        for name in ("partition", "n_shards"):
            if name in overrides:
                raise ValueError(
                    f"{name} is fixed at engine build (the device graph is "
                    f"packed in its layout) — build an engine with "
                    f"ExecutionPolicy({name}=...) instead of overriding "
                    f"per call")
        if "telemetry" in overrides:
            raise ValueError(
                "telemetry is fixed at engine build (it selects the fused "
                "driver's variant) — build an engine with "
                "ExecutionPolicy(telemetry=True) instead of overriding "
                "per call")

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
        states, telemetry = self._run_fused(cfg, masks[None])
        dt = time.perf_counter() - t0
        return self._make_result(keywords, masks, states, cfg, dt, extract,
                                 keep_state, unmatched=unmatched,
                                 own_time_s=dt, extract_pool=extract_pool,
                                 telemetry=telemetry)

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
        ragged stragglers copy rows of their lane's table to the host), or,
        with ``batched_extraction`` off, from the host
        :func:`collect_answers`, lane by lane."""
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
            states, telemetry = self._run_fused(cfg, masks)
            dt = time.perf_counter() - t0
            pre: dict[int, tuple] = {}
            if extract and self.batched_extraction:
                best = states.topk_w[:, 0].cpu().numpy()
                lanes = [bi for bi in range(len(idxs))
                         if idxs[bi] < n_real and best[bi] < INF]
                if lanes:
                    bt = self._backtracer(cfg.backend)
                    pre = dict(zip(lanes, bt.extract_lanes(
                        states.S[:, : self.n_nodes],
                        masks[:, :, : self.n_nodes],
                        k=max(cfg.k, extract_pool or 0),
                        lanes=lanes, n_nodes=self.n_nodes)))
            for bi, i in enumerate(idxs):
                if i >= n_real:
                    continue
                results[i] = self._make_result(
                    list(queries[i]), masks[bi], lane_view(states, bi), cfg,
                    dt, extract, keep_state, unmatched=pairs[bi][1],
                    extract_pool=extract_pool, answers_pre=pre.get(bi),
                    telemetry=telemetry)
        return results

    def query_stream(
        self,
        keywords: Sequence,
        k: int = 1,
        *,
        strict: bool = True,
        **overrides,
    ) -> Iterator[StreamUpdate]:
        """Yield per-superstep approximate answers with sound bounds.

        Every update carries the current top-k weights plus
        ``opt_lower_bound`` — the running max over supersteps of
        ``min(best_t, spa_t)`` and ``min(best_t, nu_full_t)`` — so the
        reported ``spa_ratio`` never worsens and reaches 0 once the best
        answer cannot be improved per the bound (paper Sec. 5.4, Fig. 12).
        Validation is eager: a strict-mode ``KeyError`` fires here, not at
        the first iteration.
        """
        keywords = list(keywords)
        cfg = self._config(len(keywords), k, **overrides)
        masks, unmatched = self._masks(keywords, strict)

        def updates() -> Iterator[StreamUpdate]:
            for _state, update in self._stream(cfg, masks,
                                               unmatched=unmatched):
                yield update

        return updates()

    def query_streamed(
        self,
        keywords: Sequence,
        k: int = 1,
        *,
        on_update: Callable[[StreamUpdate], None] | None = None,
        until: Callable[[StreamUpdate], bool] | None = None,
        extract: bool = True,
        keep_state: bool = False,
        strict: bool = True,
        **overrides,
    ) -> QueryResult:
        """Run a streaming query to completion and return its result,
        calling ``on_update`` per superstep.  ``until``: a host-side stop
        predicate evaluated on every update; when it fires before the
        run's own exit, the result is built from the best-so-far state as
        a forced stop (``done=False``, SPA bound and ratio as for
        ``budget_hit``)."""
        keywords = list(keywords)
        cfg = self._config(len(keywords), k, **overrides)
        masks, unmatched = self._masks(keywords, strict)
        t0 = time.perf_counter()
        state = None
        interrupted = False
        for state, update in self._stream(cfg, masks, unmatched=unmatched):
            if on_update is not None:
                on_update(update)
            if until is not None and not update.done and until(update):
                interrupted = True
                break
        dt = time.perf_counter() - t0
        assert state is not None
        return self._make_result(keywords, masks, state, cfg, dt, extract,
                                 keep_state, unmatched=unmatched,
                                 own_time_s=dt, interrupted=interrupted)

    def query_deadline(
        self,
        keywords: Sequence,
        k: int = 1,
        *,
        deadline_s: float,
        extract: bool = True,
        extract_pool: int | None = None,
        keep_state: bool = False,
        strict: bool = True,
        **overrides,
    ) -> tuple[QueryResult, dict[str, Any]]:
        """Serving hook: run under a wall-clock budget, bounds computed
        once at the end (no per-superstep cover DP, which could eat the
        budget it bounds).  Returns ``(result, info)`` with
        ``opt_lower_bound``, ``sound_opt_lower_bound``, ``interrupted``
        and ``driver_supersteps``.  The 1-lane case of
        :meth:`query_deadline_batch`."""
        out = self.query_deadline_batch(
            [list(keywords)], k, deadline_s=deadline_s, extract=extract,
            extract_pool=extract_pool, keep_state=keep_state, strict=strict,
            **overrides)
        assert out[0] is not None
        return out[0]

    def query_deadline_batch(
        self,
        queries: Sequence[Sequence],
        k: int = 1,
        *,
        deadline_s: float,
        extract: bool = True,
        extract_pool: int | None = None,
        keep_state: bool = False,
        strict: bool = True,
        n_real: int | None = None,
        **overrides,
    ) -> list[tuple[QueryResult, dict[str, Any]] | None]:
        """Serve a bucket of same-``m`` queries under one shared wall-clock
        budget, riding one stepwise lane driver.

        Lanes freeze individually as their exit fires; when the budget
        expires every still-running lane is interrupted at the same
        superstep with its own best-so-far answer and per-lane bounds
        (paper Sec. 5.4).  Returns one ``(result, info)`` per query
        (``info``: as :meth:`query_deadline`, plus ``driver_supersteps``
        and the bucket's ``extraction`` split); queries at index >=
        ``n_real`` are padding lanes and come back as None.  A lane that
        freezes has a final table, so its host tree reconstruction starts
        on a worker thread at once (:class:`~repro_torch.answers.
        ExtractionOverlap`) while the driver steps the rest.
        """
        queries = [list(q) for q in queries]
        if not queries:
            return []
        ms = {len(q) for q in queries}
        if len(ms) != 1:
            raise ValueError(
                f"a deadline bucket shares one driver: all queries must "
                f"have the same keyword count (got m={sorted(ms)})")
        n_real = len(queries) if n_real is None else n_real
        cfg = self._config(ms.pop(), k, **overrides)
        pairs = [self._masks(q, strict) for q in queries]
        masks = np.stack([p[0] for p in pairs])
        self._prepare(cfg, "stepwise")
        overlap = None
        if extract:
            from repro_torch.answers import ExtractionOverlap
            overlap = ExtractionOverlap(
                self.graph, max(cfg.k, extract_pool or 0))
        t0 = time.perf_counter()
        deadline_t = t0 + max(deadline_s, 0.0)
        state = self._execute(lane_init, self._device_masks(masks), cfg)
        own_t: list[float | None] = [None] * len(queries)
        driver_steps = 0
        while True:
            done = state.done.cpu().numpy()
            best = state.topk_w[:, 0].cpu().numpy()
            now = time.perf_counter()
            for i in range(n_real):
                if done[i] and own_t[i] is None:
                    # The lane proved its exit here: that is ITS serve
                    # time, while the driver keeps stepping the others.
                    own_t[i] = now - t0
                    if overlap is not None and best[i] < INF:
                        overlap.submit(i, state.S[i, : self.n_nodes],
                                       masks[i][:, : self.n_nodes])
            if done[:n_real].all() or now >= deadline_t:
                break
            state = self._execute(lane_superstep, state, cfg)
            driver_steps += 1
        dt = time.perf_counter() - t0
        out: list[tuple[QueryResult, dict[str, Any]] | None] = []
        for i, q in enumerate(queries):
            if i >= n_real:
                out.append(None)
                continue
            lane = lane_view(state, i)
            answers_pre = None
            if overlap is not None and float(lane.topk_w[0, 0]) < INF:
                # Overlapped result for frozen lanes; inline best-so-far
                # extraction for lanes the deadline interrupted.
                answers_pre = overlap.result(i) if overlap.pending(i) \
                    else overlap.result(i, lane.S[0, : self.n_nodes],
                                        masks[i][:, : self.n_nodes])
            interrupted = not bool(lane.done[0])
            forced = bool(lane.budget_hit[0]) or bool(lane.capped[0])
            if interrupted or forced:
                bounds = self._state_bounds(lane, cfg)
                spa = bounds.spa
                sound_lb = bounds.sound_lb
                # The reported bound folds in the sound facts.
                opt_lb = max(bounds.opt_lb, sound_lb)
            else:
                # Proven exit: the certified best answer IS the bound.
                spa = None
                opt_lb = sound_lb = min(float(lane.topk_w[0, 0]), INF)
            res = self._make_result(
                q, masks[i], lane, cfg, dt, extract, keep_state,
                unmatched=pairs[i][1],
                own_time_s=own_t[i] if own_t[i] is not None else dt,
                interrupted=interrupted, spa_hint=spa,
                extract_pool=extract_pool, answers_pre=answers_pre)
            info = dict(
                opt_lower_bound=min(opt_lb, INF),
                sound_opt_lower_bound=min(sound_lb, INF),
                interrupted=interrupted,
                driver_supersteps=driver_steps,
            )
            out.append((res, info))
        if overlap is not None:
            overlap.close()
            # Bucket-wide extraction split, shared by every lane's info.
            ext = overlap.stats()
            for pair in out:
                if pair is not None:
                    pair[1]["extraction"] = ext
        return out

    def _state_bounds(self, state: DKSState, cfg: DKSConfig) -> _StateBounds:
        """One 1-lane state's lower-bound facts, shared by the stream and
        deadline paths.

        ``opt_lb`` is the paper's reported bound — max of min(best, spa)
        and min(best, nu) — and ``sound_lb`` keeps the provable facts
        only: ``nu``, plus ``best`` itself when an empty frontier (or an
        exit that is neither the budget nor the cap) proves no future
        superstep changes anything.  The O(3^m) DPs run on host copies of
        the [2^m] vectors: the same f32 min and add as on the card,
        without ~3^m tiny launches.
        """
        best = float(state.topk_w[0, 0])
        g = state.g[0].cpu()
        e_min = torch.tensor(self._e_min, dtype=torch.float32)
        nu_full = float(nu_lower_bound(g, e_min, cfg.m)[cfg.full])
        shat = torch.clamp(state.s_front[0].cpu() + self._e_min, max=INF)
        spa = float(spa_cover_dp(shat, cfg.m))
        frontier = int(state.changed[0].sum())
        opt_lb = max(min(best, spa), min(best, nu_full))
        sound_lb = min(best, nu_full)
        forced = bool(state.budget_hit[0]) or bool(state.capped[0])
        if frontier == 0 or (bool(state.done[0]) and not forced):
            sound_lb = max(sound_lb, best)
        return _StateBounds(best=best, nu_full=nu_full, spa=spa,
                            frontier=frontier, opt_lb=min(opt_lb, INF),
                            sound_lb=min(sound_lb, INF))

    def _stream(self, cfg: DKSConfig, masks: np.ndarray,
                unmatched: tuple = ()):
        """(state, StreamUpdate) pairs, one per superstep (init included):
        a host loop over the 1-lane stepwise driver."""
        self._prepare(cfg, "stepwise")
        state = self._execute(lane_init, self._device_masks(masks[None]), cfg)
        opt_lb = 0.0
        sound_lb = 0.0
        while True:
            bounds = self._state_bounds(state, cfg)
            best = bounds.best
            done = bool(state.done[0])
            step = int(state.step[0])
            opt_lb = max(opt_lb, bounds.opt_lb)
            sound_lb = max(sound_lb, bounds.sound_lb)
            if best >= INF:
                ratio = float("inf")
            elif best <= opt_lb or opt_lb >= INF:
                ratio = 0.0
            else:
                ratio = best / opt_lb if opt_lb > 0 else float("inf")
            yield state, StreamUpdate(
                step=step,
                weights=state.topk_w[0].cpu().numpy(),
                roots=state.topk_root[0].cpu().numpy(),
                frontier=bounds.frontier,
                msgs_bfs=float(state.msgs_bfs[0]),
                msgs_deep=float(state.msgs_deep[0]),
                nu_full=bounds.nu_full,
                spa=bounds.spa,
                opt_lower_bound=opt_lb,
                sound_opt_lower_bound=sound_lb,
                spa_ratio=ratio,
                done=done,
                unmatched=tuple(unmatched),
            )
            if done or step >= cfg.max_supersteps:
                return
            state = self._execute(lane_superstep, state, cfg)

    def query_instrumented(
        self,
        keywords: Sequence,
        k: int = 1,
        *,
        exit_hook: Callable[[DKSState], bool] | None = None,
        extract: bool = True,
        keep_state: bool = False,
        strict: bool = True,
        **overrides,
    ) -> tuple[QueryResult, dict[str, Any]]:
        """Host-driven run with per-phase wall times (paper Table 1) and an
        optional host-side exit criterion (e.g.
        :func:`repro_torch.core.fagin.paper_exit_hook`); ``info`` carries
        ``timings``, ``history`` and ``telemetry``.  On a sharded engine
        the pack, the frontier exchange and the edge relax all land in
        "send_bfs" (:func:`~repro_torch.core.dks_sharded.
        run_dks_frontier_instrumented`)."""
        run_fn = (run_dks_frontier_instrumented
                  if isinstance(self.device_graph, FrontierGraph)
                  else run_dks_instrumented)
        keywords = list(keywords)
        cfg = self._config(len(keywords), k, **overrides)
        masks, unmatched = self._masks(keywords, strict)
        t0 = time.perf_counter()
        state, info = run_fn(
            self.device_graph, torch.from_numpy(masks).to(self.device), cfg,
            exit_hook=exit_hook)
        dt = time.perf_counter() - t0
        res = self._make_result(keywords, masks, state, cfg, dt, extract,
                                keep_state, unmatched=unmatched,
                                own_time_s=dt,
                                telemetry=info.get("telemetry"))
        return res, info

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    def _device_masks(self, masks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(masks).to(self.device)

    def _execute(self, fn, *args):
        """Run one driver step (``fn(graph, *args)``) on the engine's
        graph, ended by a device synchronisation so that timings around it
        are honest."""
        self._execute_count += 1
        out = fn(self.device_graph, *args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def _run_fused(self, cfg: DKSConfig, masks: np.ndarray
                   ) -> tuple[DKSState, SuperstepTelemetry | None]:
        """One fused-driver run over lane-batched masks (bool[L, m, V]).
        Returns ``(final states, telemetry)``: the decoded
        :class:`SuperstepTelemetry` under ``ExecutionPolicy(telemetry=
        True)``, else None — the state trajectory is the same either
        way."""
        self._prepare(cfg, "fused")
        if not self.policy.telemetry:
            return self._execute(run_lanes, self._device_masks(masks),
                                 cfg), None
        states, buf, steps = self._execute(
            run_lanes_telemetry, self._device_masks(masks), cfg)
        return states, SuperstepTelemetry.from_buffer(buf.cpu().numpy(),
                                                      steps)

    def _prepare(self, cfg: DKSConfig, kind: str) -> None:
        """Count an executor's first use, as ``repro`` counts its jit
        traces: 1 for "fused", 2 for the "stepwise" pair, once per
        config."""
        self._trace_counts.setdefault((cfg, kind), self._KINDS[kind])

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
        interrupted: bool = False,
        spa_hint: float | None = None,
        extract_pool: int | None = None,
        answers_pre: tuple | None = None,
        telemetry: SuperstepTelemetry | None = None,
    ) -> QueryResult:
        """Result of one lane (``state`` has a lane axis of 1).
        ``answers_pre``: a ready ``(ranked, exhausted)`` pair from the
        batched backtracer or the extraction overlap; without it the host
        collector runs on a host copy of the lane's table."""
        weights = state.topk_w[0].cpu().numpy()
        roots = state.topk_root[0].cpu().numpy()
        budget_hit = bool(state.budget_hit[0])
        capped = bool(state.capped[0])
        # The SPA cover DP only informs the ratio on forced early exits
        # (budget, superstep cap, a deadline or ``until`` interrupt);
        # ``spa_hint`` reuses a value the caller computed on this state.
        spa = None
        ratio = 0.0
        if budget_hit or capped or interrupted:
            if spa_hint is not None:
                spa = spa_hint
            else:
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
                    state.S[0, : self.n_nodes].cpu().numpy(), self.graph,
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
            # The f32 sum of at most V booleans is exact below 2^24 nodes
            # (bluk-bnb: 16.1 M), in any order.
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
            telemetry=telemetry,
        )
