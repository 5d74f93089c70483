"""DKSService — the serving layer in front of :class:`QueryEngine` (the
port of ``repro.serve.service``; the engine under it runs on the card).

The paper's headline guarantee (Sec. 5.4 / Fig. 12) — a DKS run stopped
early still yields ranked answers with a sound lower bound — is exactly
the contract a latency-budgeted query service needs.  This module turns
the engine into that service:

- **admission + dynamic micro-batching** — concurrent requests coalesce
  into ``(m, k)``-shape buckets and dispatch through the engine's
  lane-batched driver, amortizing device dispatch across clients;
- **a result cache** — LRU keyed on the engine's normalized cache token
  (keyword multiset + ``(k, policy)`` + engine build version), with
  hit/miss/eviction stats and explicit invalidation on graph rebuild;
- **cross-request single-flight** — a cache miss identical to a request
  already executing (same cache token) attaches to the in-flight future
  instead of dispatching again: N concurrent identical misses cost one
  device execution (``ServedResult.coalesced`` marks the attached ones);
- **deadline-bounded answers, coalesced** — a per-request latency budget
  routes the query through the engine's stepwise lane driver; same-shape
  same-budget requests ride ONE driver (``engine.query_deadline_batch``),
  lanes freeze individually as they prove exits, and on expiry every
  lane gets its own best-so-far answer *with* its per-lane SPA lower
  bound and ``approximate=True``.  Deadline throughput therefore stops
  scaling 1:1 with concurrency: N coalesced requests cost ~max
  supersteps, not the sum (``ServeStats.deadline_driver_supersteps`` vs
  ``deadline_lane_supersteps`` shows the sharing).

Usage::

    with DKSService(engine, ServeConfig(max_batch=8)) as svc:
        fut = svc.submit(["paris", "piano"], k=3)          # non-blocking
        served = svc.query(query, k=1, deadline_ms=50.0)   # blocking
        if served.approximate:
            print(served.result.weights, ">=", served.opt_lower_bound)
    print(svc.stats().summary())

All device work happens on the service's single dispatcher thread; client
threads only touch the cache, the admission queue, and their futures.  So
every kernel launch of the service runs off the main thread: the engine
names its device on every tensor it makes, the kernels' first-use build
is locked, and only the dispatcher thread moves the kernels' launch
counters.

**Observability** (:mod:`repro_torch.obs`): every admitted request gets a trace
(``ServedResult.trace_id``) whose spans walk the request's actual path —
admit (with the cache lookup), queue wait, bucket coalesce (shape / fill /
dispatch reason / deadline budget), device dispatch (first-use vs warm,
detected via the engine's trace counter), extraction (device-resolved vs
host-fallback split), render/paginate, cache store.  Micro-batch riders
and single-flight followers get their own trace with a ``coalesced_into``
link to the bucket leader.  ``svc.registry`` exposes every ``ServeStats``
counter (derived from the same snapshot at scrape time, so ``/metrics``
can never drift from ``stats()``), engine executor counters, and
latency/queue/device histograms in Prometheus text format —
``serve_dks --metrics-port`` serves it over HTTP.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Hashable, Sequence

from repro_torch.answers import TreePage, diversified_order, paginate
from repro_torch.engine import AdaptiveLanePolicy, QueryEngine, QueryResult
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve.batcher import MicroBatcher, Request
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.stats import ServeStats, StatsCollector

# Stand-in context manager for unsampled/traceless span sites (entering
# it any number of times is safe — nullcontext keeps no state).
_NULL_SPAN = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs, fixed at service construction.

    Attributes:
      max_batch:   most requests coalesced into one device dispatch.
      max_wait_ms: admission window — a partial bucket dispatches once its
                   oldest request has waited this long.  The classic
                   trade: higher = better fill, worse p50.
      cache_size:  LRU entries; 0 disables the result cache.
      extract:     reconstruct AnswerTrees on served results (skip for
                   weight-only serving).
      strict:      reject queries with unmatched keywords at admission
                   (KeyError on the future) instead of poisoning a whole
                   co-batched dispatch.
      pad_batches: pad partial buckets up to a fixed lane count by
                   repeating the last query, so the lane driver sees few
                   distinct lane counts (table shapes):
                   "pow2" (next power of two, the default), "max" (always
                   ``max_batch`` lanes), "none", or "adaptive" — an
                   :class:`~repro_torch.engine.AdaptiveLanePolicy` that scores
                   candidate lane counts from MEASURED per-dispatch device
                   time and the ``ServeStats.hot_shapes`` histogram
                   instead of blind rounding (it degrades to exactly
                   "pow2" until the first measurement lands; decisions
                   are exported as ``dks_lane_policy_*`` metrics).
                   Padding lanes burn device FLOPs only — the engine
                   skips host-side result construction for them
                   (``n_real=``) — and batch-fill stats count real
                   requests only.  Applies to deadline buckets too.
      default_deadline_ms: deadline applied when a request sets none.
                   Deadline requests coalesce with same-shape same-budget
                   requests onto one stepwise lane driver, but they are
                   host-stepped (per-superstep deadline checks) and
                   exempt from the result cache and single-flight — so a
                   blanket default still costs more than deadline-less
                   serving; set it only when every request truly has that
                   budget.
      tree_cache_size: tree-pool LRU entries (``return_trees`` serving);
                   0 disables the tree cache.  Keyed on the engine's
                   cache token, so it is exact-only and version-safe by
                   construction (a rebuilt graph keys differently).
      tree_page_size: default trees per :class:`TreePage` (a request can
                   override per call).
      tree_pool_factor: tree requests extract a pool of
                   ``k * tree_pool_factor`` distinct trees, so diversified
                   re-ranking and pagination have material beyond the
                   top-k.
      diversify_lambda: the MMR relevance/diversity trade-off for
                   ``tree_ranking="diverse"`` (1 = pure weight order,
                   0 = pure diversification).
      trace_sample: fraction of requests whose trace records spans
                   (deterministic per ``(trace_seed, trace_id)`` — see
                   :class:`repro_torch.obs.Tracer`).  Unsampled requests still
                   get a trace id on their :class:`ServedResult`.
      trace_capacity: finished sampled traces kept in the in-memory ring
                   (the ``/traces`` endpoint and ``recent_traces()``).
      trace_seed:  seed for the sampling hash — the same seed samples the
                   same trace ids on every run.
      trace_log:   path to append finished sampled traces as JSONL (the
                   structured event log); None disables.
    """

    max_batch: int = 8
    max_wait_ms: float = 5.0
    cache_size: int = 1024
    extract: bool = True
    strict: bool = True
    pad_batches: str = "pow2"   # "pow2" | "max" | "none" | "adaptive"
    default_deadline_ms: float | None = None
    tree_cache_size: int = 256
    tree_page_size: int = 5
    tree_pool_factor: int = 3
    diversify_lambda: float = 0.5
    trace_sample: float = 1.0
    trace_capacity: int = 256
    trace_seed: int = 0
    trace_log: str | None = None

    def __post_init__(self) -> None:
        if self.pad_batches not in ("pow2", "max", "none", "adaptive"):
            raise ValueError(f"unknown pad_batches {self.pad_batches!r}")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.tree_page_size < 1:
            raise ValueError("tree_page_size must be >= 1")
        if self.tree_pool_factor < 1:
            raise ValueError("tree_pool_factor must be >= 1")
        if not 0.0 <= self.diversify_lambda <= 1.0:
            raise ValueError("diversify_lambda must be in [0, 1]")
        if not 0.0 <= self.trace_sample <= 1.0:
            raise ValueError("trace_sample must be in [0, 1]")
        if self.trace_capacity < 1:
            raise ValueError("trace_capacity must be >= 1")


@dataclasses.dataclass(frozen=True)
class ServedResult:
    """One served request: the engine's answer plus serving metadata.

    Attributes:
      result:      the :class:`QueryResult` (for ``approximate`` results:
                   best-so-far weights/answers, ``done=False``, and the
                   forced-stop SPA bound on ``result.spa``).
      cache_hit:   served from the result cache (no device work).
      coalesced:   served by attaching to an identical request already in
                   flight (cross-request single-flight — no device work;
                   ``batch_size`` is the leader dispatch's).
      approximate: the deadline expired before the run's exit criterion —
                   the answer is best-so-far, bounded below by
                   ``opt_lower_bound`` (the paper's early-termination
                   guarantee as a serving feature).
      opt_lower_bound: the *reported* lower bound on the optimum from the
                   last streamed update (deadline-routed requests only) —
                   the paper's Sec. 5.4 convention, mixing the provably
                   sound ``nu`` bound with the SPA estimator, which can in
                   principle overestimate.
      sound_opt_lower_bound: the provably sound lower bound (``nu`` /
                   exhausted-frontier facts only).  This is the value a
                   client may rely on: optimum >= sound_opt_lower_bound,
                   always.
      batch_size:  real requests that shared this dispatch (deadline
                   buckets count their coalesced lanes too; 0 for cache
                   hits).
      latency_ms:  end-to-end submit -> resolve latency.
      trees:       one :class:`TreePage` of label-rendered, ranked answer
                   trees (``return_trees=True`` requests only; None
                   otherwise).  For approximate results these are the
                   best-so-far trees, bounded by ``opt_lower_bound``.
      trace_id:    id of this request's trace (every admitted request has
                   one; whether spans were recorded depends on
                   ``ServeConfig.trace_sample``).  Fetch the span tree
                   with ``svc.trace(trace_id)`` while it is in the ring.
      queue_wait_ms: time this request sat in the admission queue before
                   its bucket dispatched (ms); None on resolve paths that
                   never queue (cache hits, single-flight followers).
      device_ms:   the superstep loop's wall time for the
                   dispatch that served this request (ms; a shared bucket
                   bills the same number to every rider); None when no
                   device work happened.
    """

    result: QueryResult
    cache_hit: bool
    approximate: bool
    batch_size: int
    latency_ms: float
    opt_lower_bound: float | None = None
    sound_opt_lower_bound: float | None = None
    coalesced: bool = False
    trees: TreePage | None = None
    trace_id: int | None = None
    queue_wait_ms: float | None = None
    device_ms: float | None = None

    @property
    def weights(self):
        return self.result.weights

    @property
    def found(self) -> bool:
        return self.result.found

    @property
    def best_weight(self) -> float:
        return self.result.best_weight


class DKSService:
    """Micro-batching, caching, deadline-aware front end over one engine.

    Lifecycle: ``start()``/``stop()`` or use as a context manager.  Safe
    for any number of client threads; all device execution is serialized
    on the internal dispatcher thread.
    """

    def __init__(self, engine: QueryEngine,
                 config: ServeConfig | None = None) -> None:
        self.engine = engine
        self.config = config or ServeConfig()
        self._cache = ResultCache(self.config.cache_size)
        # Tree-pool LRU: cache_token -> (ranked AnswerTree pool,
        # exhausted).  Exact-only and version-safe for the same reason the
        # result cache is — the token carries the engine build version.
        # Ranking/pagination is computed per request FROM the pool, so one
        # entry serves every cursor/page-size/ranking combination.
        self._tree_cache = ResultCache(self.config.tree_cache_size)
        self._stats = StatsCollector()
        # Lane-occupancy policy: always constructed (its snapshot feeds
        # the metrics surface either way) but consulted for padding
        # decisions only under pad_batches="adaptive".  Both dispatch
        # paths feed it per-dispatch device time.
        self.lane_policy = AdaptiveLanePolicy(self.config.max_batch)
        self._batcher = MicroBatcher(
            self._dispatch, max_batch=self.config.max_batch,
            max_wait_ms=self.config.max_wait_ms,
            max_batch_for=(self.lane_policy.target_fill
                           if self.config.pad_batches == "adaptive"
                           else None))
        # Cross-request single-flight: cache_token -> follower list of an
        # identical request currently in flight.  A second identical miss
        # attaches here instead of executing again; the leader's done
        # callback fans its result out (and by then the leader's result
        # is already in the ResultCache, so there is no window where an
        # identical request re-executes).  Deadline requests never
        # participate — a best-so-far answer is budget-specific.
        # Follower tuples are (future, t_submit, trace); _inflight_traces
        # remembers the leader's trace id so followers can link to it.
        self._inflight: dict[Hashable, list] = {}
        self._inflight_traces: dict[Hashable, int] = {}
        self._inflight_lock = threading.Lock()
        # Observability: one trace per admitted request (the span trees
        # behind ``--explain`` and ``/traces``) and a metrics registry
        # whose serving counters are DERIVED from ``self.stats()`` at
        # scrape time — /metrics equals ServeStats by construction.
        self.tracer = Tracer(
            capacity=self.config.trace_capacity,
            sample=self.config.trace_sample,
            seed=self.config.trace_seed,
            log_path=self.config.trace_log)
        self.registry = MetricsRegistry()
        self._wire_metrics()

    # ------------------------------------------------------------------
    # Metrics
    # ------------------------------------------------------------------

    def _wire_metrics(self) -> None:
        """Expose serving state on ``self.registry``.

        Counters and gauges are scrape-time collectors over the SAME
        snapshots ``stats()`` / ``engine.*`` / ``tracer.stats()`` serve,
        so ``/metrics`` cannot drift from the Python-side reports.  Only
        the latency histograms are direct instruments (a percentile
        cannot be reconstructed at scrape time)."""
        reg = self.registry
        self._h_latency = reg.histogram(
            "dks_request_latency_ms",
            "End-to-end request latency (submit -> resolved future), ms.")
        self._h_queue = reg.histogram(
            "dks_queue_wait_ms",
            "Admission-queue wait before bucket dispatch, ms "
            "(dispatched requests only).")
        self._h_device = reg.histogram(
            "dks_device_time_ms",
            "Superstep loop wall time billed to each "
            "dispatched request, ms.")

        _C, _G = "counter", "gauge"
        serve_kinds = {
            "dks_requests_total": _C,
            "dks_failures_total": _C,
            "dks_batch_dispatches_total": _C,
            "dks_deadline_dispatches_total": _C,
            "dks_batched_requests_total": _C,
            "dks_deadline_batched_requests_total": _C,
            "dks_deadline_driver_supersteps_total": _C,
            "dks_deadline_lane_supersteps_total": _C,
            "dks_cache_hits_total": _C,
            "dks_cache_misses_total": _C,
            "dks_cache_evictions_total": _C,
            "dks_single_flight_hits_total": _C,
            "dks_approximate_total": _C,
            "dks_tree_requests_total": _C,
            "dks_tree_cache_hits_total": _C,
            "dks_mean_batch_fill": _G,
            "dks_cache_hit_rate": _G,
            "dks_throughput_rps": _G,
            "dks_latency_p50_ms": _G,
            "dks_latency_p95_ms": _G,
            "dks_queue_p50_ms": _G,
            "dks_queue_p95_ms": _G,
            "dks_device_p50_ms": _G,
            "dks_device_p95_ms": _G,
            "dks_engine_swaps_total": _C,
        }

        def collect_serve() -> dict[str, float]:
            s = self.stats()
            return {
                "dks_requests_total": s.requests,
                "dks_failures_total": s.failures,
                "dks_batch_dispatches_total": s.batch_dispatches,
                "dks_deadline_dispatches_total": s.deadline_dispatches,
                "dks_batched_requests_total": s.batched_requests,
                "dks_deadline_batched_requests_total":
                    s.deadline_batched_requests,
                "dks_deadline_driver_supersteps_total":
                    s.deadline_driver_supersteps,
                "dks_deadline_lane_supersteps_total":
                    s.deadline_lane_supersteps,
                "dks_cache_hits_total": s.cache_hits,
                "dks_cache_misses_total": s.cache_misses,
                "dks_cache_evictions_total": s.cache_evictions,
                "dks_single_flight_hits_total": s.single_flight_hits,
                "dks_approximate_total": s.approximate,
                "dks_tree_requests_total": s.tree_requests,
                "dks_tree_cache_hits_total": s.tree_cache_hits,
                "dks_mean_batch_fill": s.mean_batch_fill,
                "dks_cache_hit_rate": s.cache_hit_rate,
                "dks_throughput_rps": s.throughput_rps,
                "dks_latency_p50_ms": s.p50_ms,
                "dks_latency_p95_ms": s.p95_ms,
                "dks_queue_p50_ms": s.queue_p50_ms,
                "dks_queue_p95_ms": s.queue_p95_ms,
                "dks_device_p50_ms": s.device_p50_ms,
                "dks_device_p95_ms": s.device_p95_ms,
                "dks_engine_swaps_total": s.engine_swaps,
            }

        reg.register_collector(collect_serve, kinds=serve_kinds, helps={
            "dks_requests_total": "Requests served (cache hits included).",
            "dks_failures_total": "Dispatched requests whose run raised.",
        })

        def collect_engine() -> dict[str, float]:
            eng = self.engine  # follow set_engine swaps
            extract = eng.extraction_stats
            return {
                "dks_engine_execute_count_total": eng.execute_count,
                "dks_engine_traces_total": eng.cache_stats["traces"],
                "dks_engine_executables": eng.cache_stats["executables"],
                "dks_extract_device_resolved_total":
                    extract["device_resolved"],
                "dks_extract_host_fallbacks_total":
                    extract["host_fallbacks"],
            }

        reg.register_collector(collect_engine, kinds={
            "dks_engine_execute_count_total": _C,
            "dks_engine_traces_total": _C,
            "dks_engine_executables": _G,
            "dks_extract_device_resolved_total": _C,
            "dks_extract_host_fallbacks_total": _C,
        }, helps={
            "dks_engine_execute_count_total":
                "Device dispatches through the engine's executor cache.",
            "dks_engine_traces_total":
                "Executor preparations (first use of a query shape) — "
                "warm serving means this stays flat while execute_count "
                "climbs.",
            "dks_extract_device_resolved_total":
                "Lanes whose answer trees the batched device backtracer "
                "reconstructed.",
            "dks_extract_host_fallbacks_total":
                "Ragged lanes re-run through the host tree search.",
        })

        def collect_tracer() -> dict[str, float]:
            t = self.tracer.stats()
            return {
                "dks_traces_begun_total": t["begun"],
                "dks_traces_finished_total": t["finished"],
                "dks_traces_sampled_total": t["sampled"],
                "dks_traces_buffered": t["buffered"],
            }

        reg.register_collector(collect_tracer, kinds={
            "dks_traces_begun_total": _C,
            "dks_traces_finished_total": _C,
            "dks_traces_sampled_total": _C,
            "dks_traces_buffered": _G,
        }, helps={
            "dks_traces_begun_total":
                "Traces begun (one per admitted request); equal to "
                "finished once the service drains.",
        })

        def collect_lane_policy() -> dict[str, float]:
            snap = self.lane_policy.snapshot()
            out = {
                "dks_lane_policy_last_lanes": snap["last_lanes"],
                "dks_lane_policy_target_fill":
                    self.lane_policy.target_fill(),
            }
            for reason in ("exact", "warm", "pow2", "cap"):
                out[f"dks_lane_policy_decision_{reason}_total"] = (
                    snap["decisions"].get(reason, 0))
            return out

        reg.register_collector(collect_lane_policy, kinds=dict(
            {"dks_lane_policy_last_lanes": _G,
             "dks_lane_policy_target_fill": _G},
            **{f"dks_lane_policy_decision_{r}_total": _C
               for r in ("exact", "warm", "pow2", "cap")},
        ), helps={
            "dks_lane_policy_last_lanes":
                "Lane count of the most recent padding decision "
                "(pad_batches='adaptive').",
            "dks_lane_policy_target_fill":
                "Bucket size the adaptive policy considers worth waiting "
                "for (most-dispatched warm lane count).",
            "dks_lane_policy_decision_exact_total":
                "Decisions that dispatched at the real request count "
                "(zero padding lanes).",
            "dks_lane_policy_decision_warm_total":
                "Decisions that padded up to an already-measured lane "
                "count.",
        })

        def collect_batcher() -> dict[str, float]:
            counts = dict(self._batcher.dispatch_counts)
            return {f"dks_dispatch_reason_{reason}_total": n
                    for reason, n in counts.items()}

        reg.register_collector(collect_batcher, kinds={
            f"dks_dispatch_reason_{r}_total": _C
            for r in ("full", "window", "flush")
        }, helps={
            "dks_dispatch_reason_full_total":
                "Buckets dispatched because they reached max_batch.",
            "dks_dispatch_reason_window_total":
                "Buckets dispatched on admission-window expiry.",
            "dks_dispatch_reason_flush_total":
                "Buckets flushed at service stop.",
        })

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "DKSService":
        self._batcher.start()
        return self

    def stop(self) -> None:
        self._batcher.stop()

    def __enter__(self) -> "DKSService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def submit(self, keywords: Sequence, k: int = 1, *,
               deadline_ms: float | None = None,
               return_trees: bool = False,
               tree_ranking: str = "diverse",
               tree_cursor: int = 0,
               tree_page_size: int | None = None,
               **overrides) -> "Future[ServedResult]":
        """Admit one query; returns a future resolving to a
        :class:`ServedResult`.

        ``deadline_ms``: per-request latency budget.  Queue wait counts
        against it; when it expires mid-run the request resolves with the
        best-so-far answer, ``approximate=True``, and its SPA lower bound.
        Same-shape requests with the SAME budget coalesce onto one lane
        driver and share supersteps (a conservative group deadline — the
        earliest lane's — guarantees no lane overshoots its own budget).
        Deadline-less requests run to their exit criterion.
        ``overrides``: per-call policy overrides, forwarded to the engine
        (they key both the result cache and the shape bucket).

        ``return_trees``: serve a :class:`TreePage` of label-rendered
        answer trees on ``ServedResult.trees``.  ``tree_ranking`` picks
        the cursor order — "diverse" (MMR duplication-free, the default)
        or "weight" (plain rank) — and ``tree_cursor``/``tree_page_size``
        paginate over it; pass the page's ``next_cursor`` back to get the
        following page (served from the tree cache, no device work).
        Tree requests are exempt from single-flight (the in-flight twin
        may not be extracting a tree pool).

        Identical concurrent misses are single-flighted: the first one
        executes, later ones attach to its in-flight future and resolve
        from its result (``coalesced=True``) — including its failure, if
        it fails.  Deadline-bounded requests are exempt (their best-so-far
        answers are budget-specific, like the cache exemption).
        """
        t_submit = time.perf_counter()
        keywords = tuple(keywords)
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        future: Future = Future()
        if not self._batcher.running:
            raise RuntimeError("service is not running")
        # One trace per admitted request, finished on EVERY resolve path
        # (finish() is idempotent) — the tracer's begun == finished
        # counters are the completeness invariant the tests assert.
        trace = self.tracer.begin(
            "dks.request", m=len(keywords), k=k,
            deadline_ms=deadline_ms, trees=return_trees)

        def _reject(exc: BaseException) -> "Future[ServedResult]":
            trace.add_span("admit", t_submit, time.perf_counter(),
                           outcome="rejected")
            trace.set(outcome="rejected", error=repr(exc))
            trace.finish()
            future.set_exception(exc)
            return future

        if tree_ranking not in ("diverse", "weight"):
            return _reject(ValueError(
                f"unknown tree_ranking {tree_ranking!r} "
                "(expected 'diverse' or 'weight')"))
        engine = self.engine  # snapshot: set_engine must not swap mid-flight
        if self.config.strict:
            missing = engine.index.missing_tokens(list(keywords))
            if missing:
                # Admission-time validation: fail this request alone, not
                # the co-batched dispatch it would have poisoned.
                return _reject(KeyError(
                    f"keywords matched no node in the index: {missing}"))
        if overrides:
            # Normalize: an override equal to the engine's policy value is
            # no override at all — dropping it lets the request coalesce
            # with no-override requests (the batcher buckets on these) and
            # matches how cache_token's effective-policy key behaves.
            # Unknown override names fail this request's future at
            # admission, like every other admission error.
            try:
                overrides = {name: value
                             for name, value in overrides.items()
                             if getattr(engine.policy, name) != value}
            except AttributeError as exc:
                return _reject(TypeError(
                    f"unknown policy override: {exc}"))
        # Counters only move for requests that will actually be served: a
        # hit counts on the spot (its serving is the set_result below); a
        # miss counts only after durable admission to the batcher, so a
        # submit racing stop() skews neither the stats window nor the
        # miss rate.
        cache_key = engine.cache_token(keywords, k, **overrides)
        try:
            hash(cache_key)
        except TypeError as exc:
            # An unhashable keyword or override value would otherwise blow
            # up on the dispatcher thread; fail this request alone.
            return _reject(TypeError(
                f"unhashable query or override value: {exc}"))
        with trace.span("cache_lookup") as lookup:
            hit = self._cache.get(cache_key, count_miss=False)
            lookup.set(hit=hit is not None)
        if hit is not None:
            if not return_trees:
                trace.add_span("admit", t_submit, time.perf_counter(),
                               outcome="cache_hit")
                self._resolve_cache_hit(future, hit, t_submit, trace=trace)
                return future
            # A tree request needs the pool too: both caches must hit —
            # a result without its pool re-dispatches (the dense table is
            # long gone, so re-extraction means re-running the query).
            pool_entry = self._tree_cache.get((cache_key, "trees"))
            if pool_entry is not None:
                self._stats.record_tree_request(cache_hit=True)
                trace.add_span("admit", t_submit, time.perf_counter(),
                               outcome="tree_cache_hit")
                with trace.span("render", ranking=tree_ranking,
                                cursor=tree_cursor):
                    page = self._render_page(
                        pool_entry, engine, ranking=tree_ranking,
                        cursor=tree_cursor, page_size=tree_page_size)
                self._resolve_cache_hit(future, hit, t_submit, trees=page,
                                        trace=trace)
                return future
        single_flight = deadline_ms is None and not return_trees
        if single_flight:
            # Cross-request single-flight: an identical request is already
            # executing (same cache_token, so same engine build / k /
            # effective policy) — attach to its result instead of
            # dispatching a second run.  The follower resolves from the
            # leader's ServedResult with ``coalesced=True``; if the leader
            # fails or is cancelled, followers inherit that outcome.
            with self._inflight_lock:
                followers = self._inflight.get(cache_key)
                if followers is not None:
                    leader_id = self._inflight_traces.get(cache_key)
                    if leader_id is not None:
                        trace.link(coalesced_into=leader_id)
                    trace.add_span("admit", t_submit, time.perf_counter(),
                                   outcome="attached")
                    followers.append((future, t_submit, trace))
                    return future
                # The follower LIST OBJECT is captured by this leader's
                # closures below: resolution paths pop the dict entry only
                # if it is still this exact list (identity guard), so a
                # set_engine swap can retire pre-swap entries wholesale
                # without a stale leader later adopting (and answering
                # with the OLD build) followers who attached post-swap.
                entry: list = []
                self._inflight[cache_key] = entry
                self._inflight_traces[cache_key] = trace.trace_id
            # Leadership won — but the PREVIOUS leader may have resolved
            # between our cache check and the registration above (its
            # result cached, its inflight entry popped).  Re-check the
            # cache so a just-finished run is served instead of
            # re-executed; any follower that raced onto our short-lived
            # entry is served from the same hit.
            hit = self._cache.get(cache_key, count_miss=False)
            if hit is not None:
                with self._inflight_lock:
                    if self._inflight.get(cache_key) is entry:
                        self._inflight.pop(cache_key)
                        self._inflight_traces.pop(cache_key, None)
                trace.add_span("admit", t_submit, time.perf_counter(),
                               outcome="cache_hit")
                self._resolve_cache_hit(future, hit, t_submit, trace=trace)
                for fut, t_sub, f_trace in entry:
                    if fut.set_running_or_notify_cancel():
                        self._resolve_cache_hit(fut, hit, t_sub,
                                                trace=f_trace)
                    elif f_trace is not None:
                        f_trace.set(outcome="cancelled")
                        f_trace.finish()
                return future
        trace.add_span("admit", t_submit, time.perf_counter(),
                       outcome="queued")
        try:
            self._batcher.submit(Request(
                keywords=keywords, k=k,
                overrides=tuple(sorted(overrides.items())),
                future=future, t_submit=t_submit, engine=engine,
                deadline_t=(t_submit + deadline_ms / 1e3
                            if deadline_ms is not None else None),
                deadline_ms=deadline_ms,
                cache_key=cache_key,
                trace=trace,
                return_trees=return_trees,
                tree_ranking=tree_ranking,
                tree_cursor=tree_cursor,
                tree_page_size=tree_page_size))
        except BaseException as exc:
            trace.set(outcome="error", error=repr(exc))
            trace.finish()
            if single_flight:
                self._abort_single_flight(cache_key, entry, exc)
            raise
        if single_flight:
            # The callback runs when the dispatcher resolves the leader —
            # by then the result already sits in the ResultCache (put
            # happens before set_result), so an identical submit landing
            # after the pop is caught by the cache (the leadership
            # re-check above closes the remaining pre-put window).
            future.add_done_callback(
                lambda fut: self._finish_single_flight(cache_key, entry,
                                                       fut))
        self._cache.count_miss()
        return future

    def query(self, keywords: Sequence, k: int = 1, *,
              deadline_ms: float | None = None, timeout: float | None = None,
              return_trees: bool = False, tree_ranking: str = "diverse",
              tree_cursor: int = 0, tree_page_size: int | None = None,
              **overrides) -> ServedResult:
        """Blocking :meth:`submit` — one served answer."""
        return self.submit(keywords, k,
                           deadline_ms=deadline_ms,
                           return_trees=return_trees,
                           tree_ranking=tree_ranking,
                           tree_cursor=tree_cursor,
                           tree_page_size=tree_page_size, **overrides
                           ).result(timeout)

    def _resolve_cache_hit(self, future: Future, hit: QueryResult,
                           t_submit: float,
                           trees: TreePage | None = None,
                           trace=None) -> None:
        """Resolve one future from a cached result (stats recorded)."""
        t_done = time.perf_counter()
        self._stats.record_request(t_submit, t_done)
        self._h_latency.observe((t_done - t_submit) * 1e3)
        trace_id = None
        if trace is not None:
            trace_id = trace.trace_id
            trace.set(outcome="cache_hit")
            trace.finish()
        future.set_result(ServedResult(
            result=hit, cache_hit=True, approximate=False,
            batch_size=0, latency_ms=(t_done - t_submit) * 1e3,
            trees=trees, trace_id=trace_id))

    # ------------------------------------------------------------------
    # Single-flight bookkeeping
    # ------------------------------------------------------------------

    def _finish_single_flight(self, cache_key: Hashable, entry: list,
                              leader: "Future[ServedResult]") -> None:
        """Leader resolved: fan its outcome out to attached followers.

        ``entry`` is the leader's own follower list (captured at
        registration).  The dict entry is popped only if it is still that
        exact list — after a ``set_engine`` swap retired it (or a newer
        leader registered), the current entry belongs to someone else and
        must not be touched.  Either way no new follower can attach to
        ``entry`` once this runs: it is out of the dict, so the local
        fan-out below is complete."""
        with self._inflight_lock:
            if self._inflight.get(cache_key) is entry:
                self._inflight.pop(cache_key)
                self._inflight_traces.pop(cache_key, None)
        followers = entry
        if not followers:
            return
        exc: BaseException | None
        if leader.cancelled():
            exc = CancelledError()
        else:
            exc = leader.exception()
        for fut, t_sub, f_trace in followers:
            if not fut.set_running_or_notify_cancel():
                if f_trace is not None:
                    f_trace.set(outcome="cancelled")
                    f_trace.finish()
                continue
            if exc is not None:
                self._stats.record_failure(1)
                if f_trace is not None:
                    f_trace.set(outcome="error", error=repr(exc))
                    f_trace.finish()
                fut.set_exception(exc)
                continue
            t_done = time.perf_counter()
            self._stats.record_request(t_sub, t_done)
            self._stats.record_single_flight()
            self._h_latency.observe((t_done - t_sub) * 1e3)
            trace_id = None
            if f_trace is not None:
                trace_id = f_trace.trace_id
                f_trace.set(outcome="attached")
                f_trace.finish()
            fut.set_result(dataclasses.replace(
                leader.result(), coalesced=True, trace_id=trace_id,
                queue_wait_ms=None, device_ms=None,
                latency_ms=(t_done - t_sub) * 1e3))

    def _abort_single_flight(self, cache_key: Hashable, entry: list,
                             exc: BaseException) -> None:
        """Leader never reached the batcher: fail any follower that raced
        in and free the key (same identity guard as
        :meth:`_finish_single_flight`)."""
        with self._inflight_lock:
            if self._inflight.get(cache_key) is entry:
                self._inflight.pop(cache_key)
                self._inflight_traces.pop(cache_key, None)
        for fut, _t_sub, f_trace in entry:
            if f_trace is not None:
                f_trace.set(outcome="error", error=repr(exc))
                f_trace.finish()
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)

    # ------------------------------------------------------------------
    # Cache control / introspection
    # ------------------------------------------------------------------

    def invalidate_cache(self) -> int:
        """Drop every cached result and tree pool (call on graph
        rebuild).  Returns the number of entries dropped."""
        return self._cache.invalidate() + self._tree_cache.invalidate()

    def _render_page(self, pool_entry: tuple, engine: QueryEngine, *,
                     ranking: str, cursor: int,
                     page_size: int | None) -> TreePage:
        """One :class:`TreePage` from a ``(ranked pool, exhausted)``
        entry: rank order or MMR permutation, cut at the cursor, labels
        from the engine (artifact label blob for ingested graphs)."""
        pool, exhausted = pool_entry
        pool = list(pool)
        if ranking == "diverse":
            order = diversified_order(pool, self.config.diversify_lambda)
        else:
            order = list(range(len(pool)))
        return paginate(
            pool, order, cursor,
            page_size if page_size is not None
            else self.config.tree_page_size,
            ranking, exhausted,
            label_fn=engine.node_label, graph=engine.graph)

    def set_engine(self, engine: QueryEngine) -> None:
        """Swap in a rebuilt engine (graph update) — zero-downtime.

        In-flight requests snapshot their admitting engine, so they are
        answered by the previous build (its version rides on the batcher
        shape key — a dispatch never mixes builds).  The swap then:

        - invalidates the result cache AND the tree-pool LRU (both keyed
          under the outgoing version; version-keyed lookups would miss
          anyway, but retiring them frees the memory immediately);
        - retires every in-flight single-flight entry, so a pre-swap
          leader can no longer adopt post-swap followers — post-swap
          submits of the same query become their own leaders on the new
          build, while retired leaders still resolve their already-
          attached followers through the list object captured in their
          closures (identity-guarded, see ``_finish_single_flight``);
        - counts the swap in ``ServeStats.engine_swaps`` (exported as
          ``dks_engine_swaps_total``).
        """
        self.engine = engine
        self.invalidate_cache()
        with self._inflight_lock:
            self._inflight.clear()
            self._inflight_traces.clear()
        self._stats.record_engine_swap()

    def stats(self) -> ServeStats:
        """Aggregate :class:`ServeStats` snapshot (p50/p95 latency,
        throughput, batch-fill, cache-hit rate)."""
        return self._stats.report(self._cache.stats())

    def trace(self, trace_id: int):
        """The finished :class:`repro_torch.obs.Trace` for a served request's
        ``ServedResult.trace_id``, while it is still in the tracer ring
        (None if evicted or unsampled)."""
        return self.tracer.get(trace_id)

    def recent_traces(self, n: int | None = None):
        """Most recent finished sampled traces, newest last."""
        return self.tracer.recent(n)

    # ------------------------------------------------------------------
    # Dispatcher-thread execution
    # ------------------------------------------------------------------

    def _dispatch(self, group: list[Request]) -> None:
        # Move every future to RUNNING before touching the device: a
        # client that cancelled while queued drops out here (saving its
        # lanes), and set_result below can no longer race a cancel —
        # which would poison the co-batched futures with InvalidStateError.
        alive = []
        for req in group:
            if req.future.set_running_or_notify_cancel():
                alive.append(req)
            elif req.trace is not None:
                req.trace.set(outcome="cancelled")
                req.trace.finish()
        group = alive
        if not group:
            return
        try:
            if group[0].deadline_t is not None:
                self._serve_deadline_batch(group)
            else:
                self._serve_batch(group)
        except BaseException as exc:
            # The batcher resolves the still-pending futures with this
            # exception; count only those, so requests + failures equals
            # admitted load even if some of the group already resolved.
            pending = [req for req in group if not req.future.done()]
            self._stats.record_failure(len(pending))
            for req in pending:
                if req.trace is not None:
                    req.trace.set(outcome="error", error=repr(exc))
                    req.trace.finish()
            raise

    def _padded_len(self, n: int) -> int:
        mode = self.config.pad_batches
        if mode == "none" or n >= self.config.max_batch:
            return n
        if mode == "max":
            return self.config.max_batch
        if mode == "adaptive":
            return self.lane_policy.lanes_for(
                n, hot_shapes=self.stats().hot_shapes).lanes
        p = 1
        while p < n:
            p *= 2
        return min(p, self.config.max_batch)

    def _observe_dispatch(self, group: list[Request], n_lanes: int,
                          t_dispatch: float, *,
                          deadline_budget_ms: float | None = None) -> None:
        """Queue-wait spans for every rider, a ``coalesce`` span +
        ``coalesced_into`` links under the bucket leader (group[0])."""
        for req in group:
            if req.trace is not None:
                req.trace.add_span("queue_wait", req.t_submit, t_dispatch)
        leader = group[0].trace
        if leader is not None:
            attrs = dict(shape=f"m{len(group[0].keywords)}k{group[0].k}",
                         fill=len(group), lanes=n_lanes,
                         reason=self._batcher.current_reason)
            if deadline_budget_ms is not None:
                attrs["deadline_budget_ms"] = round(deadline_budget_ms, 3)
            leader.add_span("coalesce", group[0].t_submit, t_dispatch,
                            **attrs)
            for req in group[1:]:
                if req.trace is not None:
                    req.trace.link(coalesced_into=leader.trace_id)

    def _serve_batch(self, group: list[Request]) -> None:
        cfg = self.config
        # The admitting engine build serves the group (a group never mixes
        # builds — the build version is part of the batcher's shape key).
        engine = group[0].engine
        queries = [list(req.keywords) for req in group]
        n_real = len(queries)
        queries += [queries[-1]] * (self._padded_len(n_real) - n_real)
        t_dispatch = time.perf_counter()
        self._observe_dispatch(group, len(queries), t_dispatch)
        leader = group[0].trace
        # Tree requests widen extraction to a ranked pool for the WHOLE
        # bucket (extraction is per-lane host work; the pool rides the
        # same device-batched backtrace pass either way) and force
        # extraction on even for weight-only configs.
        want_trees = any(req.return_trees for req in group)
        pool_n = group[0].k * cfg.tree_pool_factor if want_trees else None
        # First-use vs warm split: the engine's trace counter moves exactly
        # when this dispatch prepared a new executor for the shape.
        overrides = dict(group[0].overrides)
        m, k = len(group[0].keywords), group[0].k
        traces_before = engine.trace_count(m, k, **overrides)
        extract_before = engine.extraction_stats
        # n_real: padding lanes ride the device program for shape reuse
        # but skip host-side result construction in the engine.
        results = engine.query_batch(
            queries, k=k, extract=cfg.extract or want_trees,
            extract_pool=pool_n, strict=cfg.strict,
            n_real=n_real, **overrides)
        t_done = time.perf_counter()
        compiled = engine.trace_count(m, k, **overrides) > traces_before
        extract_after = engine.extraction_stats
        # The engine's wall_time_s times the superstep loop alone; the
        # rest of the dispatch interval is host-side extraction + result
        # construction.  Splitting the interval at that boundary gives
        # every rider an honest device span without a second clock read
        # inside the engine.
        device_ms = results[0].wall_time_s * 1e3 if results else 0.0
        t_device_end = min(t_done, t_dispatch + device_ms / 1e3)
        if leader is not None:
            leader.add_span("device_dispatch", t_dispatch, t_device_end,
                            compiled=compiled, lanes=len(queries))
            leader.add_span(
                "extract", t_device_end, t_done,
                mode="device" if cfg.extract or want_trees else "skipped",
                device_resolved=(extract_after["device_resolved"]
                                 - extract_before["device_resolved"]),
                host_fallbacks=(extract_after["host_fallbacks"]
                                - extract_before["host_fallbacks"]))
        self.lane_policy.observe(len(queries), device_ms)
        self._stats.record_dispatch(n_real, deadline=False,
                                    shape=(m, k, len(queries)))
        # After a set_engine swap, results of the old build are keyed
        # under its version — unreachable to every future lookup, so
        # caching them would only evict live entries.
        cacheable = engine is self.engine
        for req, res in zip(group, results):
            if cacheable:
                with (req.trace.span("cache_store") if req.trace is not None
                      else _NULL_SPAN):
                    self._cache.put(req.cache_key, res)
                    if want_trees and res.answer_pool is not None:
                        self._tree_cache.put(
                            (req.cache_key, "trees"),
                            (res.answer_pool, res.pool_exhausted))
            trees = None
            if req.return_trees:
                self._stats.record_tree_request(cache_hit=False)
                with (req.trace.span("render", ranking=req.tree_ranking,
                                     cursor=req.tree_cursor)
                      if req.trace is not None else _NULL_SPAN):
                    trees = self._render_page(
                        (res.answer_pool or [], res.pool_exhausted), engine,
                        ranking=req.tree_ranking, cursor=req.tree_cursor,
                        page_size=req.tree_page_size)
            t_res = time.perf_counter()
            queue_ms = (t_dispatch - req.t_submit) * 1e3
            self._stats.record_request(req.t_submit, t_res,
                                       queue_wait_ms=queue_ms,
                                       device_ms=device_ms)
            self._h_latency.observe((t_res - req.t_submit) * 1e3)
            self._h_queue.observe(queue_ms)
            self._h_device.observe(device_ms)
            trace_id = None
            if req.trace is not None:
                trace_id = req.trace.trace_id
                req.trace.set(outcome="served", compiled=compiled)
                req.trace.finish()
            req.future.set_result(ServedResult(
                result=res, cache_hit=False, approximate=False,
                batch_size=n_real,
                latency_ms=(t_res - req.t_submit) * 1e3,
                trees=trees, trace_id=trace_id,
                queue_wait_ms=queue_ms, device_ms=device_ms))

    def _serve_deadline_batch(self, group: list[Request]) -> None:
        cfg = self.config
        engine = group[0].engine
        queries = [list(req.keywords) for req in group]
        n_real = len(queries)
        queries += [queries[-1]] * (self._padded_len(n_real) - n_real)
        # One lane driver for the whole bucket.  The group deadline is the
        # EARLIEST lane's (conservative: requests with the same budget
        # admitted within one window differ by at most that window, and
        # no lane may overshoot its own deadline).  query_deadline_batch
        # spends the budget on supersteps, not on per-superstep bound
        # computation (the SPA cover DP can cost many times a superstep);
        # per-lane bounds are computed once, at the end.  Queue wait
        # already counted against the deadline.
        deadline_t = min(req.deadline_t for req in group)
        t_dispatch = time.perf_counter()
        self._observe_dispatch(
            group, len(queries), t_dispatch,
            deadline_budget_ms=(deadline_t - t_dispatch) * 1e3)
        leader = group[0].trace
        want_trees = any(req.return_trees for req in group)
        pool_n = group[0].k * cfg.tree_pool_factor if want_trees else None
        overrides = dict(group[0].overrides)
        m, k = len(group[0].keywords), group[0].k
        traces_before = engine.trace_count(m, k, kind="stepwise",
                                           **overrides)
        out = engine.query_deadline_batch(
            queries, k=k, extract=cfg.extract or want_trees,
            extract_pool=pool_n, strict=cfg.strict,
            deadline_s=deadline_t - time.perf_counter(), n_real=n_real,
            **overrides)
        t_done = time.perf_counter()
        compiled = engine.trace_count(m, k, kind="stepwise",
                                      **overrides) > traces_before
        driver_steps = out[0][1]["driver_supersteps"] if out else 0
        lane_steps = sum(res.supersteps for res, _ in out[:n_real])
        device_ms = out[0][0].wall_time_s * 1e3 if out else 0.0
        t_device_end = min(t_done, t_dispatch + device_ms / 1e3)
        if leader is not None:
            leader.add_span("device_dispatch", t_dispatch, t_device_end,
                            compiled=compiled, lanes=len(queries),
                            driver_supersteps=driver_steps)
            extraction = (out[0][1].get("extraction", {})
                          if out else {})
            leader.add_span(
                "extract", t_device_end, t_done,
                mode="overlapped" if extraction else "inline",
                **extraction)
        self.lane_policy.observe(len(queries), device_ms)
        self._stats.record_dispatch(n_real, deadline=True,
                                    driver_steps=driver_steps,
                                    lane_steps=lane_steps,
                                    shape=(m, k, len(queries)))
        cacheable = engine is self.engine
        for req, (res, info) in zip(group, out):
            approximate = info["interrupted"]
            if not approximate and cacheable:
                # Finished inside its budget: an exact answer, cacheable
                # like any other (unless the build was swapped while in
                # flight — the old-version key would be unreachable).
                # Best-so-far results are budget-specific — never cached,
                # and neither are their tree pools.
                with (req.trace.span("cache_store") if req.trace is not None
                      else _NULL_SPAN):
                    self._cache.put(req.cache_key, res)
                    if want_trees and res.answer_pool is not None:
                        self._tree_cache.put(
                            (req.cache_key, "trees"),
                            (res.answer_pool, res.pool_exhausted))
            trees = None
            if req.return_trees:
                self._stats.record_tree_request(cache_hit=False)
                # For interrupted lanes these are the BEST-SO-FAR trees,
                # served alongside their lower bound — the paper's
                # early-termination answer, now with explanations.
                with (req.trace.span("render", ranking=req.tree_ranking,
                                     cursor=req.tree_cursor)
                      if req.trace is not None else _NULL_SPAN):
                    trees = self._render_page(
                        (res.answer_pool or [], res.pool_exhausted), engine,
                        ranking=req.tree_ranking, cursor=req.tree_cursor,
                        page_size=req.tree_page_size)
            queue_ms = (t_dispatch - req.t_submit) * 1e3
            self._stats.record_request(req.t_submit, t_done,
                                       approximate=approximate,
                                       queue_wait_ms=queue_ms,
                                       device_ms=device_ms)
            self._h_latency.observe((t_done - req.t_submit) * 1e3)
            self._h_queue.observe(queue_ms)
            self._h_device.observe(device_ms)
            trace_id = None
            if req.trace is not None:
                trace_id = req.trace.trace_id
                req.trace.set(outcome="served", approximate=approximate,
                              compiled=compiled)
                req.trace.finish()
            req.future.set_result(ServedResult(
                result=res, cache_hit=False, approximate=approximate,
                batch_size=n_real,
                latency_ms=(t_done - req.t_submit) * 1e3,
                opt_lower_bound=info["opt_lower_bound"],
                sound_opt_lower_bound=info["sound_opt_lower_bound"],
                trees=trees, trace_id=trace_id,
                queue_wait_ms=queue_ms, device_ms=device_ms))
