"""repro_torch.serve — the serving subsystem on top of :class:`QueryEngine`
(the port of ``repro.serve``).

Turns the engine's one-blocking-call-at-a-time query surface into an
online answer-ranking service (the workload EMBANKS/KlusTree frame, and
the ROADMAP's heavy-traffic north star):

    from repro_torch.serve import DKSService, ServeConfig

    with DKSService(engine, ServeConfig(max_batch=8, max_wait_ms=5.0)) as svc:
        served = svc.query(["paris", "piano"], k=3, deadline_ms=50.0)
    print(svc.stats().summary())

Public API:
  DKSService    — admission + dynamic micro-batching (shape-bucketed
                  through the engine's lane driver), LRU result
                  cache, cross-request single-flight (concurrent
                  identical misses execute once), and deadline-bounded
                  best-so-far answers with SPA lower bounds (paper
                  Sec. 5.4 as a serving feature).
  ServeConfig   — max_batch / max_wait_ms / cache_size / padding / tree
                  serving knobs.
  ServedResult  — QueryResult + cache_hit / approximate / opt_lower_bound
                  / batch_size / latency_ms / trees (a TreePage when the
                  request asked with return_trees=True: label-rendered,
                  diversity- or weight-ranked, cursor-paginated answer
                  trees backed by a tree-pool LRU keyed on cache_token).
  ServeStats    — p50/p95 latency (end-to-end plus queue-wait/device-time
                  splits), throughput, batch-fill, cache-hit rate,
                  tree-request counters.
  ResultCache   — the LRU (exposed for direct use and tests).
  TreePage / RenderedTree / RenderedEdge — the served tree payloads
                  (re-exported from repro_torch.answers).
  loadgen       — synthetic traces + concurrent replay clients
                  (make_trace / replay / TraceRequest / latency_split).
  follow        — the ranks above 0 of a service over a graph split one
                  shard a rank: replay rank 0's records (its engine calls,
                  in order) until it stops (:mod:`repro_torch.serve.follower`).

Observability (:mod:`repro_torch.obs`): every admitted request carries a trace
(``ServedResult.trace_id`` -> ``svc.trace(id)``), and ``svc.registry``
exposes the ServeStats counters, engine executor/extraction counters,
and latency histograms in Prometheus text format (``serve_dks
--metrics-port`` serves it over HTTP).
"""

from repro_torch.answers import RenderedEdge, RenderedTree, TreePage  # noqa: F401
from repro_torch.serve.cache import ResultCache  # noqa: F401
from repro_torch.serve.follower import Record, follow  # noqa: F401
from repro_torch.serve.service import (  # noqa: F401
    DKSService,
    ServeConfig,
    ServedResult,
)
from repro_torch.serve.stats import ServeStats  # noqa: F401
