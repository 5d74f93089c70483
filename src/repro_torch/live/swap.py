"""EngineSwapper — zero-downtime engine replacement for DKSService.

A copy of ``repro.live.swap``; the successor is built on the outgoing
engine's device.  On a card, the warm's kernel launches run on the calling
thread while the service's dispatcher launches on the outgoing engine: both
enqueue on the same (default) stream, so the warm serialises with serving
on the device.

The swap pipeline runs entirely OFF the dispatcher thread (the watcher
thread, or whatever thread calls :meth:`swap_to`), so serving never
stalls behind a rebuild:

    build   QueryEngine.build(artifact=chain)   — mmap-open the grown
            chain; version = the chained hash.
    warm    replay the hot ``(m, k, lanes)`` shape buckets ServeStats
            recorded for the *current* traffic, so the successor's
            first uses happen before any request lands on them.
    swap    DKSService.set_engine(successor)     — atomic reference
            swap + cache/single-flight invalidation; in-flight requests
            finish on the build that admitted them.

Each swap is traced (``dks.swap`` with build/warm/swap child spans, the
target hash and outcome on the trace) and metered:
``dks_engine_swaps_total`` comes from :class:`ServeStats`;
:meth:`wire_metrics` adds ``dks_delta_applied_total`` and
``dks_graph_staleness_seconds`` (how long published-but-not-yet-served
data has been waiting — 0 when the serving engine is current).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from repro_torch.engine.engine import QueryEngine
from repro_torch.graph.index import mid_df_tokens


class EngineSwapper:
    """Build, warm, and atomically install successor engines into a
    :class:`repro_torch.serve.DKSService`.

    ``on_delta`` matches the :class:`repro_torch.live.GraphWatcher` callback
    signature, so the whole live loop is::

        swapper = EngineSwapper(svc)
        swapper.wire_metrics()
        GraphWatcher(live, "incoming/", on_delta=swapper.on_delta).start()

    ``warm_top`` caps how many distinct hot shapes get pre-compiled per
    swap (each is one ``query_batch`` compile); ``policy=None`` carries
    the outgoing engine's execution policy forward.
    """

    def __init__(self, service: Any, *, policy: Any = None,
                 warm_top: int = 4) -> None:
        self.service = service
        self.policy = policy
        self.warm_top = int(warm_top)
        self._lock = threading.Lock()
        self._applied = 0          # deltas folded into a *serving* engine
        self._pending = 0          # published deltas not yet served
        self._pending_since: float | None = None
        self.swaps = 0
        # The hot shapes the last warm tried, and those it ran: equal
        # unless a shape raised (the warm swallows it, as ``repro``'s does).
        self.last_hot: list[tuple] = []
        self.last_warmed: list[tuple] = []

    # -- staleness bookkeeping -----------------------------------------

    def published(self, n: int = 1) -> None:
        """Record ``n`` published-but-not-yet-served deltas (starts the
        staleness clock if it isn't already running)."""
        with self._lock:
            self._pending += n
            if self._pending_since is None:
                self._pending_since = time.monotonic()

    @property
    def deltas_applied(self) -> int:
        with self._lock:
            return self._applied

    @property
    def staleness_seconds(self) -> float:
        """Seconds the oldest published-but-unserved delta has waited
        (0.0 when the serving engine is current)."""
        with self._lock:
            if self._pending_since is None:
                return 0.0
            return time.monotonic() - self._pending_since

    # -- the swap pipeline ---------------------------------------------

    def on_delta(self, live: Any, delta: Any) -> None:
        """:class:`GraphWatcher` callback: a delta was just published —
        rebuild on the grown chain and swap it in."""
        self.published()
        self.swap_to(live.chain())

    def swap_to(self, target: Any) -> QueryEngine:
        """Run build → warm → swap against ``target`` (a
        :class:`~repro_torch.store.GraphChain`, artifact, or artifact path).
        Returns the installed engine.  Raises whatever the build raised
        — the service keeps serving the old graph, and the staleness
        gauge keeps climbing, which is the observable alarm."""
        svc = self.service
        trace = svc.tracer.begin(
            "dks.swap",
            target=getattr(target, "content_hash", str(target))[:12],
            from_version=svc.engine.version)
        try:
            t0 = time.perf_counter()
            engine = QueryEngine.build(
                artifact=target, policy=self.policy or svc.engine.policy,
                device=svc.engine.device)
            trace.add_span("build", t0, time.perf_counter(),
                           version=engine.version)

            t0 = time.perf_counter()
            warmed = self._warm(engine)
            trace.add_span("warm", t0, time.perf_counter(),
                           shapes=len(warmed))

            t0 = time.perf_counter()
            svc.set_engine(engine)
            trace.add_span("swap", t0, time.perf_counter())

            with self._lock:
                self._applied += self._pending
                self._pending = 0
                self._pending_since = None
                self.swaps += 1
            self.last_warmed = warmed
            trace.set(outcome="swapped", version=engine.version)
            return engine
        except BaseException as exc:
            trace.set(outcome="error", error=repr(exc))
            raise
        finally:
            trace.finish()

    def _warm(self, engine: QueryEngine) -> list[tuple]:
        """Run the successor once at each hot ``(m, k, lanes)`` bucket the
        service recorded (``repro`` compiles its executables here; the
        port has nothing to compile, but the warm makes each shape's first
        use and, on a card, launches the kernels on the new graph before
        any request does).  Warming queries draw mid-df tokens from the
        *new* index and run with ``extract=False, strict=False,
        n_real=1``.  Best effort, as in ``repro``: a shape that raises is
        left out of the returned list, and the swap still lands."""
        shapes = [tuple(int(x) for x in s) for s, _count in
                  getattr(self.service.stats(), "hot_shapes", ())
                  [:self.warm_top]]
        self.last_hot = shapes
        if not shapes:
            return []
        tokens = mid_df_tokens(engine.index)
        warmed: list[tuple] = []
        for m, k, lanes in shapes:
            if len(tokens) < m or m < 1 or lanes < 1:
                continue
            try:
                engine.query_batch([list(tokens[:m])] * lanes, k=k,
                                   extract=False, strict=False, n_real=1)
            except Exception:
                continue   # warming is best-effort; the swap still lands
            warmed.append((m, k, lanes))
        return warmed

    # -- metrics -------------------------------------------------------

    def wire_metrics(self, registry: Optional[Any] = None) -> None:
        """Register the live-graph collectors on ``registry`` (defaults
        to the service's own registry, i.e. its ``/metrics`` surface)."""
        reg = registry if registry is not None else self.service.registry

        def collect_live() -> dict[str, float]:
            return {
                "dks_delta_applied_total": float(self.deltas_applied),
                "dks_graph_staleness_seconds": self.staleness_seconds,
            }

        reg.register_collector(
            collect_live,
            kinds={"dks_delta_applied_total": "counter",
                   "dks_graph_staleness_seconds": "gauge"},
            helps={"dks_delta_applied_total":
                   "Delta artifacts folded into a serving engine.",
                   "dks_graph_staleness_seconds":
                   "Age of the oldest published-but-unserved delta "
                   "(0 when the serving engine is current)."})
