"""Serving statistics: per-request latencies, dispatch batch-fill, and
cache counters, aggregated into the :class:`ServeStats` report (p50/p95
latency, throughput, batch-fill, cache-hit rate).

Latencies are end-to-end client latencies — submit to resolved future —
so they include queue wait and the micro-batching admission window, not
just device time.  That is the number a latency budget is written against.
The queue-wait and device-time splits (fed from the request traces, see
:mod:`repro_torch.obs`) break that end-to-end number down: a p95 blowup with a
flat device split is an admission/queueing problem, not a kernel one.

Every ``ServeStats`` field carries its unit in the name or docstring:
``*_ms`` are milliseconds, ``window_s`` seconds, ``throughput_rps``
requests/second; everything else is a dimensionless count or ratio.
All fields are finite for any history, including the empty startup
window (no NaN percentiles before the first request resolves).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

import numpy as np

# Latency percentiles are computed over a bounded window of the most
# recent requests, so a long-lived service holds O(1) memory and stats()
# stays cheap; counters (requests, failures, ...) are exact totals.
LATENCY_WINDOW = 16384


def _pct(values, q: float) -> float:
    """Percentile that is 0.0 (not NaN) on an empty window."""
    arr = np.asarray(values, np.float64)
    return float(np.percentile(arr, q)) if arr.size else 0.0


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """Aggregate serving report (one snapshot of ``DKSService.stats()``).

    Attributes (units: ``*_ms`` milliseconds, ``window_s`` seconds,
    ``throughput_rps`` requests/second; all others counts or ratios):

      requests:        count of requests served so far (cache hits
                       included; admission-rejected submits are not
                       counted and do not skew the window).
      failures:        count of dispatched requests whose execution
                       raised (their futures carry the exception).
      batch_dispatches: count of device dispatches made by the
                       micro-batcher.
      deadline_dispatches: count of lane-driver dispatches for
                       deadline-bounded requests (same-shape same-budget
                       requests coalesce onto one stepwise driver and
                       share supersteps).
      batched_requests: count of requests served through batch dispatches.
      mean_batch_fill: ratio batched_requests / batch_dispatches — how
                       many client requests each lane-driver program
                       served (padding lanes are not counted; > 1 means
                       the batcher is amortizing dispatch across clients).
      deadline_batched_requests / mean_deadline_fill: the same pair for
                       deadline dispatches (> 1 mean fill means at least
                       one multi-lane deadline bucket rode one driver).
      deadline_driver_supersteps: count of supersteps the shared deadline
                       drivers actually stepped.
      deadline_lane_supersteps: sum of the per-lane superstep counts those
                       drivers served (what solo serving would pay at
                       minimum).  driver << lane = coalescing is working:
                       a bucket costs ~max(lane steps), not the sum.
      cache_hits / cache_misses / cache_evictions / cache_hit_rate:
                       result-cache counters (hit rate over hits+misses).
      single_flight_hits: count of requests that attached to an identical
                       request already in flight (cross-request
                       single-flight) — served from the leader's result,
                       no device work, not counted in the cache counters.
      approximate:     count of requests answered best-so-far under a
                       deadline.
      tree_requests:   count of requests that asked for answer trees
                       (``return_trees=True``).
      tree_cache_hits: tree requests served whole from the result cache
                       plus the tree-pool LRU — no device work, no
                       re-extraction (re-ranking/pagination only).
      p50_ms / p95_ms / mean_ms / max_ms: end-to-end latency (submit ->
                       resolved future, milliseconds) over the last
                       ``LATENCY_WINDOW`` requests (exact until the
                       window fills); 0.0 before the first request.
      queue_p50_ms / queue_p95_ms / queue_mean_ms: queue-wait split
                       (milliseconds): submit -> the dispatcher picking
                       the request up, fed from the ``queue_wait`` trace
                       span.  Cache hits and single-flight followers
                       never enter the queue and are not in this window.
      device_p50_ms / device_p95_ms / device_mean_ms: device-time split
                       (milliseconds): the compiled superstep program's
                       wall time attributed to each dispatched request
                       (one bucket's device time counted once per rider).
      window_s:        first submit -> last resolve, seconds.
      throughput_rps:  requests / window_s, requests per second.
      engine_swaps:    count of hot engine swaps (``set_engine``) this
                       service has performed — every swap invalidates the
                       result/tree caches and retires in-flight
                       single-flight leadership.
      hot_shapes:      dispatch shape histogram, hottest first:
                       ``(((m, k, lanes), count), ...)`` over every device
                       dispatch — what an engine swap pre-compiles so the
                       successor takes no cold-compile hit on the traffic
                       actually being served.
    """

    requests: int
    failures: int
    batch_dispatches: int
    deadline_dispatches: int
    batched_requests: int
    mean_batch_fill: float
    deadline_batched_requests: int
    mean_deadline_fill: float
    deadline_driver_supersteps: int
    deadline_lane_supersteps: int
    cache_hits: int
    cache_misses: int
    cache_evictions: int
    cache_hit_rate: float
    single_flight_hits: int
    approximate: int
    tree_requests: int
    tree_cache_hits: int
    p50_ms: float
    p95_ms: float
    mean_ms: float
    max_ms: float
    window_s: float
    throughput_rps: float
    queue_p50_ms: float = 0.0
    queue_p95_ms: float = 0.0
    queue_mean_ms: float = 0.0
    device_p50_ms: float = 0.0
    device_p95_ms: float = 0.0
    device_mean_ms: float = 0.0
    engine_swaps: int = 0
    hot_shapes: tuple = ()

    def summary(self) -> str:
        """Human-readable multi-line report (the CLI prints this)."""
        failed = f", {self.failures} failed" if self.failures else ""
        swaps = (f"\nengine swaps  {self.engine_swaps}"
                 if self.engine_swaps else "")
        return (
            f"requests      {self.requests}"
            f"  ({self.approximate} approximate under deadline{failed})\n"
            f"throughput    {self.throughput_rps:.1f} req/s"
            f" over {self.window_s:.2f}s\n"
            f"latency ms    p50={self.p50_ms:.1f} p95={self.p95_ms:.1f}"
            f" mean={self.mean_ms:.1f} max={self.max_ms:.1f}\n"
            f"  queue ms    p50={self.queue_p50_ms:.1f}"
            f" p95={self.queue_p95_ms:.1f} mean={self.queue_mean_ms:.1f}\n"
            f"  device ms   p50={self.device_p50_ms:.1f}"
            f" p95={self.device_p95_ms:.1f} mean={self.device_mean_ms:.1f}\n"
            f"batch-fill    {self.mean_batch_fill:.2f} mean over"
            f" {self.batch_dispatches} batch dispatches\n"
            f"deadline      {self.deadline_batched_requests} requests over"
            f" {self.deadline_dispatches} driver dispatches"
            f" (fill {self.mean_deadline_fill:.2f};"
            f" {self.deadline_driver_supersteps} driver vs"
            f" {self.deadline_lane_supersteps} lane supersteps)\n"
            f"cache         hits={self.cache_hits}"
            f" misses={self.cache_misses}"
            f" evictions={self.cache_evictions}"
            f" hit-rate={self.cache_hit_rate:.2f}"
            f" single-flight={self.single_flight_hits}\n"
            f"trees         {self.tree_requests} requests,"
            f" {self.tree_cache_hits} served from the tree cache"
            f"{swaps}"
        )


class StatsCollector:
    """Thread-safe recorder behind ``DKSService.stats()``.

    Requests resolve on two threads — cache hits on the client thread,
    everything else on the dispatcher thread — so every mutation takes the
    lock.  ``report()`` is a consistent snapshot.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lat_ms: deque[float] = deque(maxlen=LATENCY_WINDOW)
        self._queue_ms: deque[float] = deque(maxlen=LATENCY_WINDOW)
        self._device_ms: deque[float] = deque(maxlen=LATENCY_WINDOW)
        self._n_requests = 0
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._approximate = 0
        self._failures = 0
        self._batch_dispatches = 0
        self._deadline_dispatches = 0
        self._batched_requests = 0
        self._deadline_requests = 0
        self._deadline_driver_steps = 0
        self._deadline_lane_steps = 0
        self._single_flight = 0
        self._tree_requests = 0
        self._tree_cache_hits = 0
        self._engine_swaps = 0
        self._shape_counts: dict[tuple, int] = {}

    def record_request(self, t_submit: float, t_done: float,
                       approximate: bool = False,
                       queue_wait_ms: float | None = None,
                       device_ms: float | None = None) -> None:
        """One served request.  The stats window (t_first..t_last) is
        derived here, from served requests only — so a rejected submit
        never skews it and every snapshot is internally consistent.
        ``queue_wait_ms`` / ``device_ms`` feed the latency split windows
        (None for resolve paths where the phase does not exist — cache
        hits never queue, single-flight followers never dispatch)."""
        with self._lock:
            self._lat_ms.append((t_done - t_submit) * 1e3)
            if queue_wait_ms is not None:
                self._queue_ms.append(float(queue_wait_ms))
            if device_ms is not None:
                self._device_ms.append(float(device_ms))
            self._n_requests += 1
            if self._t_first is None or t_submit < self._t_first:
                self._t_first = t_submit
            if self._t_last is None or t_done > self._t_last:
                self._t_last = t_done
            if approximate:
                self._approximate += 1

    def record_failure(self, n_requests: int) -> None:
        with self._lock:
            self._failures += n_requests

    def record_single_flight(self) -> None:
        """One request served by attaching to an in-flight identical
        request (call alongside record_request for that request)."""
        with self._lock:
            self._single_flight += 1

    def record_tree_request(self, cache_hit: bool) -> None:
        """One ``return_trees`` request; ``cache_hit`` when it was served
        whole from the result + tree caches (no extraction)."""
        with self._lock:
            self._tree_requests += 1
            if cache_hit:
                self._tree_cache_hits += 1

    def record_dispatch(self, n_requests: int, deadline: bool,
                        driver_steps: int = 0, lane_steps: int = 0,
                        shape: tuple | None = None) -> None:
        """One device dispatch serving ``n_requests`` real lanes.  For
        deadline dispatches, ``driver_steps`` is what the shared driver
        stepped and ``lane_steps`` the sum of its lanes' own counters —
        the coalescing win is driver << lanes.  ``shape`` is the
        dispatched ``(m, k, lanes)`` bucket; the histogram is what an
        engine swap warms on the successor."""
        with self._lock:
            if deadline:
                self._deadline_dispatches += 1
                self._deadline_requests += n_requests
                self._deadline_driver_steps += driver_steps
                self._deadline_lane_steps += lane_steps
            else:
                self._batch_dispatches += 1
                self._batched_requests += n_requests
            if shape is not None:
                key = tuple(int(x) for x in shape)
                self._shape_counts[key] = self._shape_counts.get(key, 0) + 1

    def record_engine_swap(self) -> None:
        """One hot engine swap performed by ``set_engine``."""
        with self._lock:
            self._engine_swaps += 1

    def report(self, cache_stats: dict[str, int]) -> ServeStats:
        with self._lock:
            lat = np.asarray(self._lat_ms, np.float64)
            queue = np.asarray(self._queue_ms, np.float64)
            device = np.asarray(self._device_ms, np.float64)
            n = self._n_requests
            window = ((self._t_last - self._t_first)
                      if n and self._t_first is not None else 0.0)
            hits = cache_stats.get("hits", 0)
            misses = cache_stats.get("misses", 0)
            looked = hits + misses
            return ServeStats(
                requests=n,
                failures=self._failures,
                batch_dispatches=self._batch_dispatches,
                deadline_dispatches=self._deadline_dispatches,
                batched_requests=self._batched_requests,
                mean_batch_fill=(
                    self._batched_requests / self._batch_dispatches
                    if self._batch_dispatches else 0.0),
                deadline_batched_requests=self._deadline_requests,
                mean_deadline_fill=(
                    self._deadline_requests / self._deadline_dispatches
                    if self._deadline_dispatches else 0.0),
                deadline_driver_supersteps=self._deadline_driver_steps,
                deadline_lane_supersteps=self._deadline_lane_steps,
                cache_hits=hits,
                cache_misses=misses,
                cache_evictions=cache_stats.get("evictions", 0),
                cache_hit_rate=hits / looked if looked else 0.0,
                single_flight_hits=self._single_flight,
                approximate=self._approximate,
                tree_requests=self._tree_requests,
                tree_cache_hits=self._tree_cache_hits,
                p50_ms=_pct(lat, 50),
                p95_ms=_pct(lat, 95),
                mean_ms=float(lat.mean()) if lat.size else 0.0,
                max_ms=float(lat.max()) if lat.size else 0.0,
                window_s=window,
                throughput_rps=n / window if window > 0 else 0.0,
                queue_p50_ms=_pct(queue, 50),
                queue_p95_ms=_pct(queue, 95),
                queue_mean_ms=float(queue.mean()) if queue.size else 0.0,
                device_p50_ms=_pct(device, 50),
                device_p95_ms=_pct(device, 95),
                device_mean_ms=float(device.mean()) if device.size else 0.0,
                engine_swaps=self._engine_swaps,
                hot_shapes=tuple(sorted(self._shape_counts.items(),
                                        key=lambda kv: (-kv[1], kv[0]))),
            )
