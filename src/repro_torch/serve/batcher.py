"""Dynamic micro-batching: an admission queue that coalesces concurrent
requests into shape buckets and dispatches each bucket as one call.

Only queries with the same shape key — keyword count ``m``, answer count
``k``, and policy overrides — can share a vmapped device program (the DKS
table is ``[V, 2^m, K]``), so the batcher buckets by exactly that.  A
bucket dispatches when it reaches ``max_batch`` or when its oldest member
has waited ``max_wait_ms`` (the classic latency/throughput knob pair).

Everything executes inline on the single dispatcher thread: client threads
only ever touch the queue and their futures, so the device sees one caller and the
service needs no further locking around device work.  Deadline-bounded
requests coalesce too — into buckets keyed by shape *and* budget
(``deadline_ms``), so same-budget requests ride one lane driver and share
supersteps; their admission window is capped at a fraction of the budget
so queue wait cannot eat the budget it counts against.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Hashable


@dataclasses.dataclass
class Request:
    """One admitted query, waiting in the batcher.

    ``overrides`` is the per-call policy override dict as a sorted item
    tuple (hashable, order-free).  ``deadline_t`` is an absolute
    ``time.perf_counter()`` deadline — queue wait counts against it.
    ``engine`` is the engine build that admitted (and will serve) the
    request: snapshotting it here keeps a ``set_engine`` swap from
    changing the build mid-flight — admission-time validation and the
    version-carrying cache key stay consistent with execution.
    """

    keywords: tuple
    k: int
    overrides: tuple[tuple[str, Any], ...]
    future: Future
    t_submit: float
    engine: Any = None
    deadline_t: float | None = None
    deadline_ms: float | None = None
    cache_key: Hashable = None
    # The request's trace (repro_torch.obs.Trace) — admission begins it, the
    # resolve path finishes it.  Opaque to the batcher.
    trace: Any = None
    # Answer-tree serving (DKSService.submit(return_trees=True)).  These
    # shape only host-side rendering, never the device program, so they
    # are NOT part of shape_key — tree and non-tree requests co-batch.
    return_trees: bool = False
    tree_ranking: str = "diverse"      # "diverse" | "weight"
    tree_cursor: int = 0
    tree_page_size: int | None = None

    @property
    def shape_key(self) -> tuple:
        # The engine build is part of the shape: requests admitted under
        # different builds must never share a dispatch.  So is the build's
        # WEIGHT POLICY: two engines over the same artifact share a
        # version (the content hash) but may rank on different effective
        # weights — co-batching them would serve one policy's answers to
        # the other's requests.  The *budget* (deadline_ms, not the
        # absolute deadline) is part of it too: same-budget requests ride
        # one lane driver and stop together; deadline-less requests
        # (None) bucket separately.
        version = self.engine.version if self.engine is not None else None
        weights = (getattr(self.engine.policy, "weights", None)
                   if self.engine is not None else None)
        return (len(self.keywords), self.k, self.overrides, version,
                weights, self.deadline_ms)


_STOP = object()


class MicroBatcher:
    """Admission queue + dispatcher thread.

    ``dispatch`` is called on the dispatcher thread with a non-empty list
    of same-shape (and, for deadline requests, same-budget) requests and
    must resolve every request's future — including on error.
    :class:`DKSService` provides it; the batcher owns only admission,
    grouping, and timing.
    """

    def __init__(self, dispatch: Callable[[list[Request]], None], *,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 max_batch_for: Callable[[], int] | None = None) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        # Optional dynamic fill target (adaptive lane policy): consulted
        # per drain cycle, clamped to [1, max_batch].  A bucket that
        # reaches the target dispatches immediately — the policy's
        # "bucket size worth waiting for" — while the window expiry
        # still bounds the wait for partial buckets.  None = fixed
        # max_batch, the classic behavior.
        self._max_batch_for = max_batch_for
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._queue: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._stopping = False
        # Why each bucket dispatched: "full" (hit max_batch), "window"
        # (oldest member's admission window expired), "flush" (service
        # stopping).  Counters are monotone; ``current_reason`` is valid
        # inside a dispatch call (same thread, set right before it) and
        # lets the service stamp the reason on the bucket's trace span.
        self.dispatch_counts = {"full": 0, "window": 0, "flush": 0}
        self.current_reason: str | None = None
        # Makes submit's running-check + enqueue atomic against stop():
        # any request admitted under the lock is enqueued before _STOP,
        # so the dispatcher always sees (and flushes) it before exiting.
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("batcher already started")
            # Drain anything stale from a prior generation (a _STOP left
            # by a stop() whose dispatcher had already died would make
            # the new dispatcher exit on arrival, wedging every future).
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, Request) and not item.future.done():
                    item.future.set_exception(
                        RuntimeError("service restarted before dispatch"))
            self._stopping = False
            self._thread = threading.Thread(
                target=self._loop, name="dks-serve-dispatcher", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop accepting requests, flush pending buckets, join.

        Safe under concurrent calls: the first caller claims the thread
        (and enqueues exactly one _STOP); later callers return at once.
        """
        with self._lock:
            thread = self._thread
            if thread is None:
                return
            self._thread = None
            self._stopping = True
            self._queue.put(_STOP)
        thread.join()

    @property
    def running(self) -> bool:
        return self._thread is not None

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def submit(self, request: Request) -> None:
        with self._lock:
            if self._stopping or self._thread is None:
                raise RuntimeError("service is not running")
            self._queue.put(request)

    # ------------------------------------------------------------------
    # Dispatcher thread
    # ------------------------------------------------------------------

    def _loop(self) -> None:
        pending: dict[tuple, list[Request]] = {}
        try:
            self._loop_body(pending)
        except BaseException as exc:  # noqa: BLE001 — dispatcher last resort
            # A bookkeeping failure outside _safe_dispatch must not wedge
            # the service with unresolvable futures: fail everything
            # pending and queued, and refuse new submits.
            with self._lock:
                self._stopping = True
            for group in pending.values():
                for req in group:
                    if not req.future.done():
                        req.future.set_exception(exc)
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, Request) and not item.future.done():
                    item.future.set_exception(exc)

    def _loop_body(self, pending: dict[tuple, list[Request]]) -> None:
        stopping = False
        while True:
            timeout = self._next_timeout(pending)
            try:
                item = self._queue.get(
                    timeout=timeout) if timeout != 0 else None
            except queue.Empty:
                item = None
            drained = [] if item is None else [item]
            while True:
                try:
                    drained.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            for req in drained:
                if req is _STOP:
                    stopping = True
                else:
                    pending.setdefault(req.shape_key, []).append(req)
            now = time.perf_counter()
            fill = self.max_batch
            if self._max_batch_for is not None:
                try:
                    fill = max(1, min(int(self._max_batch_for()),
                                      self.max_batch))
                except Exception:  # noqa: BLE001 — policy must not wedge
                    fill = self.max_batch
            for key in list(pending):
                group = pending[key]
                while len(group) >= fill:
                    self._safe_dispatch(group[:fill], "full")
                    del group[:fill]
                if group and (stopping or
                              now - group[0].t_submit
                              >= self._window_s(group[0])):
                    self._safe_dispatch(
                        group, "flush" if stopping else "window")
                    group = []
                if group:
                    pending[key] = group
                else:
                    del pending[key]
            if stopping and not pending:
                return

    def _window_s(self, req: Request) -> float:
        """Admission window for a request's bucket.  Deadline buckets cap
        it at a fraction of the budget — the wait counts against the very
        deadline it is coalescing for, so a bucket must dispatch with
        most of its budget intact even when ``max_wait_ms`` is larger.
        A 1 ms floor keeps near-zero budgets coalescing: such a request
        expires either way, and concurrent identical-budget requests
        submitted back-to-back must not race the dispatcher into
        singleton buckets."""
        if req.deadline_ms is None:
            return self.max_wait_s
        return min(self.max_wait_s,
                   max(1e-3, 0.2 * req.deadline_ms / 1e3))

    def _next_timeout(self, pending: dict[tuple, list[Request]]):
        """Block forever when idle; otherwise wake for the nearest bucket
        window expiry (0 = poll without blocking)."""
        if not pending:
            return None
        now = time.perf_counter()
        nearest = min(group[0].t_submit + self._window_s(group[0])
                      for group in pending.values())
        remaining = nearest - now
        return max(remaining, 0.0) if remaining > 1e-4 else 0

    def _safe_dispatch(self, group: list[Request],
                       reason: str = "window") -> None:
        self.dispatch_counts[reason] += 1
        self.current_reason = reason
        try:
            self._dispatch(group)
        except BaseException as exc:  # noqa: BLE001 — must resolve futures
            for req in group:
                if not req.future.done():
                    req.future.set_exception(exc)
        finally:
            self.current_reason = None
