"""Load generation: synthetic request traces + concurrent replay clients.

``make_trace`` builds a replay trace the way the paper builds query
workloads (Sec. 7.1: keywords sampled across the document-frequency
spectrum), then draws requests from that pool with a skewed (1/rank)
popularity — real query streams repeat, which is what gives a warm result
cache its hits.

``replay`` drives a :class:`~repro_torch.serve.service.DKSService` with N
closed-loop clients (each submits, waits, submits the next), the standard
serving-benchmark shape: concurrency creates admission pressure, so the
micro-batcher has something to coalesce.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.serve.service import DKSService, ServedResult


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One replayable request: keywords + answer count + optional budget."""

    keywords: tuple
    k: int = 1
    deadline_ms: float | None = None


def make_trace(index, n_requests: int = 48, *, unique: int = 8,
               m_choices: tuple = (2, 3), k: int = 1,
               deadline_frac: float = 0.0, deadline_ms: float = 75.0,
               deadline_burst: int = 4,
               seed: int = 0) -> list[TraceRequest]:
    """Synthetic request trace over an :class:`InvertedIndex`'s vocabulary.

    ``unique`` distinct queries are built first (keyword counts cycling
    through ``m_choices``, tokens picked from spread-out windows of the
    df-sorted vocabulary so keyword-node counts span the Fig. 9 range),
    then ``n_requests`` draws follow a 1/rank popularity — the head query
    repeats often enough that a warm cache sees hits.

    A ``deadline_frac`` fraction of requests carries a ``deadline_ms``
    budget, placed as **bursts** of up to ``deadline_burst`` consecutive
    requests sharing one keyword count ``m`` (real SLO traffic arrives
    in same-budget waves, not evenly interleaved): concurrent replay
    clients then land same-shape same-budget requests in one admission
    window, which is what exercises the service's coalesced deadline
    buckets — N lanes riding one stepwise driver.  Deterministic per
    ``seed``.
    """
    pairs = sorted(index.token_dfs(), key=lambda p: p[1])
    usable = [t for t, d in pairs if d >= 2]
    if len(usable) < max(m_choices) * 2:
        raise ValueError("vocabulary too small for a trace")
    rng = np.random.default_rng(seed)
    pool: list[tuple] = []
    for i in range(unique):
        m = m_choices[i % len(m_choices)]
        lo = int((len(usable) - m) * i / max(unique, 1))
        hi = min(len(usable) - 1, lo + max(2 * m, 10))
        picks = rng.choice(np.arange(lo, hi + 1), size=m, replace=False)
        pool.append(tuple(usable[int(p)] for p in picks))
    ranks = np.arange(len(pool))
    popularity = 1.0 / (ranks + 1.0)
    popularity /= popularity.sum()
    trace = []
    for j in range(n_requests):
        q = pool[int(rng.choice(len(pool), p=popularity))]
        trace.append(TraceRequest(keywords=q, k=k, deadline_ms=None))
    if deadline_frac > 0:
        pool_by_m: dict[int, list[tuple]] = {}
        for q in pool:
            pool_by_m.setdefault(len(q), []).append(q)
        n_dl = max(1, min(n_requests, int(round(deadline_frac
                                                * n_requests))))
        burst = max(1, min(deadline_burst, n_dl))
        n_bursts = max(1, -(-n_dl // burst))
        taken: set[int] = set()
        placed = 0
        for b in range(n_bursts):
            start = int(b * n_requests / n_bursts)
            same_m = pool_by_m[len(trace[start].keywords)]
            in_burst = 0
            p = start
            # Skip slots an earlier (overlapping) burst already claimed,
            # so the trace carries exactly n_dl deadline requests.
            while placed < n_dl and in_burst < burst and p < n_requests:
                if p not in taken:
                    q = same_m[int(rng.choice(len(same_m)))]
                    trace[p] = TraceRequest(keywords=q, k=k,
                                            deadline_ms=deadline_ms)
                    taken.add(p)
                    placed += 1
                    in_burst += 1
                p += 1
    return trace


def latency_split(results: list[ServedResult]) -> dict[str, float]:
    """Aggregate the end-to-end / queue-wait / device-time latency split
    over served results (milliseconds; p50/p95/mean per phase).

    Results missing a phase are excluded from that phase's window —
    cache hits and single-flight followers never queue or dispatch, so
    ``n_queue``/``n_device`` say how many results each split covers.
    Zeros (not NaN) when a window is empty, matching ``ServeStats``.
    """
    def summarize(values: list[float], tag: str) -> dict[str, float]:
        arr = np.asarray(values, np.float64)
        if not arr.size:
            return {f"{tag}_p50_ms": 0.0, f"{tag}_p95_ms": 0.0,
                    f"{tag}_mean_ms": 0.0}
        return {f"{tag}_p50_ms": float(np.percentile(arr, 50)),
                f"{tag}_p95_ms": float(np.percentile(arr, 95)),
                f"{tag}_mean_ms": float(arr.mean())}

    served = [r for r in results if r is not None]
    queue = [r.queue_wait_ms for r in served if r.queue_wait_ms is not None]
    device = [r.device_ms for r in served if r.device_ms is not None]
    out = {"n": len(served), "n_queue": len(queue),
           "n_device": len(device)}
    out.update(summarize([r.latency_ms for r in served], "latency"))
    out.update(summarize(queue, "queue"))
    out.update(summarize(device, "device"))
    return out


def replay(service: DKSService, trace: list[TraceRequest], *,
           n_clients: int = 8,
           timeout: float | None = None) -> list[ServedResult]:
    """Replay ``trace`` through ``service`` with ``n_clients`` concurrent
    closed-loop clients.  Returns results in trace order; the first client
    error (if any) is re-raised after all clients stop.  ``timeout``: the
    most seconds each request's future is waited for (None: no limit)."""
    results: list[ServedResult | None] = [None] * len(trace)
    errors: list[BaseException] = []
    cursor = [0]
    lock = threading.Lock()
    n_clients = max(1, min(n_clients, len(trace)))
    barrier = threading.Barrier(n_clients)

    def client() -> None:
        barrier.wait()
        while True:
            with lock:
                i = cursor[0]
                cursor[0] += 1
            if i >= len(trace) or errors:
                return
            req = trace[i]
            try:
                results[i] = service.query(
                    list(req.keywords), k=req.k,
                    deadline_ms=req.deadline_ms, timeout=timeout)
            except BaseException as exc:  # noqa: BLE001 — reported below
                errors.append(exc)
                return

    threads = [threading.Thread(target=client, name=f"dks-client-{c}")
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results  # type: ignore[return-value]
