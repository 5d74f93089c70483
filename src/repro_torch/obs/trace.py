"""Request tracing: per-request span trees on monotonic clocks.

The serving layer answers a request through half a dozen mechanisms —
admission checks, the micro-batcher's window, bucket coalescing, a
compile-or-warm device dispatch, extraction, rendering, caches — and an
aggregate percentile cannot say which one a slow request paid for.  A
:class:`Trace` is one request's answer to that question: a bounded tree
of :class:`Span`\\ s, each a named ``[t_start, t_end)`` interval on
``time.perf_counter()`` with a small attribute dict.

Design constraints (this sits on the serving hot path):

- **monotonic clocks only** — spans are perf_counter intervals; wall
  time appears once per trace (``t_unix``) for log correlation.
- **bounded memory** — finished traces land in a ring buffer of
  ``capacity`` entries; an unsampled trace records no spans at all (its
  id still exists, so every served result can carry one).
- **deterministic sampling** — the keep/drop decision hashes
  ``(seed, trace_id)``, so a given seed samples the same ids on every
  run (tests and incident replays see the same traces).
- **exactly one trace per admitted request** — ``begin()`` counts
  births, ``finish()`` is idempotent and counts completions; the ring
  plus the counters make "every admitted request resolves to exactly
  one trace" a checkable invariant.

Traces from requests that ride another request's work (micro-batch
followers, single-flight attachees) carry a ``coalesced_into`` link to
the leader's trace id instead of duplicating its spans.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import zlib
from collections import deque


class Span:
    """One named interval inside a trace (see module docstring)."""

    __slots__ = ("span_id", "parent_id", "name", "t_start", "t_end",
                 "attrs")

    def __init__(self, span_id: int, parent_id: int | None, name: str,
                 t_start: float, t_end: float | None = None,
                 attrs: dict | None = None) -> None:
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = t_start
        self.t_end = t_end
        self.attrs = attrs or {}

    @property
    def duration_ms(self) -> float:
        if self.t_end is None:
            return 0.0
        return (self.t_end - self.t_start) * 1e3


class _SpanHandle:
    """Context manager returned by :meth:`Trace.span`; closes its span
    (and pops it off the current thread's nesting stack) on exit."""

    __slots__ = ("_trace", "_span")

    def __init__(self, trace: "Trace", span: Span | None) -> None:
        self._trace = trace
        self._span = span

    def set(self, **attrs) -> "_SpanHandle":
        if self._span is not None:
            self._span.attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._span is None:
            return
        if exc is not None:
            self._span.attrs.setdefault("error", repr(exc))
        self._trace._close(self._span)


class Trace:
    """One request's span tree.  Thread-compatible: spans may be opened
    from different threads (admission on a client thread, dispatch on
    the dispatcher thread); nesting is tracked per thread, so a span
    opened inside another span *on the same thread* becomes its child.
    """

    __slots__ = ("trace_id", "name", "sampled", "t_start", "t_unix",
                 "t_end", "attrs", "links", "spans", "_tracer", "_lock",
                 "_tls", "_ids", "_finished")

    def __init__(self, tracer: "Tracer", trace_id: int, name: str,
                 sampled: bool, attrs: dict) -> None:
        self.trace_id = trace_id
        self.name = name
        self.sampled = sampled
        self.t_start = time.perf_counter()
        self.t_unix = time.time()
        self.t_end: float | None = None
        self.attrs = attrs
        self.links: dict[str, int] = {}
        self.spans: list[Span] = []
        self._tracer = tracer
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._finished = False

    # -- span recording --------------------------------------------------

    def span(self, name: str, **attrs) -> _SpanHandle:
        """Open a child span (context manager).  No-op when unsampled."""
        if not self.sampled:
            return _SpanHandle(self, None)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        parent = stack[-1] if stack else None
        sp = Span(next(self._ids), parent, name, time.perf_counter(),
                  attrs=attrs)
        stack.append(sp.span_id)
        return _SpanHandle(self, sp)

    def _close(self, sp: Span) -> None:
        sp.t_end = time.perf_counter()
        stack = getattr(self._tls, "stack", None)
        if stack and stack[-1] == sp.span_id:
            stack.pop()
        with self._lock:
            self.spans.append(sp)

    def add_span(self, name: str, t_start: float, t_end: float,
                 **attrs) -> None:
        """Record an already-elapsed interval retroactively (e.g. queue
        wait, measured only when the dispatcher finally picks the
        request up).  Parents under the current thread's open span."""
        if not self.sampled:
            return
        stack = getattr(self._tls, "stack", None)
        parent = stack[-1] if stack else None
        sp = Span(next(self._ids), parent, name, t_start, t_end, attrs)
        with self._lock:
            self.spans.append(sp)

    def set(self, **attrs) -> None:
        """Merge trace-level attributes (recorded even when unsampled —
        they are O(1) and finish() reports them to the log)."""
        self.attrs.update(attrs)

    def link(self, **links) -> None:
        """Cross-trace links, e.g. ``coalesced_into=<leader trace id>``."""
        self.links.update({k: int(v) for k, v in links.items()})

    def finish(self) -> None:
        """Close the trace and hand it to the tracer's ring (idempotent:
        later calls are no-ops, so every resolve path may call it)."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self.t_end = time.perf_counter()
        self._tracer._push(self)

    # -- export -----------------------------------------------------------

    @property
    def duration_ms(self) -> float:
        end = self.t_end if self.t_end is not None else time.perf_counter()
        return (end - self.t_start) * 1e3

    def to_dict(self) -> dict:
        """JSON-ready form; span times become offsets from trace start."""
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "t_unix": self.t_unix,
            "duration_ms": round(self.duration_ms, 3),
            "sampled": self.sampled,
            "attrs": self.attrs,
            "links": self.links,
            "spans": [
                {
                    "span_id": sp.span_id,
                    "parent_id": sp.parent_id,
                    "name": sp.name,
                    "offset_ms": round((sp.t_start - self.t_start) * 1e3, 3),
                    "duration_ms": round(sp.duration_ms, 3),
                    "attrs": sp.attrs,
                }
                for sp in sorted(self.spans, key=lambda s: s.t_start)
            ],
        }


class Tracer:
    """Trace factory + bounded ring of finished traces.

    ``sample``: fraction of traces that record spans (the decision is a
    deterministic hash of ``(seed, trace_id)`` — see module docstring).
    ``log_path``: append each finished *sampled* trace as one JSON line
    (the structured event log ``serve_dks --trace-sample`` exposes).
    """

    def __init__(self, capacity: int = 256, sample: float = 1.0,
                 seed: int = 0, log_path: str | None = None) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not 0.0 <= sample <= 1.0:
            raise ValueError("sample must be in [0, 1]")
        self.capacity = int(capacity)
        self.sample = float(sample)
        self.seed = int(seed)
        self.log_path = log_path
        self._ring: deque[Trace] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._begun = 0
        self._finished = 0
        self._sampled = 0

    def _sample_decision(self, trace_id: int) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = zlib.crc32(f"{self.seed}:{trace_id}".encode()) & 0xFFFFFFFF
        return h / 0x100000000 < self.sample

    def begin(self, name: str, **attrs) -> Trace:
        trace_id = next(self._ids)
        with self._lock:
            self._begun += 1
        return Trace(self, trace_id, name,
                     self._sample_decision(trace_id), attrs)

    def _push(self, trace: Trace) -> None:
        line = None
        with self._lock:
            self._finished += 1
            if trace.sampled:
                self._sampled += 1
                self._ring.append(trace)
                if self.log_path is not None:
                    line = json.dumps(trace.to_dict(),
                                      separators=(",", ":"))
        if line is not None:
            # Outside the lock: one appending write per finished trace.
            with open(self.log_path, "a", encoding="utf-8") as f:
                f.write(line + "\n")

    # -- introspection ----------------------------------------------------

    def recent(self, n: int | None = None) -> list[Trace]:
        """Most recent finished sampled traces, newest last."""
        with self._lock:
            traces = list(self._ring)
        return traces if n is None else traces[-int(n):]

    def get(self, trace_id: int) -> Trace | None:
        with self._lock:
            for tr in reversed(self._ring):
                if tr.trace_id == trace_id:
                    return tr
        return None

    def to_jsonl(self, n: int | None = None) -> str:
        return "\n".join(json.dumps(tr.to_dict(), separators=(",", ":"))
                         for tr in self.recent(n))

    def stats(self) -> dict[str, int]:
        """{begun, finished, sampled, buffered} — ``begun == finished``
        once the service drains is the trace-completeness invariant."""
        with self._lock:
            return {"begun": self._begun, "finished": self._finished,
                    "sampled": self._sampled, "buffered": len(self._ring)}


def render_span_tree(trace: Trace) -> str:
    """Human-readable span tree with durations (``dks_query --explain``).

    ::

        trace 7 dks.request 58.1 ms  (m=2 k=1)
          admit 0.4 ms  (outcome=queued)
            cache_lookup 0.1 ms  (hit=False)
          queue_wait 5.2 ms
          ...
    """
    def fmt_attrs(attrs: dict) -> str:
        if not attrs:
            return ""
        inner = " ".join(f"{k}={v}" for k, v in attrs.items())
        return f"  ({inner})"

    lines = [f"trace {trace.trace_id} {trace.name} "
             f"{trace.duration_ms:.1f} ms{fmt_attrs(trace.attrs)}"]
    for k, v in trace.links.items():
        lines.append(f"  ~ {k} -> trace {v}")
    spans = sorted(trace.spans, key=lambda s: s.t_start)
    children: dict[int | None, list[Span]] = {}
    for sp in spans:
        children.setdefault(sp.parent_id, []).append(sp)

    def walk(parent: int | None, depth: int) -> None:
        for sp in children.get(parent, ()):  # already time-ordered
            lines.append(f"{'  ' * (depth + 1)}{sp.name} "
                         f"{sp.duration_ms:.1f} ms{fmt_attrs(sp.attrs)}")
            walk(sp.span_id, depth + 1)

    walk(None, 0)
    if not trace.sampled:
        lines.append("  (unsampled: no spans recorded)")
    return "\n".join(lines)
