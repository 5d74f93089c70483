"""Process-wide metrics registry with Prometheus text exposition.

Three instrument kinds, all stdlib, all thread-safe:

- :class:`Counter` — monotone float (``inc`` rejects negatives).
- :class:`Gauge` — settable float (last write wins).
- :class:`Histogram` — fixed buckets chosen at construction; observe is
  one bisect + two adds, cheap enough for per-request latencies.

A :class:`MetricsRegistry` renders everything as Prometheus text
exposition format 0.0.4 (the format every scraper parses).  Two ways to
get numbers in:

1. Direct instruments (``registry.counter(...)``/``.inc()``) for events
   that exist only in flight — dispatch reasons, latency samples.
2. ``register_collector(fn)`` for state that already lives somewhere
   authoritative: ``fn()`` returns ``{metric_name: value}`` and runs at
   scrape time.  The serve layer exports ``ServeStats`` counters this
   way, so ``/metrics`` equals ``svc.stats()`` *by construction* —
   there is no second bookkeeping path that could drift.

:func:`parse_prometheus` is the inverse (samples only, for tests and
the smoke scrape): no dependency on a prometheus client library.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name: {name!r}")
    return name


def _fmt(v: float) -> str:
    """Prometheus value formatting: integers without a trailing .0."""
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotone counter; ``inc(v)`` with v < 0 raises."""

    kind = "counter"

    def __init__(self, name: str, help_text: str) -> None:
        self.name = _check_name(name)
        self.help = help_text
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> list[tuple[str, float]]:
        return [(self.name, self.value)]


class Gauge:
    """Point-in-time value; ``set`` overwrites, ``inc``/``dec`` adjust."""

    kind = "gauge"

    def __init__(self, name: str, help_text: str) -> None:
        self.name = _check_name(name)
        self.help = help_text
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> list[tuple[str, float]]:
        return [(self.name, self.value)]


# Default buckets suit serve-path latencies: sub-ms cache hits through
# multi-second cold compiles.
DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0)


class Histogram:
    """Fixed-bucket histogram with cumulative Prometheus exposition."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS_MS) -> None:
        self.name = _check_name(name)
        self.help = help_text
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("buckets must be sorted and non-empty")
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def samples(self) -> list[tuple[str, float]]:
        with self._lock:
            counts, total, n = list(self._counts), self._sum, self._n
        out: list[tuple[str, float]] = []
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append((f'{self.name}_bucket{{le="{_fmt(b)}"}}',
                        float(cum)))
        out.append((f'{self.name}_bucket{{le="+Inf"}}', float(n)))
        out.append((f"{self.name}_sum", total))
        out.append((f"{self.name}_count", float(n)))
        return out


class MetricsRegistry:
    """Named instruments + scrape-time collectors (module docstring)."""

    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._collectors: list = []
        self._lock = threading.Lock()

    def _register(self, metric):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name!r} re-registered as a "
                        f"different kind")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(Gauge(name, help_text))

    def histogram(self, name: str, help_text: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS_MS,
                  ) -> Histogram:
        return self._register(Histogram(name, help_text, buckets))

    def register_collector(self, fn, kinds: dict[str, str] | None = None,
                           helps: dict[str, str] | None = None) -> None:
        """``fn() -> {name: value}`` evaluated at every scrape.  ``kinds``
        maps names to "counter"/"gauge" for TYPE lines (default gauge)."""
        with self._lock:
            self._collectors.append((fn, kinds or {}, helps or {}))

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def sample(self) -> dict[str, float]:
        """Flat {sample_name: value} snapshot (instruments + collectors)."""
        out: dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for m in metrics:
            out.update(m.samples())
        for fn, _, _ in collectors:
            for name, v in fn().items():
                out[_check_name(name)] = float(v)
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
            collectors = list(self._collectors)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, v in m.samples():
                lines.append(f"{name} {_fmt(v)}")
        for fn, kinds, helps in collectors:
            for name, v in sorted(fn().items()):
                _check_name(name)
                if name in helps:
                    lines.append(f"# HELP {name} {helps[name]}")
                lines.append(f"# TYPE {name} {kinds.get(name, 'gauge')}")
                lines.append(f"{name} {_fmt(float(v))}")
        return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, float]:
    """Parse exposition text back into {sample_name: value}.

    Strict about what it accepts (malformed lines raise), so the serve
    smoke's "the endpoint parses" assertion means something.
    """
    out: dict[str, float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        # Labels may contain spaces; split on the last space.
        name, _, value = line.rpartition(" ")
        if not name:
            raise ValueError(f"malformed sample line: {raw!r}")
        bare = name.split("{", 1)[0]
        _check_name(bare)
        out[name] = float(value.replace("+Inf", "inf"))
    return out


_default_registry: MetricsRegistry | None = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry
