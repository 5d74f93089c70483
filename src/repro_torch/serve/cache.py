"""LRU result cache for served queries.

Keys come from :meth:`repro_torch.engine.QueryEngine.cache_token` — the
normalized keyword multiset plus ``(k, effective policy, engine build
version)`` — so permuted queries hit the same entry, any policy override
misses, and results computed against a previous graph build can never be
served (a rebuilt engine carries a fresh version).  Values are the full
:class:`~repro_torch.engine.QueryResult` (answers are host objects; ``state`` is
dropped by default at query time, so entries don't pin device memory).

Only *exact* results belong here: a deadline-terminated best-so-far answer
is a property of that request's budget, not of the query, and
:class:`~repro_torch.serve.service.DKSService` never inserts one.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable


class ResultCache:
    """Thread-safe LRU with hit/miss/eviction counters.

    ``capacity <= 0`` disables the cache entirely: gets return None without
    counting, puts are dropped — so a cache-less service reports a 0/0
    counter line instead of a fake 100% miss rate.
    """

    def __init__(self, capacity: int) -> None:
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: Hashable, *, count_miss: bool = True) -> Any | None:
        """Lookup; hits always count.  ``count_miss=False`` defers the
        miss counter to an explicit :meth:`count_miss` — for callers that
        only know after admission whether the miss will actually be
        served (a rejected request must not skew the miss rate)."""
        if not self.enabled:
            return None
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._hits += 1
                return self._entries[key]
            if count_miss:
                self._misses += 1
            return None

    def count_miss(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._misses += 1

    def put(self, key: Hashable, value: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1

    def invalidate(self) -> int:
        """Drop every entry (graph rebuild, explicit flush).  Returns how
        many entries were dropped; they are not counted as evictions."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            return n

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "size": len(self._entries),
                "capacity": self.capacity,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
            }
