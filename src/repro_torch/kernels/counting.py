"""Kernel launch counts that stay exact when several threads launch.

A live graph's hot swap runs the successor's warm on the watcher's thread
while the service's dispatcher launches on the outgoing engine, so two
threads move one kernel's count at once; a bare module-level ``+= 1``
can lose updates between them.  :class:`LaunchCounter` keeps one tally
per launching thread, under a lock, and sums them on read — which also
splits a count by thread (``by_thread``): the warm's launches apart from
the service's.
"""

from __future__ import annotations

import threading


class LaunchCounter:
    """Launches of one kernel: one tally per launching thread (by thread
    name), added under a lock and summed on read."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tallies: dict[str, int] = {}

    def add(self) -> None:
        """Count one launch on the calling thread."""
        name = threading.current_thread().name
        with self._lock:
            self._tallies[name] = self._tallies.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._tallies.clear()

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._tallies.values())

    def by_thread(self) -> dict[str, int]:
        """``{thread name: launches}`` since the last :meth:`reset`."""
        with self._lock:
            return dict(self._tallies)
