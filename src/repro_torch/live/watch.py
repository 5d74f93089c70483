"""GraphWatcher — tail a fragment directory into published deltas.

A copy of ``repro.live.watch``.

The continuous-ingest loop: a producer drops N-Triples/TSV fragment
files (``.nt``/``.ntriples``/``.tsv``/``.txt``/``.edges``, optionally
``.gz``) into a watch directory; the watcher polls, batches every
not-yet-consumed fragment into ONE delta via :meth:`LiveDir.append`
(atomic publication, consumed-set bookkeeping), and invokes
``on_delta(live, delta)`` — typically
:meth:`repro_torch.live.EngineSwapper.on_delta`, which hot-swaps the serving
engine onto the grown chain.

Polling (not inotify) keeps the loop portable and dependency-free; the
consumed set in ``CHAIN.json`` makes it restart-safe — a watcher that
crashes after publishing but before deleting nothing (fragments are
never deleted) simply skips already-consumed names on the next scan.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Callable, Optional

from repro_torch.live.state import LiveDir
from repro_torch.store.delta import NT_SUFFIXES, TSV_SUFFIXES, DeltaArtifact

_FRAGMENT_SUFFIXES = NT_SUFFIXES + TSV_SUFFIXES


def _is_fragment(path: Path) -> bool:
    suffix = Path(path.stem).suffix if path.suffix == ".gz" else path.suffix
    return suffix in _FRAGMENT_SUFFIXES


class GraphWatcher:
    """Poll ``watch_dir`` for new fragments; publish each batch as one
    delta on ``live``.

    ``on_delta(live, delta)`` fires after every successful publication
    (not for no-op batches where every line was malformed).  Use
    :meth:`run_once` for deterministic/synchronous operation (tests, the
    ``--smoke`` legs) or :meth:`start`/:meth:`stop` for the background
    thread.  The first exception from the loop stops it and is kept in
    :attr:`error` — a serving process can surface it instead of silently
    serving a stale graph forever.
    """

    def __init__(self, live: LiveDir, watch_dir: str | Path, *,
                 poll_s: float = 0.25,
                 on_delta: Optional[
                     Callable[[LiveDir, DeltaArtifact], None]] = None,
                 fmt: str = "auto", on_error: str = "skip") -> None:
        self.live = live
        self.watch_dir = Path(watch_dir)
        self.poll_s = float(poll_s)
        self.on_delta = on_delta
        self.fmt = fmt
        self.on_error = on_error
        self.published = 0          # deltas published over this lifetime
        self.error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def pending(self) -> list[Path]:
        """Recognized fragments not yet consumed, oldest name first
        (producers name fragments monotonically; name order = arrival
        order)."""
        if not self.watch_dir.is_dir():
            return []
        consumed = self.live.consumed
        return sorted(
            (p for p in self.watch_dir.iterdir()
             if p.is_file() and _is_fragment(p) and p.name not in consumed),
            key=lambda p: p.name)

    def run_once(self) -> DeltaArtifact | None:
        """One poll cycle: batch every pending fragment into one delta,
        publish, notify.  Returns the delta (``None`` if nothing pended
        or the batch added nothing)."""
        frags = self.pending()
        if not frags:
            return None
        delta = self.live.append(frags, fmt=self.fmt,
                                 on_error=self.on_error)
        if delta is not None:
            self.published += 1
            if self.on_delta is not None:
                self.on_delta(self.live, delta)
        return delta

    # -- background thread ---------------------------------------------

    def start(self) -> "GraphWatcher":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("watcher already running")
        self._stop.clear()
        self.error = None
        self._thread = threading.Thread(
            target=self._loop, name="repro-graph-watcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self.error is not None:
            raise self.error

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except BaseException as exc:  # surface via stop(); don't spin
                self.error = exc
                return
            self._stop.wait(self.poll_s)
