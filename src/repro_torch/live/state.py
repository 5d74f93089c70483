"""LiveDir — the on-disk state of one continuously-growing graph.

A copy of ``repro.live.state``; ``CHAIN.json`` is the same file in both
packages.

A live directory holds a base :class:`~repro_torch.store.GraphArtifact`, the
stacked :class:`~repro_torch.store.DeltaArtifact` directories published on top
of it, and a small ``CHAIN.json`` recording the stacking order plus
which source fragments have already been consumed.  ``CHAIN.json`` is
rewritten atomically (tmp sibling + ``os.replace``, the same discipline
as artifact publication) so a reader — another process, or this one
after a crash — always sees a complete, consistent chain description::

    live/
      CHAIN.json        {"base": "base-000000",
                         "deltas": ["delta-000001", …],
                         "chain_hash": "…",
                         "consumed": ["edits-0042.nt", …]}
      base-000000/      graph artifact (entity-name table persisted)
      delta-000001/     delta stacking on base-000000's content hash
      delta-000002/     delta stacking on the chain above it

The chain hash in the file is advisory — :meth:`LiveDir.chain` reopens
and re-verifies the stack hash-by-hash through
:func:`repro_torch.store.open_chain` on every call, so a hand-edited
``CHAIN.json`` that mis-orders deltas fails loudly, naming both hashes.

:meth:`compact` folds the chain into a fresh ``base-NNNNNN`` artifact
(bit-identical to a union re-ingest, including ``content_hash``) and
resets the delta list; superseded directories are left in place for
in-flight readers and external cleanup.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Iterable

from repro_torch.store.artifact import (
    ArtifactError, GraphArtifact, open_artifact, write_artifact,
)
from repro_torch.store.delta import (
    DeltaArtifact, DeltaBuilder, GraphChain, compact_chain, open_chain,
)
from repro_torch.store.ingest import IngestResult

_STATE = "CHAIN.json"
_STATE_FORMAT = "repro-live-dir"
_STATE_VERSION = 1


class LiveDir:
    """One live graph's on-disk state: base + delta chain + bookkeeping.

    Construct with :meth:`initialize` (first publication from an
    :class:`~repro_torch.store.IngestResult`) or ``LiveDir(path)`` to reattach
    to an existing directory.
    """

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        spath = self.path / _STATE
        if not spath.is_file():
            raise ArtifactError(
                f"no live graph at {self.path} (missing {_STATE}) — "
                "create one with LiveDir.initialize(path, ingest_result)")
        try:
            state = json.loads(spath.read_text())
        except json.JSONDecodeError as exc:
            raise ArtifactError(
                f"unreadable {_STATE} in {self.path}: {exc}") from exc
        if state.get("format") != _STATE_FORMAT:
            raise ArtifactError(
                f"{spath} is not a {_STATE_FORMAT} state file "
                f"(format={state.get('format')!r})")
        if state.get("version") != _STATE_VERSION:
            raise ArtifactError(
                f"live-dir state v{state.get('version')} at {self.path}; "
                f"this reader supports v{_STATE_VERSION}")
        self._state = state
        # True while append/compact is between "directory being written"
        # and "state file updated" — the window where a new base/delta
        # directory exists on disk but CHAIN.json does not reference it
        # yet.  :meth:`gc` refuses to run during it (same process —
        # e.g. a GraphWatcher thread mid-publish on this instance).
        self._publishing = False

    # -- creation ------------------------------------------------------

    @classmethod
    def initialize(cls, path: str | Path, result: IngestResult, *,
                   overwrite: bool = False) -> "LiveDir":
        """Publish ``result`` as ``base-000000`` and write the initial
        state.  The ingest must carry the entity-name dictionary
        (reader-based ingests do; synthetic ``from_graph`` results
        don't and cannot grow by text fragments)."""
        if result.names is None:
            raise ArtifactError(
                "live graphs need the entity-name dictionary to stack "
                "deltas; this IngestResult has names=None (synthetic "
                "from_graph source?) — ingest a real N-Triples/TSV dump")
        path = Path(path)
        if (path / _STATE).exists() and not overwrite:
            raise ArtifactError(
                f"live graph already exists at {path} "
                "(pass overwrite=True)")
        path.mkdir(parents=True, exist_ok=True)
        base_name = "base-000000"
        art = write_artifact(
            path / base_name, result.graph, result.index, tau=result.tau,
            stats=result.stats.as_dict(), names=result.names,
            overwrite=overwrite)
        _write_state(path, {
            "format": _STATE_FORMAT, "version": _STATE_VERSION,
            "base": base_name, "base_seq": 0, "deltas": [],
            "chain_hash": art.content_hash, "consumed": [],
            "updated_unix": time.time(),
        })
        return cls(path)

    # -- chain access --------------------------------------------------

    @property
    def base_path(self) -> Path:
        return self.path / self._state["base"]

    @property
    def delta_paths(self) -> list[Path]:
        return [self.path / d for d in self._state["deltas"]]

    @property
    def depth(self) -> int:
        return len(self._state["deltas"])

    @property
    def chain_hash(self) -> str:
        """The recorded chain version (advisory; :meth:`chain`
        recomputes and re-verifies it)."""
        return self._state["chain_hash"]

    @property
    def consumed(self) -> set[str]:
        """Fragment file names already folded into a published delta."""
        return set(self._state["consumed"])

    def base(self) -> GraphArtifact:
        return open_artifact(self.base_path)

    def chain(self) -> GraphChain:
        """Open and hash-verify the current base + delta stack."""
        return open_chain(self.base_path, *self.delta_paths)

    # -- growth --------------------------------------------------------

    def append(self, fragments: Iterable[str | Path], *,
               fmt: str = "auto",
               on_error: str = "skip") -> DeltaArtifact | None:
        """Fold ``fragments`` into ONE new delta stacked on the current
        chain, publish it atomically, and mark the fragments consumed.

        Fragments that add nothing (all lines malformed/empty) still get
        marked consumed — returns ``None`` in that case instead of
        publishing an empty delta.
        """
        fragments = [Path(f) for f in fragments]
        builder = DeltaBuilder(self.chain())
        for frag in fragments:
            builder.add_file(frag, fmt=fmt, on_error=on_error)
        if builder.empty:
            self.mark_consumed(f.name for f in fragments)
            return None
        seq = self.depth + 1
        self._publishing = True
        try:
            delta = builder.write(self.path / f"delta-{seq:06d}")
            state = dict(self._state)
            state["deltas"] = state["deltas"] + [delta.path.name]
            state["chain_hash"] = delta.chain_hash
            state["consumed"] = sorted(
                self.consumed | {f.name for f in fragments})
            state["updated_unix"] = time.time()
            _write_state(self.path, state)
            self._state = state
        finally:
            self._publishing = False
        return delta

    def mark_consumed(self, names: Iterable[str]) -> None:
        state = dict(self._state)
        state["consumed"] = sorted(self.consumed | set(names))
        state["updated_unix"] = time.time()
        _write_state(self.path, state)
        self._state = state

    def compact(self) -> GraphArtifact:
        """Fold the current chain into a fresh base artifact and reset
        the delta list.  Old ``base-*``/``delta-*`` directories stay on
        disk (in-flight readers may hold them open); the state file
        stops referencing them."""
        chain = self.chain()
        seq = int(self._state.get("base_seq", 0)) + 1
        base_name = f"base-{seq:06d}"
        self._publishing = True
        try:
            art = compact_chain(chain, self.path / base_name)
            state = dict(self._state)
            state["base"] = base_name
            state["base_seq"] = seq
            state["deltas"] = []
            state["chain_hash"] = art.content_hash
            state["updated_unix"] = time.time()
            _write_state(self.path, state)
            self._state = state
        finally:
            self._publishing = False
        return art

    # -- cleanup -------------------------------------------------------

    def gc(self, keep_last: int = 1) -> list[str]:
        """Delete ``base-*``/``delta-*`` directories the state file no
        longer references (superseded by :meth:`compact`, or orphaned by
        a crashed publish).  Returns the deleted directory names,
        oldest-first.

        ``keep_last``: retain that many of the *newest* unreferenced
        directories as a grace window for in-flight readers that opened
        the previous chain just before a compact (0 = delete all).

        Refuses with :class:`RuntimeError` while a publish is mid-flight
        on this instance (e.g. a :class:`~repro_torch.live.GraphWatcher`
        thread inside :meth:`append`/:meth:`compact`): in that window a
        new directory exists on disk that ``CHAIN.json`` does not
        reference yet, and gc would delete it.
        """
        if keep_last < 0:
            raise ValueError("keep_last must be >= 0")
        if self._publishing:
            raise RuntimeError(
                f"refusing to gc {self.path}: a publish is in progress "
                "on this LiveDir (its new directory is not referenced "
                "by CHAIN.json yet) — retry after it completes")
        referenced = {self._state["base"], *self._state["deltas"]}
        stale = [p for p in self.path.iterdir()
                 if p.is_dir() and p.name not in referenced
                 and (p.name.startswith("base-")
                      or p.name.startswith("delta-"))]
        stale.sort(key=lambda p: (p.stat().st_mtime, p.name))
        if keep_last:
            stale = stale[:-keep_last] or []
        deleted = []
        for p in stale:
            shutil.rmtree(p)
            deleted.append(p.name)
        return deleted

    def __repr__(self) -> str:
        return (f"LiveDir({str(self.path)!r}, base={self._state['base']}, "
                f"depth={self.depth}, chain={self.chain_hash[:12]}…, "
                f"consumed={len(self._state['consumed'])})")


def _write_state(path: Path, state: dict) -> None:
    tmp = path / f"{_STATE}.tmp-{os.getpid()}"
    tmp.write_text(json.dumps(state, indent=1))
    os.replace(tmp, path / _STATE)
