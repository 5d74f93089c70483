"""Versioned on-disk graph artifacts: write once, mmap-open in milliseconds.

A copy of ``repro.store.artifact``.  The on-disk format is the interchange
between the two packages and stays byte-identical: the same buffer names,
dtypes and manifest JSON, the same format versions and the same sha256
``content_hash``, so an artifact written by either package opens in the
other under the same hash.

A :class:`GraphArtifact` is a directory of raw ``.npy`` buffers plus a
``manifest.json``:

    artifact/
      manifest.json            magic, format version, counts, tau,
                               per-buffer {dtype, shape, sha256},
                               ingest stats, content_hash
      src.npy dst.npy w.npy    directed raw edges (int32/int32/float32)
      indptr.npy indices.npy   symmetrized CSR (int64 / int32 / float32)
      ew.npy
      sym_src.npy sym_dst.npy  dst-sorted symmetric edge list — the exact
      sym_w.npy                DeviceGraph layout, so loading skips the sort
      pred.npy conf.npy        typed channel (format v2, typed graphs only):
      csr_pred.npy             per-edge predicate id + confidence for the
      csr_conf.npy             directed, CSR, and dst-sorted symmetric
      sym_pred.npy             layouts; the predicate dictionary itself
      sym_conf.npy             lives in the manifest (``predicates``)
      post_offsets.npy         InvertedIndex frozen postings (int64[T+1] /
      post_nodes.npy           int32[sum df]) + the vocabulary keys
      token_keys.npy           (int tokens)  — or token_offsets.npy +
                               token_bytes.npy (utf-8 str tokens)
      label_offsets.npy        optional node label text (utf-8 blob +
      label_bytes.npy          int64[V+1] offsets)
      ent_offsets.npy          optional entity-name table (same layout):
      ent_bytes.npy            the ingest dictionary keys in id order —
                               the substrate delta artifacts stack on

Buffers are opened with ``np.load(mmap_mode="r")`` — nothing is read until
touched, so opening a multi-GB artifact costs a manifest parse, not a
graph rebuild.  The vocabulary is persisted as a *sorted* token table
(:meth:`InvertedIndex.to_postings` emits it sorted), so the loaded index
(:class:`LazyArtifactIndex`) resolves tokens by binary search over the
mmapped table — O(log T) touched pages per lookup, and **O(1) in
vocabulary size at open time**: no token dict is ever materialized unless
a caller enumerates ``vocabulary()``.  Writes are atomic: everything
lands in a ``<path>.tmp-<pid>`` sibling first and is renamed into place,
so a crashed ingest can never leave a half-written artifact at the
target path.

Validation is layered: :func:`open_artifact` always checks the magic and
format version (``FormatVersionError`` on mismatch) and that every buffer's
on-disk dtype/shape matches its manifest entry (``ArtifactError``);
``verify="full"`` additionally re-hashes every buffer file against the
recorded sha256 (``ChecksumError`` — use for freshly copied artifacts).
``content_hash`` — a sha256 over the manifest's scalar metadata and buffer
hashes — identifies the graph *content*: engines built from an artifact
fold it into ``QueryEngine.version`` / ``cache_token``, so a result cache
can never serve answers computed against a different graph build.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch.graph.index import InvertedIndex
from repro_torch.graph.structure import Graph

MAGIC = "repro-graph-artifact"
# Magic of a *delta* artifact (repro_torch.store.delta) — named here so the base
# reader can say "that's a delta, open the chain" instead of a generic
# magic mismatch when the two get confused for each other.
DELTA_MAGIC = "repro-graph-delta"
# v1: untyped single-weight artifacts.  v2 adds the optional typed channel
# (pred/conf buffers + manifest "predicates") — pure superset: a v2
# artifact of an untyped graph differs from v1 only in the version field,
# and this reader opens both (v1 artifacts keep serving bit-identical
# results under the default WeightPolicy).  The optional entity-name table
# (``ent_offsets``/``ent_bytes``, the live-graph delta substrate) is a
# further pure superset within v2: readers load only the buffers the
# manifest lists, so artifacts without it open unchanged.
FORMAT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)
_MANIFEST = "manifest.json"


class ArtifactError(RuntimeError):
    """Malformed, incomplete, or mismatched artifact."""


class FormatVersionError(ArtifactError):
    """The artifact's magic/format version doesn't match this reader."""


class ChecksumError(ArtifactError):
    """A buffer's bytes don't hash to the manifest's recorded sha256."""


def _sha256_file(path: Path, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


def _encode_strings(strings: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """utf-8 blob + int64[n+1] offsets (the persisted string-list layout)."""
    encoded = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    blob = np.frombuffer(b"".join(encoded), dtype=np.uint8).copy()
    return offsets, blob


def _decode_strings(offsets: np.ndarray, blob: np.ndarray) -> list[str]:
    data = blob.tobytes()
    return [data[offsets[i]:offsets[i + 1]].decode("utf-8")
            for i in range(len(offsets) - 1)]


@dataclasses.dataclass(frozen=True)
class _BufferSpec:
    file: str
    dtype: str
    shape: tuple[int, ...]
    sha256: str


class LazyArtifactIndex(InvertedIndex):
    """An :class:`InvertedIndex` resolved straight off the mmapped
    artifact buffers: token -> posting is a binary search over the
    persisted *sorted* token table, and posting lists are mmap views.

    Nothing vocabulary-sized is materialized at construction — opening an
    artifact stays O(1) in vocabulary — and a lookup touches O(log T)
    pages of the token table plus the one posting it returns.
    ``vocabulary()`` / ``to_postings()`` do materialize the token list
    (callers that enumerate the vocabulary, e.g. the CLI keyword
    auto-pick, pay for what they use).
    """

    def __init__(self, artifact: "GraphArtifact") -> None:
        super().__init__()
        self._n_tokens = int(artifact.manifest["n_tokens"])
        self._token_kind = artifact.token_kind
        self._offsets = artifact.buffer("post_offsets")
        self._nodes = artifact.buffer("post_nodes")
        if self._token_kind == "int":
            self._keys = artifact.buffer("token_keys")
        else:
            self._tok_off = artifact.buffer("token_offsets")
            self._tok_blob = artifact.buffer("token_bytes")

    def _token_at(self, i: int):
        if self._token_kind == "int":
            return int(self._keys[i])
        return bytes(
            self._tok_blob[self._tok_off[i]:self._tok_off[i + 1]]
        ).decode("utf-8")

    def _find(self, token) -> int:
        """Sorted-table position of ``token``, or -1.  The table order is
        the writer's ``sorted()`` — ascending ints, or code-point order
        for strings, which utf-8 byte comparison reproduces exactly."""
        n = self._n_tokens
        if self._token_kind == "int":
            if not isinstance(token, (int, np.integer)):
                return -1
            i = int(np.searchsorted(self._keys, int(token)))
            return i if i < n and int(self._keys[i]) == int(token) else -1
        if not isinstance(token, str):
            return -1
        key = token.encode("utf-8")
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            b = bytes(self._tok_blob[
                self._tok_off[mid]:self._tok_off[mid + 1]])
            if b < key:
                lo = mid + 1
            else:
                hi = mid
        if lo < n and bytes(self._tok_blob[
                self._tok_off[lo]:self._tok_off[lo + 1]]) == key:
            return lo
        return -1

    def lookup(self, token) -> np.ndarray:
        i = self._find(token)
        if i < 0:
            return np.zeros(0, np.int32)
        return self._nodes[self._offsets[i]:self._offsets[i + 1]]

    def df(self, token) -> int:
        i = self._find(token)
        return 0 if i < 0 else int(self._offsets[i + 1] - self._offsets[i])

    def vocabulary(self) -> list:
        return [self._token_at(i) for i in range(self._n_tokens)]

    def token_dfs(self) -> list[tuple]:
        """Bulk ``(token, df)`` enumeration: one diff over the offsets
        table — not a binary search per token like ``df()`` would be."""
        dfs = np.diff(np.asarray(self._offsets))
        return [(self._token_at(i), int(dfs[i]))
                for i in range(self._n_tokens)]

    def to_postings(self) -> tuple[list, np.ndarray, np.ndarray]:
        return (self.vocabulary(), np.asarray(self._offsets),
                np.asarray(self._nodes, np.int32))


class BufferDir:
    """Shared plumbing for a directory of manifest-described ``.npy``
    buffers: lazy mmap access plus layered validation.  Base class of
    :class:`GraphArtifact` and :class:`repro_torch.store.delta.DeltaArtifact`.
    """

    def __init__(self, path: Path, manifest: dict[str, Any]) -> None:
        self.path = Path(path)
        self.manifest = manifest
        self._buffers: dict[str, _BufferSpec] = {
            name: _BufferSpec(file=spec["file"], dtype=spec["dtype"],
                              shape=tuple(spec["shape"]),
                              sha256=spec["sha256"])
            for name, spec in manifest["buffers"].items()}
        self._arrays: dict[str, np.ndarray] = {}

    @property
    def format_version(self) -> int:
        return int(self.manifest["format_version"])

    @property
    def content_hash(self) -> str:
        return self.manifest["content_hash"]

    @property
    def stats(self) -> dict[str, Any]:
        """Ingestion stats recorded at write time (true counts etc.)."""
        return self.manifest.get("stats", {})

    def nbytes(self) -> int:
        """Total on-disk buffer bytes (payload, excluding npy headers)."""
        return sum(int(np.prod(spec.shape)) * np.dtype(spec.dtype).itemsize
                   for spec in self._buffers.values())

    def buffer(self, name: str) -> np.ndarray:
        """Memory-mapped view of one buffer (cached, read-only)."""
        arr = self._arrays.get(name)
        if arr is None:
            spec = self._buffers.get(name)
            if spec is None:
                raise ArtifactError(f"artifact has no buffer {name!r} "
                                    f"({self.path})")
            arr = np.load(self.path / spec.file, mmap_mode="r")
            if str(arr.dtype) != spec.dtype or arr.shape != spec.shape:
                raise ArtifactError(
                    f"buffer {name!r} on disk is {arr.dtype}{arr.shape}, "
                    f"manifest says {spec.dtype}{spec.shape} ({self.path})")
            self._arrays[name] = arr
        return arr

    def validate(self) -> None:
        """Cheap structural check: every buffer opens and matches its
        manifest dtype/shape (reads npy headers only, not the data)."""
        for name in self._buffers:
            self.buffer(name)

    def verify_checksums(self) -> None:
        """Re-hash every buffer file against the manifest (full read)."""
        for name, spec in self._buffers.items():
            digest = _sha256_file(self.path / spec.file)
            if digest != spec.sha256:
                raise ChecksumError(
                    f"buffer {name!r} hash mismatch in {self.path}: "
                    f"{digest[:16]}… != recorded {spec.sha256[:16]}… "
                    "(artifact corrupted or truncated)")


class GraphArtifact(BufferDir):
    """An opened artifact: manifest metadata + lazily mmapped buffers.

    Use :func:`open_artifact` (or :func:`write_artifact`, which returns the
    reopened artifact) rather than constructing directly.  ``graph()`` and
    ``index()`` build the engine-facing objects on top of the mmapped
    buffers without re-tokenizing or re-sorting anything.
    """

    def __init__(self, path: Path, manifest: dict[str, Any]) -> None:
        super().__init__(path, manifest)
        self._graph: Graph | None = None
        self._index: InvertedIndex | None = None

    # -- manifest metadata ---------------------------------------------

    @property
    def n_nodes(self) -> int:
        return int(self.manifest["n_nodes"])

    @property
    def n_edges_directed(self) -> int:
        return int(self.manifest["n_edges_directed"])

    @property
    def n_edges_sym(self) -> int:
        return int(self.manifest["n_edges_sym"])

    @property
    def tau(self) -> int:
        return int(self.manifest["tau"])

    @property
    def token_kind(self) -> str:
        return self.manifest["token_kind"]  # "int" | "str"

    @property
    def has_labels(self) -> bool:
        return "label_offsets" in self._buffers

    @property
    def has_names(self) -> bool:
        """True when the entity-name table is persisted.  Names are the
        ingest-time dictionary keys (e.g. full URIs), distinct from the
        display labels — deltas need them to resolve existing entities."""
        return "ent_offsets" in self._buffers

    @property
    def typed(self) -> bool:
        """True when the artifact persists the per-edge (pred, conf)
        channel (format v2 typed graphs)."""
        return "csr_pred" in self._buffers

    @property
    def predicates(self) -> list[str]:
        """Predicate dictionary recorded at write time (empty when
        untyped — v1 artifacts never have one)."""
        return list(self.manifest.get("predicates", []))

    # -- engine-facing objects -----------------------------------------

    def graph(self) -> Graph:
        """Host :class:`Graph` over the mmapped buffers (zero-copy: CSR,
        raw edges, and the dst-sorted symmetric list are all views).

        ``labels`` stays ``None`` here — the engine takes the persisted
        index instead of re-tokenizing; call :meth:`labels` when the text
        itself is needed."""
        if self._graph is None:
            typed: dict[str, Any] = {}
            if self.typed:
                typed = dict(
                    csr_pred=self.buffer("csr_pred"),
                    csr_conf=self.buffer("csr_conf"),
                    sym_typed=(self.buffer("sym_pred"),
                               self.buffer("sym_conf")),
                    pred_names=self.predicates,
                )
                if "pred" in self._buffers:
                    typed["pred"] = self.buffer("pred")
                    typed["conf"] = self.buffer("conf")
            self._graph = Graph(
                n_nodes=self.n_nodes,
                src=self.buffer("src"), dst=self.buffer("dst"),
                w=self.buffer("w"),
                indptr=self.buffer("indptr"),
                indices=self.buffer("indices"), ew=self.buffer("ew"),
                labels=None,
                sym_sorted=(self.buffer("sym_src"),
                            self.buffer("sym_dst"),
                            self.buffer("sym_w")),
                **typed,
            )
        return self._graph

    def index(self) -> InvertedIndex:
        """The persisted :class:`InvertedIndex`, fully lazy
        (:class:`LazyArtifactIndex`): tokens resolve by binary search over
        the mmapped sorted token table and postings stay on disk until
        looked up — no token dict is materialized, so this is O(1) in
        vocabulary size (the former dict build made artifact open scale
        with the vocabulary)."""
        if self._index is None:
            self._index = LazyArtifactIndex(self)
        return self._index

    def labels(self) -> list[str] | None:
        """Decode the node label text (materializes V strings)."""
        if not self.has_labels:
            return None
        return _decode_strings(np.asarray(self.buffer("label_offsets")),
                               self.buffer("label_bytes"))

    def label(self, i: int) -> str:
        """Decode ONE node's label straight off the mmapped blob — answer
        rendering pays per served node, not per graph."""
        if not self.has_labels:
            raise ArtifactError(f"artifact has no labels ({self.path})")
        offsets = self.buffer("label_offsets")
        if not 0 <= i < len(offsets) - 1:
            raise IndexError(f"label index {i} out of range "
                             f"[0, {len(offsets) - 1})")
        blob = self.buffer("label_bytes")
        return blob[int(offsets[i]):int(offsets[i + 1])].tobytes() \
            .decode("utf-8")

    def entity_names(self) -> list[str]:
        """Decode the entity-name table (ingest dictionary keys, id order).

        Raises :class:`ArtifactError` when the table wasn't persisted —
        only reader-produced artifacts written by this version carry it,
        and without it a delta cannot resolve existing entities."""
        if not self.has_names:
            raise ArtifactError(
                f"artifact has no entity-name table ({self.path}) — "
                "re-ingest the source with this version to enable delta "
                "stacking")
        return _decode_strings(np.asarray(self.buffer("ent_offsets")),
                               self.buffer("ent_bytes"))

    def entity_name(self, i: int) -> str:
        """Decode ONE entity name straight off the mmapped blob."""
        if not self.has_names:
            raise ArtifactError(f"artifact has no entity-name table "
                                f"({self.path})")
        offsets = self.buffer("ent_offsets")
        if not 0 <= i < len(offsets) - 1:
            raise IndexError(f"entity index {i} out of range "
                             f"[0, {len(offsets) - 1})")
        blob = self.buffer("ent_bytes")
        return blob[int(offsets[i]):int(offsets[i + 1])].tobytes() \
            .decode("utf-8")

    def __repr__(self) -> str:
        chain = ""
        st = self.manifest.get("stats") or {}
        if "compacted_from_chain" in st:
            chain = (f", compacted[chain={str(st['compacted_from_chain'])[:12]}…"
                     f", depth={st.get('chain_depth')}]")
        return (f"GraphArtifact({str(self.path)!r}, V={self.n_nodes:,}, "
                f"E_sym={self.n_edges_sym:,}, "
                f"hash={self.content_hash[:12]}…{chain})")


def _content_hash(meta: dict[str, Any],
                  buffers: dict[str, dict[str, Any]]) -> str:
    """Deterministic digest of the graph *content*: scalar metadata plus
    every buffer's recorded hash (canonical JSON, sorted keys)."""
    payload = {"meta": meta,
               "buffers": {k: v["sha256"] for k, v in sorted(
                   buffers.items())}}
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def write_artifact(
    path: str | Path,
    graph: Graph,
    index: InvertedIndex,
    *,
    tau: int = 1001,
    stats: dict[str, Any] | None = None,
    labels: list[str] | None = None,
    names: list[str] | None = None,
    overwrite: bool = False,
) -> GraphArtifact:
    """Write ``(graph, index)`` as a versioned artifact and reopen it.

    Atomic: buffers and manifest land in a temp sibling directory which is
    renamed onto ``path`` last — readers never observe a partial write.
    ``stats`` (e.g. ``IngestStats.as_dict()``) is recorded verbatim in the
    manifest.  ``labels`` defaults to ``graph.labels``.  ``names`` is the
    optional entity-name table (ingest dictionary keys in id order, e.g.
    full URIs) — persisting it makes the artifact a valid base for delta
    stacking (:mod:`repro_torch.store.delta`).  Returns the artifact *reopened
    from disk*, so the caller's engine build exercises the same mmap path
    a later process will.
    """
    path = Path(path)
    if path.exists() and not overwrite:
        raise ArtifactError(
            f"artifact path exists: {path} (pass overwrite=True)")
    tmp = path.parent / f"{path.name}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    try:
        _write_buffers(tmp, graph, index, tau=tau, stats=stats,
                       labels=labels, names=names)
    except BaseException:
        # Never leave half-written debris behind: only the atomic rename
        # below publishes state.
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    if path.exists():  # overwrite=True: checked above
        shutil.rmtree(path)
    os.replace(tmp, path)
    return open_artifact(path)


def _write_buffers(
    tmp: Path,
    graph: Graph,
    index: InvertedIndex,
    *,
    tau: int,
    stats: dict[str, Any] | None,
    labels: list[str] | None,
    names: list[str] | None = None,
) -> None:
    labels = graph.labels if labels is None else labels
    tokens, post_offsets, post_nodes = index.to_postings()
    token_kind = ("int" if not tokens or isinstance(tokens[0], (int,
                  np.integer)) else "str")

    arrays: dict[str, np.ndarray] = {
        "src": np.ascontiguousarray(graph.src, np.int32),
        "dst": np.ascontiguousarray(graph.dst, np.int32),
        "w": np.ascontiguousarray(graph.w, np.float32),
        "indptr": np.ascontiguousarray(graph.indptr, np.int64),
        "indices": np.ascontiguousarray(graph.indices, np.int32),
        "ew": np.ascontiguousarray(graph.ew, np.float32),
        "post_offsets": post_offsets,
        "post_nodes": np.ascontiguousarray(post_nodes, np.int32),
    }
    sym_src, sym_dst, sym_w = graph.sym_sorted_edges(cache=True)
    arrays["sym_src"] = np.ascontiguousarray(sym_src, np.int32)
    arrays["sym_dst"] = np.ascontiguousarray(sym_dst, np.int32)
    arrays["sym_w"] = np.ascontiguousarray(sym_w, np.float32)
    if graph.typed:
        arrays["csr_pred"] = np.ascontiguousarray(graph.csr_pred, np.int32)
        arrays["csr_conf"] = np.ascontiguousarray(graph.csr_conf, np.float32)
        sym_pred, sym_conf = graph.sym_typed_edges(cache=True)
        arrays["sym_pred"] = np.ascontiguousarray(sym_pred, np.int32)
        arrays["sym_conf"] = np.ascontiguousarray(sym_conf, np.float32)
        if graph.pred is not None:
            arrays["pred"] = np.ascontiguousarray(graph.pred, np.int32)
            arrays["conf"] = np.ascontiguousarray(graph.conf, np.float32)
    if token_kind == "int":
        arrays["token_keys"] = np.asarray([int(t) for t in tokens],
                                          np.int64)
    else:
        tok_off, tok_blob = _encode_strings([str(t) for t in tokens])
        arrays["token_offsets"] = tok_off
        arrays["token_bytes"] = tok_blob
    if labels is not None:
        lab_off, lab_blob = _encode_strings(list(labels))
        arrays["label_offsets"] = lab_off
        arrays["label_bytes"] = lab_blob
    if names is not None:
        ent_off, ent_blob = _encode_strings(list(names))
        arrays["ent_offsets"] = ent_off
        arrays["ent_bytes"] = ent_blob

    buffers: dict[str, dict[str, Any]] = {}
    for name, arr in arrays.items():
        fname = f"{name}.npy"
        np.save(tmp / fname, arr)
        buffers[name] = {
            "file": fname,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
            "sha256": _sha256_file(tmp / fname),
        }

    meta = {
        "magic": MAGIC,
        "format_version": FORMAT_VERSION,
        "n_nodes": int(graph.n_nodes),
        "n_edges_directed": int(graph.n_edges_directed),
        "n_edges_sym": int(graph.n_edges_sym),
        "tau": int(tau),
        "token_kind": token_kind,
        "n_tokens": len(tokens),
    }
    if graph.typed:
        # Predicate dictionary in the (content-hashed) meta: the artifact
        # is self-describing — names, not just a count — and renaming a
        # predicate changes the content identity.
        meta["predicates"] = list(graph.pred_names or [])
    manifest = dict(meta)
    manifest["stats"] = stats or {}
    manifest["buffers"] = buffers
    manifest["content_hash"] = _content_hash(meta, buffers)
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))


def open_artifact(path: str | Path,
                  verify: str = "meta") -> GraphArtifact:
    """Open an artifact for reading (mmap; nothing large is touched).

    ``verify``: ``"meta"`` (default) checks magic/format version and that
    every buffer's on-disk dtype/shape matches the manifest; ``"full"``
    additionally re-hashes every buffer against its recorded sha256.
    Raises :class:`FormatVersionError` on a version mismatch,
    :class:`ChecksumError` on corruption, :class:`ArtifactError` on
    anything structurally wrong.
    """
    if verify not in ("meta", "full"):
        raise ValueError(f"unknown verify={verify!r} "
                         "(expected 'meta' or 'full')")
    path = Path(path)
    mpath = path / _MANIFEST
    if not mpath.is_file():
        raise ArtifactError(f"no graph artifact at {path} "
                            f"(missing {_MANIFEST})")
    try:
        manifest = json.loads(mpath.read_text())
    except json.JSONDecodeError as exc:
        raise ArtifactError(f"unreadable manifest in {path}: {exc}") from exc
    if manifest.get("magic") != MAGIC:
        if manifest.get("magic") == DELTA_MAGIC:
            raise FormatVersionError(
                f"{path} is a delta artifact stacking on base "
                f"{str(manifest.get('base_content_hash'))[:12]}… at depth "
                f"{manifest.get('base_depth', 0) + 1} — open it with "
                "repro_torch.store.open_chain(base, …), not open_artifact()")
        raise FormatVersionError(
            f"{path} is not a {MAGIC} (magic={manifest.get('magic')!r})")
    version = manifest.get("format_version")
    if version not in SUPPORTED_VERSIONS:
        raise FormatVersionError(
            f"artifact format v{version} at {path}; this reader supports "
            f"v{SUPPORTED_VERSIONS} — re-ingest the source with this "
            "version")
    for key in ("content_hash", "buffers", "n_nodes"):
        if key not in manifest:
            raise ArtifactError(f"manifest missing {key!r} in {path}")
    art = GraphArtifact(path, manifest)
    art.validate()
    if verify == "full":
        art.verify_checksums()
    return art
