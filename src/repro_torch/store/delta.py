"""Delta artifacts: live-graph growth without full re-ingest.

A copy of ``repro.store.delta``; delta artifacts are byte-identical
between the two packages, chained hashes included.

A :class:`DeltaArtifact` is a directory of ``.npy`` buffers holding only
what changed — new directed edges (with the typed ``(pred, conf)``
channel), new entities (dictionary growth: names + labels), and new
predicate names — stacked on an exact base identified by its
``content_hash``.  :func:`open_chain` merges ``base + delta_1 + … +
delta_d`` into an engine-ready :class:`GraphChain` whose
``content_hash`` is the *chained* hash, so ``QueryEngine.version`` /
``cache_token`` can never serve a stale build; :func:`compact_chain`
folds a chain back into a fresh base artifact.

The invariant everything here is built around: **a chain is
bit-identical to re-ingesting the union.**  The base ingest is a prefix
of the union ingest's statement stream, so its dictionary (entity ids,
predicate ids, labels) is exactly the union dictionary's prefix; a
:class:`DeltaBuilder` reproduces the suffix by seeding a fresh
:class:`StreamIngestor` with the base's persisted name table and real
predicate dictionary, then feeding fragments through the *same*
statement→edge mapping the bulk readers use
(:func:`repro_torch.store.ingest.feed_nt_line` / ``feed_tsv_line``).  Merging
re-derives degree weights over the union in-degrees and re-runs
:func:`build_graph` on the concatenated directed edges — the identical
inputs the union re-ingest would hand it — so weights, CSR, answer
trees, and even the compacted artifact's ``content_hash`` come out
equal (the manifest ``stats`` block is excluded from the hash by
design, which is what makes that equality testable).

Predicate-dictionary mechanics mirror ``StreamIngestor.finalize``
exactly: deltas store ``pred=-1`` for untyped statements and never
resolve the synthetic ``"(untyped)"`` entry; the merge renumbers base
predicates compactly over the *real* names (base order preserved),
appends each delta's new names in chain order, and files remaining
``-1`` rows under a final ``"(untyped)"`` id — the same
"registered-at-finalize, therefore last" position the union ingest
produces.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from collections.abc import Sequence
from pathlib import Path
from typing import Any, Union

import numpy as np

from repro_torch.graph.index import InvertedIndex
from repro_torch.graph.structure import Graph, build_graph
from repro_torch.store.artifact import (
    DELTA_MAGIC, _MANIFEST, ArtifactError, BufferDir, FormatVersionError,
    GraphArtifact, MAGIC, _content_hash, _decode_strings, _encode_strings,
    _sha256_file, open_artifact, write_artifact,
)
from repro_torch.store.ingest import (
    _CHUNK_EDGES, IngestStats, StreamIngestor, feed_nt_line, feed_tsv_line,
)

DELTA_FORMAT_VERSION = 1
_UNTYPED = "(untyped)"

#: Suffixes the format sniffer maps to a reader (``.gz`` is stripped
#: first) — shared with the watcher's directory scan.
NT_SUFFIXES = (".nt", ".ntriples")
TSV_SUFFIXES = (".tsv", ".txt", ".edges")


def chained_hash(below: str, delta_hash: str) -> str:
    """Version of a chain after stacking one delta: a digest of the
    (chain-below, delta) hash pair.  Order-sensitive and
    collision-separated from plain content hashes by the prefix."""
    return hashlib.sha256(
        f"chain:{below}+{delta_hash}".encode()).hexdigest()


def sniff_format(path: str | Path) -> str:
    """``"nt"`` | ``"tsv"`` from a fragment's suffix (``.gz`` stripped).
    Raises :class:`ArtifactError` for an unrecognized suffix."""
    p = Path(path)
    suffix = Path(p.stem).suffix if p.suffix == ".gz" else p.suffix
    if suffix in NT_SUFFIXES:
        return "nt"
    if suffix in TSV_SUFFIXES:
        return "tsv"
    raise ArtifactError(
        f"cannot sniff fragment format of {p} (suffix {suffix!r}; "
        f"known: {NT_SUFFIXES + TSV_SUFFIXES}, optionally .gz) — pass "
        "fmt='nt' or fmt='tsv'")


class _StringTable(Sequence):
    """Concatenated (offsets, blob) string segments that duck-type as a
    ``list[str]`` — node labels / entity names across a chain without
    decoding V strings up front.  ``labels[v]`` decodes one string off
    the mmapped segment; iteration (e.g. artifact compaction) streams
    them all."""

    def __init__(self, segments: list[tuple[np.ndarray, np.ndarray]]):
        self._segments = segments
        counts = [len(off) - 1 for off, _ in segments]
        self._bounds = np.cumsum([0] + counts)

    def __len__(self) -> int:
        return int(self._bounds[-1])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(f"string index {i} out of range "
                             f"[0, {len(self)})")
        seg = int(np.searchsorted(self._bounds, i, side="right")) - 1
        off, blob = self._segments[seg]
        j = i - int(self._bounds[seg])
        return bytes(blob[int(off[j]):int(off[j + 1])]).decode("utf-8")

    def __iter__(self):
        for off, blob in self._segments:
            data = np.asarray(blob).tobytes()
            for j in range(len(off) - 1):
                yield data[int(off[j]):int(off[j + 1])].decode("utf-8")


class DeltaArtifact(BufferDir):
    """An opened delta: additions stacked on one exact base build.

    Buffers: ``src``/``dst``/``pred``/``conf`` (new directed edges in
    union-global entity ids and chain-global *real* predicate ids,
    ``pred=-1`` for untyped statements) and the new entities' name/label
    tables.  Use :func:`open_delta` rather than constructing directly.
    """

    @property
    def base_content_hash(self) -> str:
        return self.manifest["base_content_hash"]

    @property
    def base_depth(self) -> int:
        return int(self.manifest.get("base_depth", 0))

    @property
    def depth(self) -> int:
        """Chain depth after stacking this delta (base artifact = 0)."""
        return self.base_depth + 1

    @property
    def chain_hash(self) -> str:
        """``chained_hash(base_content_hash, content_hash)`` — the chain
        version after this delta (recorded for convenience; readers
        recompute it rather than trust it)."""
        return self.manifest["chain_hash"]

    @property
    def base_n_nodes(self) -> int:
        return int(self.manifest["base_n_nodes"])

    @property
    def base_n_predicates(self) -> int:
        """REAL predicates in the base (the synthetic ``"(untyped)"``
        entry excluded) — the id offset this delta's new names start at."""
        return int(self.manifest["base_n_predicates"])

    @property
    def n_new_nodes(self) -> int:
        return int(self.manifest["n_new_nodes"])

    @property
    def n_new_edges(self) -> int:
        return int(self.manifest["n_new_edges"])

    @property
    def new_predicates(self) -> list[str]:
        return list(self.manifest.get("new_predicates", []))

    @property
    def typed(self) -> bool:
        return bool(self.manifest.get("typed", False))

    @property
    def tau(self) -> int:
        return int(self.manifest["tau"])

    @property
    def token_kind(self) -> str:
        return self.manifest["token_kind"]

    def edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
        """Mmapped ``(src, dst, pred, conf)`` of the new directed edges."""
        return (self.buffer("src"), self.buffer("dst"),
                self.buffer("pred"), self.buffer("conf"))

    def new_labels(self) -> list[str]:
        return _decode_strings(np.asarray(self.buffer("label_offsets")),
                               self.buffer("label_bytes"))

    def new_names(self) -> list[str]:
        return _decode_strings(np.asarray(self.buffer("ent_offsets")),
                               self.buffer("ent_bytes"))

    def __repr__(self) -> str:
        return (f"DeltaArtifact({str(self.path)!r}, "
                f"+V={self.n_new_nodes:,}, +E={self.n_new_edges:,}, "
                f"base={self.base_content_hash[:12]}…, "
                f"depth={self.depth}, hash={self.content_hash[:12]}…)")


def open_delta(path: str | Path, verify: str = "meta") -> DeltaArtifact:
    """Open a delta artifact (mmap; same layered validation contract as
    :func:`repro_torch.store.open_artifact`)."""
    if verify not in ("meta", "full"):
        raise ValueError(f"unknown verify={verify!r} "
                         "(expected 'meta' or 'full')")
    path = Path(path)
    mpath = path / _MANIFEST
    if not mpath.is_file():
        raise ArtifactError(f"no delta artifact at {path} "
                            f"(missing {_MANIFEST})")
    try:
        manifest = json.loads(mpath.read_text())
    except json.JSONDecodeError as exc:
        raise ArtifactError(f"unreadable manifest in {path}: {exc}") from exc
    if manifest.get("magic") != DELTA_MAGIC:
        if manifest.get("magic") == MAGIC:
            raise FormatVersionError(
                f"{path} is a base graph artifact "
                f"(hash={str(manifest.get('content_hash'))[:12]}…), not a "
                "delta — open it with open_artifact(), or pass it as the "
                "base of open_chain(base, *deltas)")
        raise FormatVersionError(
            f"{path} is not a {DELTA_MAGIC} "
            f"(magic={manifest.get('magic')!r})")
    version = manifest.get("format_version")
    if version != DELTA_FORMAT_VERSION:
        raise FormatVersionError(
            f"delta format v{version} at {path}; this reader supports "
            f"v{DELTA_FORMAT_VERSION}")
    for key in ("content_hash", "buffers", "base_content_hash",
                "base_n_nodes", "n_new_nodes", "n_new_edges"):
        if key not in manifest:
            raise ArtifactError(f"manifest missing {key!r} in {path}")
    delta = DeltaArtifact(path, manifest)
    delta.validate()
    if verify == "full":
        delta.verify_checksums()
    return delta


def _real_predicates(predicates: list[str]) -> list[str]:
    return [p for p in predicates if p != _UNTYPED]


class DeltaBuilder:
    """Accumulate fragments into one delta against an exact base build.

    ``base`` is a :class:`GraphArtifact` or :class:`GraphChain` — it must
    carry the entity-name table (``write_artifact(..., names=...)``; only
    reader-produced artifacts do) and a string-token index.  The builder
    seeds a fresh :class:`StreamIngestor` with the base dictionary so
    fragment statements resolve existing entities/predicates to their
    base ids and new ones grow the dictionary exactly as a full union
    re-ingest would.
    """

    def __init__(self, base: Union[GraphArtifact, "GraphChain"], *,
                 chunk_edges: int = _CHUNK_EDGES,
                 spill_dir: str | Path | None = None) -> None:
        if base.token_kind != "str":
            raise ArtifactError(
                f"delta bases need a string-token index; base "
                f"{base.content_hash[:12]}… has token_kind="
                f"{base.token_kind!r} (synthetic int-token graphs don't "
                "grow by text fragments)")
        names = base.entity_names()   # raises ArtifactError without table
        self.base = base
        self.base_content_hash = base.content_hash
        self.base_depth = int(getattr(base, "depth", 0))
        self.base_n_nodes = int(base.n_nodes)
        self.tau = int(base.tau)
        real = _real_predicates(base.predicates)
        self.base_n_predicates = len(real)
        self.stats = IngestStats(
            source=f"delta:base={self.base_content_hash[:12]}")
        self._ing = StreamIngestor(chunk_edges=chunk_edges,
                                   spill_dir=spill_dir)
        # Seed the dictionary: ids are assigned in call order, so walking
        # the persisted tables reproduces the base assignment exactly.
        for name in names:
            self._ing.entity_id(name)
        for p in real:
            self._ing.predicate_id(p)

    # -- accumulation --------------------------------------------------

    def add_statement(self, src: str, dst: str,
                      src_label: str | None = None,
                      dst_label: str | None = None,
                      pred: str | None = None,
                      conf: float = 1.0) -> None:
        """One pre-parsed statement (same contract as
        ``StreamIngestor.add_edge``)."""
        self.stats.statements += 1
        self._ing.add_edge(src, dst, src_label, dst_label,
                           pred=pred, conf=conf)

    def add_file(self, path: str | Path, fmt: str = "auto",
                 on_error: str = "skip") -> None:
        """Stream one N-Triples/TSV fragment (``.gz`` transparent) into
        the delta, through the same line parsers as the bulk readers."""
        if on_error not in ("skip", "raise"):
            raise ValueError(f"unknown on_error={on_error!r}")
        fmt = sniff_format(path) if fmt == "auto" else fmt
        if fmt not in ("nt", "tsv"):
            raise ValueError(f"unknown fmt={fmt!r} (expected 'nt'/'tsv')")
        feed = feed_nt_line if fmt == "nt" else feed_tsv_line
        from repro_torch.store.ingest import iter_lines
        for line in iter_lines(path):
            self.stats.lines_read += 1
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not feed(self._ing, line):
                if on_error == "raise":
                    raise ValueError(
                        f"malformed {fmt} line {self.stats.lines_read} "
                        f"in {path}: {line[:120]!r}")
                self.stats.malformed_lines += 1
                continue
            self.stats.statements += 1

    # -- introspection -------------------------------------------------

    @property
    def n_new_nodes(self) -> int:
        return self._ing.n_nodes - self.base_n_nodes

    @property
    def n_new_edges(self) -> int:
        return self._ing.n_edges

    @property
    def new_predicates(self) -> list[str]:
        return self._ing.pred_names[self.base_n_predicates:]

    @property
    def empty(self) -> bool:
        return self.n_new_nodes == 0 and self.n_new_edges == 0

    # -- publication ---------------------------------------------------

    def write(self, path: str | Path,
              overwrite: bool = False) -> DeltaArtifact:
        """Publish the delta atomically (tmp sibling + rename — the
        ``write_artifact`` discipline) and reopen it from disk."""
        if self.empty:
            raise ArtifactError(
                "empty delta (no new edges or entities) — nothing to "
                "publish")
        path = Path(path)
        if path.exists() and not overwrite:
            raise ArtifactError(
                f"delta path exists: {path} (pass overwrite=True)")
        src, dst, pred, conf = self._ing.edges()
        # Typedness of the delta *content* (the seeded predicate
        # dictionary alone doesn't make the additions typed).
        typed = bool(self.new_predicates) \
            or bool(len(pred) and (pred >= 0).any()) \
            or bool(len(conf) and (conf != 1.0).any())
        new_labels = self._ing.node_labels[self.base_n_nodes:]
        new_names = self._ing.entity_names[self.base_n_nodes:]
        lab_off, lab_blob = _encode_strings(new_labels)
        ent_off, ent_blob = _encode_strings(new_names)
        arrays: dict[str, np.ndarray] = {
            "src": np.ascontiguousarray(src, np.int32),
            "dst": np.ascontiguousarray(dst, np.int32),
            "pred": np.ascontiguousarray(pred, np.int32),
            "conf": np.ascontiguousarray(conf, np.float32),
            "label_offsets": lab_off, "label_bytes": lab_blob,
            "ent_offsets": ent_off, "ent_bytes": ent_blob,
        }

        tmp = path.parent / f"{path.name}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        try:
            buffers: dict[str, dict[str, Any]] = {}
            for name, arr in arrays.items():
                fname = f"{name}.npy"
                np.save(tmp / fname, arr)
                buffers[name] = {
                    "file": fname, "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                    "sha256": _sha256_file(tmp / fname),
                }
            meta = {
                "magic": DELTA_MAGIC,
                "format_version": DELTA_FORMAT_VERSION,
                "base_content_hash": self.base_content_hash,
                "base_depth": self.base_depth,
                "base_n_nodes": self.base_n_nodes,
                "base_n_predicates": self.base_n_predicates,
                "n_new_nodes": self.n_new_nodes,
                "n_new_edges": int(len(src)),
                "new_predicates": self.new_predicates,
                "typed": typed,
                "tau": self.tau,
                "token_kind": "str",
            }
            manifest = dict(meta)
            self.stats.edges_directed = int(len(src))
            self.stats.self_loops_dropped = self._ing._self_loops
            self.stats.n_nodes = self.n_new_nodes
            self.stats.n_predicates = len(self.new_predicates)
            manifest["stats"] = self.stats.as_dict()
            manifest["buffers"] = buffers
            content = _content_hash(meta, buffers)
            manifest["content_hash"] = content
            manifest["chain_hash"] = chained_hash(
                self.base_content_hash, content)
            (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=1))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

        if path.exists():  # overwrite=True: checked above
            shutil.rmtree(path)
        os.replace(tmp, path)
        return open_delta(path)


class ChainIndex(InvertedIndex):
    """The base artifact's lazy index plus an in-memory posting overlay
    for the chain's new nodes.  New-node ids are all >= the base node
    count, so ``concat(base_posting, overlay_posting)`` IS the sorted
    unique posting a from-scratch tokenization of the merged labels
    would produce — no re-sort, and the base postings stay mmapped."""

    def __init__(self, base: InvertedIndex,
                 overlay: dict[str, np.ndarray]) -> None:
        super().__init__()
        self._base = base
        self._overlay = overlay

    @property
    def base_index(self) -> InvertedIndex:
        """The wrapped base index (a ``LazyArtifactIndex`` for
        artifact-backed chains)."""
        return self._base

    def lookup(self, token) -> np.ndarray:
        b = self._base.lookup(token)
        o = self._overlay.get(token)
        if o is None or len(o) == 0:
            return b
        if len(b) == 0:
            return o
        return np.concatenate([np.asarray(b, np.int32), o])

    def df(self, token) -> int:
        o = self._overlay.get(token)
        return int(self._base.df(token)) + (0 if o is None else len(o))

    def vocabulary(self) -> list:
        vocab = self._base.vocabulary()
        seen = set(vocab)
        return vocab + [t for t in self._overlay if t not in seen]

    def token_dfs(self) -> list[tuple]:
        seen = set()
        out = []
        for tok, d in self._base.token_dfs():
            seen.add(tok)
            o = self._overlay.get(tok)
            out.append((tok, d + (0 if o is None else len(o))))
        out.extend((tok, len(post)) for tok, post in self._overlay.items()
                   if tok not in seen)
        return out

    def to_postings(self) -> tuple[list, np.ndarray, np.ndarray]:
        tokens = sorted(set(self._base.vocabulary()) | set(self._overlay))
        offsets = np.zeros(len(tokens) + 1, np.int64)
        posts = []
        for i, tok in enumerate(tokens):
            p = np.asarray(self.lookup(tok), np.int32)
            offsets[i + 1] = offsets[i] + len(p)
            posts.append(p)
        nodes = (np.concatenate(posts) if posts
                 else np.zeros(0, np.int32))
        return tokens, offsets, nodes


class GraphChain:
    """``base + delta_1 + … + delta_d`` merged into an engine-ready view.

    Duck-types the :class:`GraphArtifact` surface ``QueryEngine.build``
    consumes — ``graph()``, ``index()``, ``content_hash`` — plus the
    label/name accessors, so ``QueryEngine.build(artifact=chain)``
    serves the live graph with ``version = f"artifact:{chained hash}"``.
    Stacking order is verified hash-by-hash at construction; a
    mis-stacked delta fails immediately, naming both hashes and the
    depth, instead of surfacing later as a checksum/shape error.
    """

    def __init__(self, base: GraphArtifact,
                 deltas: tuple[DeltaArtifact, ...]) -> None:
        if not base.has_labels:
            raise ArtifactError(
                f"chain base {base.path} has no label text — delta chains "
                "need the base labels to extend the keyword index")
        self.base = base
        self.deltas = tuple(deltas)
        running = base.content_hash
        n_nodes = int(base.n_nodes)
        real = _real_predicates(base.predicates)
        for i, d in enumerate(self.deltas):
            if d.base_content_hash != running:
                raise ArtifactError(
                    f"mis-stacked delta at depth {i + 1}: {d.path} was "
                    f"built against {d.base_content_hash[:12]}… but the "
                    f"chain below it is {running[:12]}… — apply deltas in "
                    "publication order (or re-build the delta against the "
                    "current chain)")
            if int(d.tau) != int(base.tau):
                raise ArtifactError(
                    f"delta {d.path} was built with tau={d.tau}, base has "
                    f"tau={base.tau} — weights would diverge from a union "
                    "re-ingest")
            if d.base_n_nodes != n_nodes:
                raise ArtifactError(
                    f"delta {d.path} expects a base of {d.base_n_nodes:,} "
                    f"nodes; the chain below it has {n_nodes:,} "
                    f"(base={running[:12]}…, depth {i + 1})")
            if d.base_n_predicates != len(real):
                raise ArtifactError(
                    f"delta {d.path} expects {d.base_n_predicates} base "
                    f"predicates; the chain below it has {len(real)} "
                    f"(depth {i + 1})")
            running = chained_hash(running, d.content_hash)
            n_nodes += d.n_new_nodes
            real.extend(d.new_predicates)
        self._version = running
        self._n_nodes = n_nodes
        self._real_preds = real
        self._graph: Graph | None = None
        self._index: InvertedIndex | None = None

    # -- identity / metadata -------------------------------------------

    @property
    def content_hash(self) -> str:
        """The chained hash — every delta's content folded into the base
        hash in stacking order.  This is the engine/cache version."""
        return self._version

    @property
    def depth(self) -> int:
        return len(self.deltas)

    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    @property
    def n_edges_directed(self) -> int:
        return int(self.base.n_edges_directed) + sum(
            d.n_new_edges for d in self.deltas)

    @property
    def tau(self) -> int:
        return int(self.base.tau)

    @property
    def token_kind(self) -> str:
        return self.base.token_kind

    @property
    def typed(self) -> bool:
        return self.base.typed or any(d.typed for d in self.deltas)

    @property
    def has_labels(self) -> bool:
        return self.base.has_labels

    @property
    def has_names(self) -> bool:
        return self.base.has_names

    @property
    def predicates(self) -> list[str]:
        """Merged predicate dictionary (``"(untyped)"`` last when any
        merged edge is untyped — matching ``StreamIngestor.finalize``)."""
        if not self.typed:
            return []
        names = list(self._real_preds)
        if self._any_untyped():
            names.append(_UNTYPED)
        return names

    def _any_untyped(self) -> bool:
        if self.base.typed:
            if _UNTYPED in self.base.predicates:
                return True
        elif self.base.n_edges_directed:
            return True
        for d in self.deltas:
            pred = d.buffer("pred")
            if len(pred) and bool((np.asarray(pred) < 0).any()):
                return True
        return False

    # -- merged engine-facing objects ----------------------------------

    def _merged_edges(self) -> tuple[np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
        base = self.base
        e_base = int(base.n_edges_directed)
        srcs = [np.asarray(base.buffer("src"), np.int32)]
        dsts = [np.asarray(base.buffer("dst"), np.int32)]
        if base.typed:
            if "pred" not in base._buffers:
                raise ArtifactError(
                    f"chain base {base.path} persists no directed typed "
                    "buffers (pred/conf) — re-write the base with this "
                    "version")
            bp = np.asarray(base.buffer("pred"), np.int32)
            # Renumber base predicate ids over the real (non-"(untyped)")
            # names, base order preserved; "(untyped)" rows go back to -1
            # so the merge can re-file them under the final union id.
            idmap = np.empty(max(len(base.predicates), 1), np.int32)
            j = 0
            for i, name in enumerate(base.predicates):
                if name == _UNTYPED:
                    idmap[i] = -1
                else:
                    idmap[i] = j
                    j += 1
            preds = [np.where(bp >= 0, idmap[np.clip(bp, 0, None)],
                              np.int32(-1)) if len(bp) else bp]
            confs = [np.asarray(base.buffer("conf"), np.float32)]
        else:
            preds = [np.full(e_base, -1, np.int32)]
            confs = [np.ones(e_base, np.float32)]
        for d in self.deltas:
            src, dst, pred, conf = d.edges()
            srcs.append(np.asarray(src, np.int32))
            dsts.append(np.asarray(dst, np.int32))
            preds.append(np.asarray(pred, np.int32))
            confs.append(np.asarray(conf, np.float32))
        return (np.concatenate(srcs), np.concatenate(dsts),
                np.concatenate(preds), np.concatenate(confs))

    def graph(self) -> Graph:
        """The merged host graph: one :func:`build_graph` over the
        concatenated directed edges, degree weights re-derived over the
        union in-degrees — the identical inputs a union re-ingest hands
        it, hence bit-identical outputs."""
        if self._graph is None:
            src, dst, pred, conf = self._merged_edges()
            labels = self._label_table()
            if self.typed:
                names = list(self._real_preds)
                if len(pred) and bool((pred < 0).any()):
                    untyped_id = len(names)
                    names.append(_UNTYPED)
                    pred = np.where(pred < 0, np.int32(untyped_id), pred)
                self._graph = build_graph(
                    src, dst, max(self._n_nodes, 1), labels=labels,
                    tau=self.tau, pred=pred, conf=conf, pred_names=names)
            else:
                self._graph = build_graph(
                    src, dst, max(self._n_nodes, 1), labels=labels,
                    tau=self.tau)
        return self._graph

    def index(self) -> InvertedIndex:
        """Base lazy index + in-memory overlay of the new nodes' tokens
        (tokenized exactly like ``InvertedIndex.from_labels``)."""
        if self._index is None:
            overlay: dict[str, list[int]] = {}
            off = int(self.base.n_nodes)
            for d in self.deltas:
                for j, text in enumerate(d.new_labels()):
                    for tok in text.lower().split():
                        overlay.setdefault(tok, []).append(off + j)
                off += d.n_new_nodes
            frozen = {tok: np.unique(np.asarray(nodes, np.int32))
                      for tok, nodes in overlay.items()}
            self._index = ChainIndex(self.base.index(), frozen)
        return self._index

    def _label_table(self) -> _StringTable:
        segments = [(np.asarray(self.base.buffer("label_offsets")),
                     self.base.buffer("label_bytes"))]
        segments += [(np.asarray(d.buffer("label_offsets")),
                      d.buffer("label_bytes")) for d in self.deltas]
        return _StringTable(segments)

    def labels(self) -> list[str]:
        return list(self._label_table())

    def label(self, i: int) -> str:
        return self._label_table()[i]

    def entity_names(self) -> list[str]:
        names = self.base.entity_names()
        for d in self.deltas:
            names.extend(d.new_names())
        return names

    def __repr__(self) -> str:
        return (f"GraphChain(base={self.base.content_hash[:12]}…, "
                f"depth={self.depth}, V={self.n_nodes:,}, "
                f"E_directed={self.n_edges_directed:,}, "
                f"hash={self.content_hash[:12]}…)")


def open_chain(base: str | Path | GraphArtifact,
               *deltas: "str | Path | DeltaArtifact",
               verify: str = "meta") -> GraphChain:
    """Open ``base + deltas`` as one :class:`GraphChain` (paths or
    already-opened objects, in stacking order).  With no deltas the
    chain is the base view itself — same ``content_hash``, so an engine
    built from it shares caches with one built from the base artifact."""
    if isinstance(base, (str, Path)):
        base = open_artifact(base, verify=verify)
    opened = tuple(
        open_delta(d, verify=verify) if isinstance(d, (str, Path)) else d
        for d in deltas)
    return GraphChain(base, opened)


def compact_chain(chain: GraphChain, path: str | Path,
                  overwrite: bool = False) -> GraphArtifact:
    """Fold a chain into a fresh base artifact.

    The merged graph/index/labels/names are written through the ordinary
    :func:`write_artifact` path, so the result is **bit-identical to
    re-ingesting the union** — including ``content_hash``, because the
    manifest ``stats`` block (where the chain provenance is recorded) is
    excluded from the hash by design.
    """
    graph = chain.graph()
    stats = {
        "source": f"compact:{chain.base.path}",
        "compacted_from_chain": chain.content_hash,
        "chain_depth": chain.depth,
        "n_deltas": len(chain.deltas),
        "edges_directed": int(chain.n_edges_directed),
        "n_nodes": int(chain.n_nodes),
    }
    names = chain.entity_names() if chain.has_names else None
    return write_artifact(path, graph, chain.index(), tau=chain.tau,
                          stats=stats, labels=graph.labels, names=names,
                          overwrite=overwrite)
