"""Streaming ingestion: LOD dumps -> (Graph, InvertedIndex) in bounded
memory.

A copy of ``repro.store.ingest``: the same input gives the same entity ids,
names, labels and predicate table.

The paper's experiments run on real RDF dumps (sec-rdfabout: 460k nodes;
bluk-bnb: 16.1M nodes / 46.6M edges) — graphs that arrive as text, not as
numpy arrays.  This module turns such dumps into the host objects
:mod:`repro_torch.store.artifact` persists:

- **readers** for N-Triples (``<s> <p> <o> .``, with an optional numeric
  4th term read as a per-statement confidence) and TSV edge lists
  (``src dst [pred] [conf]``), both line-streamed (``.gz`` transparently
  supported) — nothing holds the raw text;
- **dictionary encoding**: entity and predicate strings become dense int32
  ids the moment they are seen; node label text (a URI's local name, a
  literal's text) feeds the inverted index at finalization; the predicate
  dictionary survives into the graph (``pred_names``) and the artifact
  manifest, so artifacts are self-describing;
- **typed channel**: every accumulated edge carries ``(pred_id, conf)``
  next to its endpoints; untyped sources leave the channel dormant
  (``pred=-1, conf=1.0``) and finalize to a plain single-weight graph —
  byte-identical to the pre-typed pipeline;
- **chunked edge accumulation**: edges land in fixed-size int32 chunks
  (optionally spilled to ``.npy`` files under ``spill_dir`` once
  ``spill_after`` chunks are resident), so raw text never accumulates and
  the working set *during accumulation* is the dictionary + labels + one
  chunk.  Finalization still materializes the full int32 edge array
  (O(E) — spilled chunks are streamed into a single preallocated buffer,
  so there is no transient second copy; fully out-of-core finalize is
  future work);
- **finalization** emits the paper's degree-derived edge weights
  (``w = max(1, int(log10 d_in))``, INF above the hub cutoff ``tau`` —
  :func:`repro_torch.graph.structure.degree_weights`) and the symmetrized CSR
  via :func:`repro_torch.graph.structure.build_graph`.

``from_graph`` wraps an already-materialized synthetic graph in the same
:class:`IngestResult` envelope, with honest counts (``edges_requested`` vs
produced — the generator-side contract the fixed ``rmat_edges`` upholds).
"""

from __future__ import annotations

import dataclasses
import gzip
import re
import time
from pathlib import Path
from typing import Any, Iterable, Iterator

import numpy as np

from repro_torch.graph.index import InvertedIndex
from repro_torch.graph.structure import Graph, build_graph

_CHUNK_EDGES = 1 << 20


@dataclasses.dataclass
class IngestStats:
    """True counts out of an ingestion run (recorded in the artifact
    manifest, so an artifact documents what its source actually held)."""

    source: str
    lines_read: int = 0
    statements: int = 0           # parsed edge rows / triples
    malformed_lines: int = 0
    self_loops_dropped: int = 0
    edges_requested: int | None = None   # synthetic sources only
    edges_directed: int = 0
    n_nodes: int = 0
    n_predicates: int = 0
    chunks: int = 0
    spilled_chunks: int = 0
    ingest_s: float = 0.0

    @property
    def edges_per_s(self) -> float:
        return self.edges_directed / self.ingest_s if self.ingest_s else 0.0

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["edges_per_s"] = round(self.edges_per_s, 1)
        return d


@dataclasses.dataclass
class IngestResult:
    """What an ingestion run hands to :func:`repro_torch.store.write_artifact`.

    ``names`` is the entity dictionary in id order (full URIs / raw TSV
    endpoint strings) — present for reader-based ingests, ``None`` for
    synthetic ``from_graph`` sources.  Persisting it (``write_artifact``'s
    ``names=``) is what makes the artifact a valid delta base."""

    graph: Graph
    index: InvertedIndex
    stats: IngestStats
    tau: int
    names: list[str] | None = None


class StreamIngestor:
    """Dictionary-encoding edge accumulator with bounded-memory chunks.

    Feed ``add_edge(src_name, dst_name)`` (strings — encoded to dense
    int32 ids on first sight) or ``add_edge_ids`` for pre-encoded ids,
    then :meth:`finalize`.  Node labels default to the entity's display
    text (see the readers); ``finalize`` builds the inverted index from
    them unless the caller supplies token labels itself.
    """

    def __init__(self, *, chunk_edges: int = _CHUNK_EDGES,
                 spill_dir: str | Path | None = None,
                 spill_after: int = 4) -> None:
        if chunk_edges < 1:
            raise ValueError("chunk_edges must be >= 1")
        self.chunk_edges = int(chunk_edges)
        self.spill_dir = Path(spill_dir) if spill_dir is not None else None
        self.spill_after = int(spill_after)
        self._ids: dict[str, int] = {}
        self._pred_ids: dict[str, int] = {}
        self._labels: list[str] = []
        # [4, n] int32 chunks: src, dst, pred_id, conf (float32 bits).
        self._chunks: list[np.ndarray | Path] = []
        self._cur = np.empty((4, self.chunk_edges), np.int32)
        self._fill = 0
        self._n_spilled = 0
        self._self_loops = 0
        self._n_edges = 0
        self._typed = False

    # -- encoding ------------------------------------------------------

    def entity_id(self, name: str, label: str | None = None) -> int:
        """Dense id for an entity string (assigned on first sight).
        ``label``: display/keyword text for the node (defaults to
        ``name``)."""
        nid = self._ids.get(name)
        if nid is None:
            nid = len(self._ids)
            self._ids[name] = nid
            self._labels.append(name if label is None else label)
        return nid

    def predicate_id(self, name: str) -> int:
        """Dense id for a predicate string (assigned on first sight).
        Registering any predicate makes the ingest *typed*: finalize will
        attach the ``(pred, conf)`` channel to the graph."""
        pid = self._pred_ids.get(name)
        if pid is None:
            pid = len(self._pred_ids)
            self._pred_ids[name] = pid
            self._typed = True
        return pid

    @property
    def n_nodes(self) -> int:
        return len(self._ids)

    @property
    def n_edges(self) -> int:
        return self._n_edges

    @property
    def n_predicates(self) -> int:
        return len(self._pred_ids)

    @property
    def pred_names(self) -> list[str]:
        return list(self._pred_ids)

    @property
    def entity_names(self) -> list[str]:
        """The entity dictionary keys in id order (materializes O(V))."""
        return list(self._ids)

    @property
    def node_labels(self) -> list[str]:
        """Display/keyword text per node, id order (materializes O(V))."""
        return list(self._labels)

    # -- accumulation --------------------------------------------------

    def add_edge(self, src: str, dst: str,
                 src_label: str | None = None,
                 dst_label: str | None = None,
                 pred: str | None = None,
                 conf: float = 1.0) -> None:
        self.add_edge_ids(self.entity_id(src, src_label),
                          self.entity_id(dst, dst_label),
                          pred=-1 if pred is None else self.predicate_id(pred),
                          conf=conf)

    def add_edge_ids(self, src: int, dst: int,
                     pred: int = -1, conf: float = 1.0) -> None:
        if src == dst:
            # Self-loops contribute nothing to answer trees (build_graph
            # drops them anyway); reject at the door and count honestly.
            self._self_loops += 1
            return
        if pred >= 0 or conf != 1.0:
            self._typed = True
        self._cur[0, self._fill] = src
        self._cur[1, self._fill] = dst
        self._cur[2, self._fill] = pred
        self._cur[3, self._fill] = np.float32(conf).view(np.int32)
        self._fill += 1
        self._n_edges += 1
        if self._fill == self.chunk_edges:
            self._flush()

    def _flush(self) -> None:
        if self._fill == 0:
            return
        chunk = self._cur[:, : self._fill].copy()
        self._fill = 0
        resident = sum(1 for c in self._chunks if isinstance(c, np.ndarray))
        if self.spill_dir is not None and resident >= self.spill_after:
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            path = self.spill_dir / f"chunk-{len(self._chunks):06d}.npy"
            np.save(path, chunk)
            self._chunks.append(path)
            self._n_spilled += 1
        else:
            self._chunks.append(chunk)

    def _edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Stream every chunk (resident or spilled) into preallocated
        arrays — peak = the final O(E) buffers + one chunk, with no
        transient concatenate copy.  Returns ``(src, dst, pred, conf)``;
        the typed rows are dormant (-1 / 1.0) for untyped ingests."""
        self._flush()
        src = np.empty(self._n_edges, np.int32)
        dst = np.empty(self._n_edges, np.int32)
        pred = np.empty(self._n_edges, np.int32)
        conf_bits = np.empty(self._n_edges, np.int32)
        pos = 0
        for c in self._chunks:
            arr = c if isinstance(c, np.ndarray) else \
                np.load(c, mmap_mode="r")
            n = arr.shape[1]
            src[pos:pos + n] = arr[0]
            dst[pos:pos + n] = arr[1]
            pred[pos:pos + n] = arr[2]
            conf_bits[pos:pos + n] = arr[3]
            pos += n
        assert pos == self._n_edges
        return src, dst, pred, conf_bits.view(np.float32)

    def edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Materialize the accumulated directed edges as
        ``(src, dst, pred, conf)`` without finalizing — the delta writer's
        access path (O(E); predicate ids stay raw: -1 = untyped)."""
        return self._edges()

    # -- finalization --------------------------------------------------

    def finalize(self, stats: IngestStats, *, tau: int = 1001,
                 index: InvertedIndex | None = None,
                 tokens: np.ndarray | None = None) -> IngestResult:
        """Symmetrize + CSR + degree weights + inverted index.

        The paper's edge-weight model is applied here, over the *final*
        in-degrees (weights depend on global degree counts, so they can
        only be emitted at finalization).  ``index``/``tokens`` override
        the default labels-derived index (synthetic token matrices).

        Typed ingests (any registered predicate or non-unit confidence)
        attach the ``(pred, conf)`` channel and the predicate dictionary
        to the graph; edges that arrived without a predicate are filed
        under a synthetic ``"(untyped)"`` entry so the channel is total.
        """
        src, dst, pred, conf = self._edges()
        labels = list(self._labels) if self._labels else None
        t0 = time.perf_counter()
        if self._typed:
            if len(pred) and (pred < 0).any():
                pred = np.where(pred < 0,
                                np.int32(self.predicate_id("(untyped)")),
                                pred)
            graph = build_graph(src, dst, max(self.n_nodes, 1),
                                labels=labels, tau=tau,
                                pred=pred, conf=conf,
                                pred_names=self.pred_names)
            stats.n_predicates = self.n_predicates
        else:
            graph = build_graph(src, dst, max(self.n_nodes, 1),
                                labels=labels, tau=tau)
        if index is None:
            if tokens is not None:
                index = InvertedIndex.from_token_matrix(np.asarray(tokens))
            elif labels is not None:
                index = InvertedIndex.from_labels(labels)
            elif self.n_nodes == 0:
                index = InvertedIndex()   # empty source, empty index
            else:
                raise ValueError(
                    "finalize needs labels, tokens=, or index= to build "
                    "the inverted index")
        stats.edges_directed = int(len(src))
        stats.self_loops_dropped += self._self_loops
        stats.n_nodes = graph.n_nodes
        stats.chunks = len(self._chunks)
        stats.spilled_chunks = self._n_spilled
        stats.ingest_s += time.perf_counter() - t0
        return IngestResult(graph=graph, index=index, stats=stats, tau=tau,
                            names=self.entity_names if self._ids else None)


# ----------------------------------------------------------------------
# Text readers
# ----------------------------------------------------------------------


def _open_text(path: str | Path):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "rt", encoding="utf-8", errors="replace")


_LOCAL = re.compile(r"[/#]")
_WORDISH = re.compile(r"[_\-.:]+")


def display_text(term: str) -> str:
    """Keyword text for an RDF term: a URI's local name (after the last
    ``/`` or ``#``, separators spaced), a literal's lexical form, a blank
    node's id.  This is what the inverted index tokenizes."""
    if term.startswith("<") and term.endswith(">"):
        local = _LOCAL.split(term[1:-1])[-1] or term[1:-1]
        return _WORDISH.sub(" ", local).strip() or local
    if term.startswith('"'):
        end = term.rfind('"')
        text = term[1:end] if end > 0 else term.strip('"')
        return text.replace('\\"', '"').replace("\\\\", "\\")
    return term


def _nt_terms(line: str) -> list[str] | None:
    """Parse one N-Triples statement into raw terms: ``[s, p, o]`` or
    ``[s, p, o, x]`` when a 4th term precedes the final ``.`` (an
    N-Quads-style annotation — our readers interpret a *numeric* 4th term
    as the statement's confidence).  Handles ``<uri>``, ``_:bnode``, and
    quoted literals with escapes / ``@lang`` / ``^^<datatype>`` suffixes.
    Returns None for a line that isn't a statement."""
    terms = []
    i, n = 0, len(line)
    while i < n and len(terms) < 4:
        while i < n and line[i] in " \t":
            i += 1
        if i >= n:
            break
        ch = line[i]
        if ch == "<":
            j = line.find(">", i + 1)
            if j < 0:
                return None
            terms.append(line[i:j + 1])
            i = j + 1
        elif ch == '"':
            j = i + 1
            while j < n:
                if line[j] == "\\":
                    j += 2
                    continue
                if line[j] == '"':
                    break
                j += 1
            if j >= n:
                return None
            # Swallow @lang / ^^<datatype> up to the next whitespace.
            k = j + 1
            while k < n and line[k] not in " \t":
                k += 1
            terms.append(line[i:k])
            i = k
        elif ch == ".":
            break
        else:  # blank node or bare token
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            terms.append(line[i:j])
            i = j
    if len(terms) not in (3, 4):
        return None
    s, p, o = terms[:3]
    # N-Triples grammar: subject is a URI or blank node, predicate a URI,
    # object any term — reject bare-word lines instead of inventing nodes.
    if not (s.startswith("<") or s.startswith("_:")):
        return None
    if not p.startswith("<"):
        return None
    if not (o.startswith("<") or o.startswith("_:") or o.startswith('"')):
        return None
    return terms


def _term_confidence(term: str) -> float | None:
    """A 4th statement term read as a confidence: a bare number or a
    numeric literal (``"0.9"``, ``"0.9"^^<xsd:double>``); anything else
    (e.g. an N-Quads graph label) is None — ignored, not an error."""
    try:
        c = float(display_text(term))
    except (TypeError, ValueError):
        return None
    return c if c > 0 else None


def feed_nt_line(ing: StreamIngestor, line: str) -> bool:
    """Parse + accumulate one stripped N-Triples statement line.

    Returns False for a malformed line (nothing accumulated).  This is
    the ONE statement→edge mapping shared by the bulk reader and the
    delta builder, so a fragment appended as a delta and the same lines
    in a full re-ingest produce identical dictionary growth, labels, and
    edge rows."""
    terms = _nt_terms(line)
    if terms is None:
        return False
    s, p, o = terms[:3]
    conf = _term_confidence(terms[3]) if len(terms) == 4 else None
    ing.add_edge(s, o, display_text(s), display_text(o),
                 pred=display_text(p),
                 conf=1.0 if conf is None else conf)
    return True


def feed_tsv_line(ing: StreamIngestor, line: str) -> bool:
    """Parse + accumulate one stripped TSV edge row (see
    :func:`ingest_tsv` for the column convention).  Returns False for a
    malformed line.  Shared by the bulk reader and the delta builder."""
    cols = line.split("\t") if "\t" in line else line.split()
    if len(cols) < 2 or not cols[0] or not cols[1]:
        return False
    pred, conf = None, None
    if len(cols) >= 3 and cols[2].strip():
        conf = _term_confidence(cols[2].strip())
        if conf is None:
            pred = cols[2].strip()
            if len(cols) >= 4 and cols[3].strip():
                conf = _term_confidence(cols[3].strip())
    ing.add_edge(cols[0].strip(), cols[1].strip(),
                 pred=pred, conf=1.0 if conf is None else conf)
    return True


def ingest_ntriples(
    path: str | Path,
    *,
    tau: int = 1001,
    chunk_edges: int = _CHUNK_EDGES,
    spill_dir: str | Path | None = None,
    on_error: str = "skip",
) -> IngestResult:
    """Stream an N-Triples dump into ``(graph, index, stats)``.

    Every distinct subject/object term becomes a node (dictionary-encoded
    int32); every statement's predicate becomes the edge's type — the
    predicate dictionary keys on :func:`display_text` of the predicate URI
    (the name the CLI filter flags accept; URIs sharing a local name share
    an id).  A numeric 4th term (N-Quads-style annotation) is read as the
    statement's confidence; a non-numeric one is ignored.  Node keyword
    text is the term's :func:`display_text`.  ``on_error``: ``"skip"``
    counts malformed lines in the stats, ``"raise"`` fails fast.
    """
    if on_error not in ("skip", "raise"):
        raise ValueError(f"unknown on_error={on_error!r}")
    stats = IngestStats(source=f"ntriples:{path}")
    ing = StreamIngestor(chunk_edges=chunk_edges, spill_dir=spill_dir)
    t0 = time.perf_counter()
    with _open_text(path) as f:
        for line in f:
            stats.lines_read += 1
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not feed_nt_line(ing, line):
                if on_error == "raise":
                    raise ValueError(
                        f"malformed N-Triples line {stats.lines_read} "
                        f"in {path}: {line[:120]!r}")
                stats.malformed_lines += 1
                continue
            stats.statements += 1
    stats.n_predicates = ing.n_predicates
    stats.ingest_s = time.perf_counter() - t0
    return ing.finalize(stats, tau=tau)


def ingest_tsv(
    path: str | Path,
    *,
    tau: int = 1001,
    chunk_edges: int = _CHUNK_EDGES,
    spill_dir: str | Path | None = None,
    on_error: str = "skip",
) -> IngestResult:
    """Stream a TSV/whitespace edge list (``src<TAB>dst[<TAB>pred][<TAB>conf]``
    per line; ``#`` comments skipped).  Endpoint strings are
    dictionary-encoded and double as the node keyword text.  A numeric
    3rd column is read as the edge's confidence; a non-numeric one as its
    predicate name (then a numeric 4th column is the confidence); columns
    past those are ignored."""
    if on_error not in ("skip", "raise"):
        raise ValueError(f"unknown on_error={on_error!r}")
    stats = IngestStats(source=f"tsv:{path}")
    ing = StreamIngestor(chunk_edges=chunk_edges, spill_dir=spill_dir)
    t0 = time.perf_counter()
    with _open_text(path) as f:
        for line in f:
            stats.lines_read += 1
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not feed_tsv_line(ing, line):
                if on_error == "raise":
                    raise ValueError(
                        f"malformed TSV line {stats.lines_read} in {path}: "
                        f"{line[:120]!r}")
                stats.malformed_lines += 1
                continue
            stats.statements += 1
    stats.n_predicates = ing.n_predicates
    stats.ingest_s = time.perf_counter() - t0
    return ing.finalize(stats, tau=tau)


def from_graph(
    graph: Graph,
    *,
    tokens: np.ndarray | None = None,
    index: InvertedIndex | None = None,
    tau: int = 1001,
    edges_requested: int | None = None,
    source: str = "graph",
) -> IngestResult:
    """Wrap an in-memory (synthetic) graph in the ingestion envelope.

    ``edges_requested`` lets generator callers record the asked-for edge
    count next to the true one (``stats.edges_directed``) — the honesty
    knob for generators that may drop slots."""
    if index is None:
        if tokens is not None:
            index = InvertedIndex.from_token_matrix(np.asarray(tokens))
        elif graph.labels is not None:
            index = InvertedIndex.from_labels(graph.labels)
        else:
            raise ValueError("from_graph needs tokens=, index=, or "
                             "graph.labels")
    stats = IngestStats(
        source=source,
        statements=graph.n_edges_directed,
        edges_requested=edges_requested,
        edges_directed=graph.n_edges_directed,
        n_nodes=graph.n_nodes,
    )
    return IngestResult(graph=graph, index=index, stats=stats, tau=tau)


def write_tsv(path: str | Path, src: Iterable[int], dst: Iterable[int],
              name: str = "n",
              pred: Iterable[str] | None = None,
              conf: Iterable[float] | None = None) -> int:
    """Dump an edge list as a TSV file (benchmark/test helper for the
    streaming reader; entity names are ``{name}{id}``).  Optional
    ``pred``/``conf`` columns produce a typed edge list the reader's
    3rd/4th-column convention picks up.  Returns the number of lines
    written."""
    n = 0
    preds = list(pred) if pred is not None else None
    confs = list(conf) if conf is not None else None
    with open(path, "w", encoding="utf-8") as f:
        for i, (s, d) in enumerate(zip(src, dst)):
            row = f"{name}{int(s)}\t{name}{int(d)}"
            if preds is not None:
                row += f"\t{preds[i]}"
            if confs is not None:
                row += f"\t{float(confs[i]):g}"
            f.write(row + "\n")
            n += 1
    return n


def iter_lines(path: str | Path) -> Iterator[str]:
    """Line iterator with transparent .gz handling (exposed for tools)."""
    with _open_text(path) as f:
        yield from f
