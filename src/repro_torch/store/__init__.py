"""repro_torch.store — graph store & ingestion: stream LOD dumps into versioned
on-disk artifacts, mmap-load them into the engine.

The paper's workloads are real RDF dumps; an engine that re-generates and
re-packs its graph on every process start cannot serve them.  This
subsystem splits the lifecycle:

    ingest (once, streaming, bounded memory)
        result = ingest_ntriples("dump.nt.gz")          # or ingest_tsv,
        # or from_graph(g, tokens=...) for synthetic graphs
        art = write_artifact("artifacts/dump", result.graph, result.index,
                             tau=result.tau, stats=result.stats.as_dict())

    open (every serve start, milliseconds)
        art = open_artifact("artifacts/dump")           # mmap, zero-copy
        engine = QueryEngine.build(artifact=art)        # no re-tokenizing

Artifacts are versioned (format_version + magic), checksummed (sha256 per
buffer, ``verify="full"`` re-checks), written atomically, and carry a
``content_hash`` that :class:`~repro_torch.engine.QueryEngine` folds into its
``version``/``cache_token`` — a serving result cache can never cross two
different graph builds.

Live graphs stack **delta artifacts** on a base instead of re-ingesting:

    append (seconds, proportional to the fragment)
        b = DeltaBuilder(open_artifact("artifacts/dump"))
        b.add_file("edits-0042.nt")
        delta = b.write("artifacts/dump-delta-0001")

    open the chain (merged, engine-ready, chained-hash versioned)
        chain = open_chain("artifacts/dump", "artifacts/dump-delta-0001")
        engine = QueryEngine.build(artifact=chain)   # version = chained hash
        compact_chain(chain, "artifacts/dump-v2")    # == union re-ingest,
                                                     # bit-identical

Public API:
  ingest_ntriples / ingest_tsv — streaming readers (dictionary-encoded
                  entities, chunked edge accumulation, degree weights at
                  finalization).
  from_graph    — the synthetic-graph path into the same envelope.
  StreamIngestor / IngestResult / IngestStats — the pieces behind them.
  write_artifact / open_artifact / GraphArtifact — the on-disk format.
  DeltaBuilder / open_delta / DeltaArtifact — edge/node adds stacked on a
                  base ``content_hash`` (repro_torch.store.delta).
  open_chain / GraphChain / compact_chain — merged live view + folding.
  ArtifactError / FormatVersionError / ChecksumError — validation errors.

CLI: ``python -m repro_torch.launch.ingest`` (generate-or-read -> ingest ->
write -> reopen -> verify query parity; ``--smoke`` for CI;
``--live DIR --append frag…`` for delta publication).
"""

from repro_torch.store.artifact import (  # noqa: F401
    FORMAT_VERSION,
    SUPPORTED_VERSIONS,
    ArtifactError,
    ChecksumError,
    FormatVersionError,
    GraphArtifact,
    LazyArtifactIndex,
    open_artifact,
    write_artifact,
)
from repro_torch.store.delta import (  # noqa: F401
    DELTA_FORMAT_VERSION,
    ChainIndex,
    DeltaArtifact,
    DeltaBuilder,
    GraphChain,
    chained_hash,
    compact_chain,
    open_chain,
    open_delta,
)
from repro_torch.store.ingest import (  # noqa: F401
    IngestResult,
    IngestStats,
    StreamIngestor,
    from_graph,
    ingest_ntriples,
    ingest_tsv,
    write_tsv,
)
