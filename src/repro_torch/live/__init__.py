"""repro_torch.live — live graphs: continuous ingest + zero-downtime serving.

A production relationship-query service cannot take the graph offline:
source dumps stream edits continuously, yet a classic deployment makes
any change a full re-ingest plus a service restart.  This subsystem
closes that gap on top of the delta substrate in :mod:`repro_torch.store`:

    live directory (one graph's whole live state, on disk)
        live/
          CHAIN.json        base + stacked deltas + consumed fragments
                            (rewritten atomically on every change)
          base-000000/      GraphArtifact (entity-name table persisted)
          delta-000001/     DeltaArtifact stacking on the base hash
          delta-000002/     … stacking on the chain above it

    watch loop (tail a fragment directory into deltas)
        live = LiveDir.initialize("live", ingest_ntriples("dump.nt"))
        watcher = GraphWatcher(live, "incoming/", on_delta=swapper.on_delta)
        watcher.start()        # every new .nt/.tsv fragment becomes a
                               # delta, published atomically

    hot swap (zero-downtime engine replacement)
        svc = DKSService(QueryEngine.build(artifact=live.chain()))
        swapper = EngineSwapper(svc)
        swapper.wire_metrics()
        # on_delta: build + warm the successor engine off the dispatcher
        # thread (pre-compiling the hot (m, k, lanes) buckets ServeStats
        # recorded), then atomically set_engine it into the service.

In-flight requests finish on their admitting build (the engine snapshot
at admission plus version-keyed shape keys make cross-build dispatch
impossible); post-swap requests see the new chained-hash version.  Swap
progress is traced (``dks.swap`` spans: build / warm / swap) and
metered (``dks_engine_swaps_total``, ``dks_delta_applied_total``,
``dks_graph_staleness_seconds``).

Public API:
  LiveDir      — the on-disk live-graph state (base + deltas + bookkeeping).
  GraphWatcher — poll a fragment directory into published deltas.
  EngineSwapper — build/warm/swap successor engines into a DKSService.
"""

from repro_torch.live.state import LiveDir  # noqa: F401
from repro_torch.live.swap import EngineSwapper  # noqa: F401
from repro_torch.live.watch import GraphWatcher  # noqa: F401
