"""DKS serving CLI: load-replay a synthetic request trace against
:class:`repro_torch.serve.DKSService` with concurrent closed-loop clients,
print the :class:`ServeStats` report and verify every served answer against
the direct single-query engine — the port of ``repro.launch.serve_dks``:

    python -m repro_torch.launch.serve_dks --dataset sec-rdfabout \\
        --backend cuda --clients 8 --requests 32 --max-batch 8

``--device`` defaults to the card; on the CPU::

    python -m repro_torch.launch.serve_dks --smoke \\
        --dataset sec-rdfabout-cpu --backend torch --device cpu

``--partition sharded`` serves the frontier-compressed sharded partition
(``--backend`` then defaults to ``torch``, its only backend).

``--smoke`` shrinks the run and *asserts* the serving invariants: mean
batch-fill > 1 (the micro-batcher coalesced concurrent clients), warm
reuse > 0 (cache hits or single-flight), at least one multi-lane deadline
bucket (same-budget requests rode one stepwise lane driver), every served
answer equal to the direct engine's (or ``approximate=True`` with a valid
sound lower bound), answer trees servable end to end (a
``return_trees=True`` query yields >= k distinct keyword-covering trees
and an identical follow-up is served warm from the tree-pool cache), and
its own ``/metrics`` scraped over HTTP (ephemeral port) with the counters
equal to ``ServeStats``.

``--artifact PATH`` serves a graph-store artifact (its content hash keys
the result cache).  ``--live DIR`` serves the delta chain of a
:class:`repro_torch.live.LiveDir` (engine version = the chained hash);
``--watch WATCH_DIR`` also tails a fragment directory for the duration of
the replay, hot-swapping the engine on every published delta.
``--swap-mid-run`` appends the swap-under-load leg (:func:`swap_smoke`):
open-ended client load over a live ring graph, a fragment dropped
mid-run, and hard asserts that no request fails, no request sees a
half-swapped graph, post-swap requests see the chained version, traces
stay complete and the swap counters land on ``/metrics``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

from repro_torch.configs import DKS_CONFIGS
from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.launch.dks_query import (add_partition_args,
                                          add_weight_policy_args,
                                          build_engine, describe_partition,
                                          resolve_backend,
                                          weight_policy_from_args)
from repro_torch.obs import MetricsServer, parse_prometheus
from repro_torch.serve import DKSService, ServeConfig
from repro_torch.serve.loadgen import latency_split, make_trace, replay


def verify_served(engine, trace, served):
    """Check every served answer against the direct engine.

    Exact results must equal the single-query weights bit for bit (the
    lane driver and the 1-lane driver compute the same lattice values);
    approximate (deadline-terminated) results must bracket the optimum:
    ``sound_opt_lower_bound <= optimum <= best-so-far``.  Returns
    (n_exact, n_approx); raises AssertionError on any mismatch.
    """
    refs: dict = {}
    n_exact = n_approx = 0
    for req, srv in zip(trace, served):
        key = (req.keywords, req.k)
        if key not in refs:
            refs[key] = engine.query(list(req.keywords), k=req.k,
                                     extract=False)
        ref = refs[key]
        if srv.approximate:
            n_approx += 1
            assert srv.opt_lower_bound is not None, \
                "approximate result without a lower bound"
            assert srv.sound_opt_lower_bound is not None, \
                "approximate result without a sound lower bound"
            assert srv.sound_opt_lower_bound <= ref.best_weight, (
                f"invalid sound bound for {req.keywords}: "
                f"{srv.sound_opt_lower_bound} > optimum {ref.best_weight}")
            assert srv.result.weights[0] >= ref.weights[0], (
                f"best-so-far beats the optimum for {req.keywords}")
        else:
            n_exact += 1
            np.testing.assert_array_equal(
                srv.result.weights, ref.weights,
                err_msg=f"served weights diverged for {req.keywords}")
    return n_exact, n_approx


def tree_key(t):
    return (t.root, tuple(sorted((e.u, e.v) for e in t.edges)))


def verify_trees(svc, engine, trace, k=2, timeout=None):
    """Served answer trees (``return_trees=True``): on the first unique
    trace query whose table holds >= k distinct trees, the page carries
    >= k distinct trees, each covering every query keyword, with a label
    per node, and an identical follow-up is served warm from the
    tree-pool cache with the same page.  Returns (keywords, n_distinct)."""
    index = engine.index
    seen: set = set()
    for req in trace:
        if req.keywords in seen:
            continue
        seen.add(req.keywords)
        srv = svc.query(list(req.keywords), k=k, return_trees=True,
                        tree_page_size=k, timeout=timeout)
        page = srv.trees
        assert page is not None, "return_trees request served no TreePage"
        if page.total < k:
            continue  # thin table for this query; try the next one
        keys = {tree_key(t) for t in page.items}
        assert len(keys) >= k, (
            f"served page for {req.keywords} repeats trees: "
            f"{len(keys)} distinct keys < k={k}")
        for t in page.items:
            nodes = set(t.nodes)
            for tok in req.keywords:
                hits = set(int(v) for v in index.lookup(tok))
                assert nodes & hits, (
                    f"tree rooted at {t.root} does not cover keyword "
                    f"{tok!r} for query {req.keywords}")
            assert len(t.node_labels) == len(t.nodes), (
                "tree served without a label per node")
        before = svc.stats().tree_cache_hits
        warm = svc.query(list(req.keywords), k=k, return_trees=True,
                         tree_page_size=k, timeout=timeout)
        assert warm.cache_hit, "identical tree request missed the cache"
        assert svc.stats().tree_cache_hits > before, (
            "warm tree request re-extracted instead of hitting the "
            "tree-pool cache")
        assert {tree_key(t) for t in warm.trees.items} == keys, \
            "warm tree page diverged from cold page"
        return req.keywords, len(keys)
    raise AssertionError(
        f"no unique trace query yielded k={k} distinct answer trees")


def verify_metrics_scrape(svc, server):
    """Scrape ``/healthz``, ``/metrics`` and ``/traces`` over HTTP: the
    exposition parses, the serving counters equal the (idle) service's
    ``ServeStats``, dispatch counters are nonzero, and recent traces
    carry the dispatch spans.  Returns the parsed samples."""
    with urllib.request.urlopen(f"{server.url}/healthz", timeout=10) as r:
        assert r.read().decode().strip() == "ok", "healthz not ok"
    with urllib.request.urlopen(f"{server.url}/metrics", timeout=10) as r:
        text = r.read().decode()
    samples = parse_prometheus(text)  # malformed exposition raises
    stats = svc.stats()
    for name, want in [
            ("dks_requests_total", stats.requests),
            ("dks_batch_dispatches_total", stats.batch_dispatches),
            ("dks_deadline_dispatches_total", stats.deadline_dispatches),
            ("dks_cache_hits_total", stats.cache_hits),
            ("dks_single_flight_hits_total", stats.single_flight_hits)]:
        assert samples.get(name) == want, (
            f"/metrics {name}={samples.get(name)} != stats {want}")
    assert samples["dks_requests_total"] > 0, "no requests on /metrics"
    assert samples["dks_batch_dispatches_total"] > 0, (
        "no batch dispatches on /metrics")
    assert samples["dks_engine_execute_count_total"] > 0, (
        "engine execute counter never moved")
    assert samples["dks_request_latency_ms_count"] == stats.requests, (
        "latency histogram count diverged from requests")
    reasons = sum(samples[f"dks_dispatch_reason_{r}_total"]
                  for r in ("full", "window", "flush"))
    assert reasons == stats.batch_dispatches + stats.deadline_dispatches, (
        f"dispatch reasons {reasons} != total dispatches")
    with urllib.request.urlopen(f"{server.url}/traces?n=16",
                                timeout=10) as r:
        lines = [json.loads(ln) for ln in
                 r.read().decode().splitlines() if ln]
    assert lines, "no finished traces on /traces"
    span_names = {sp["name"] for tr in lines for sp in tr["spans"]}
    for want in ("admit", "queue_wait", "coalesce", "device_dispatch"):
        assert want in span_names, (
            f"span {want!r} missing from recent traces: {span_names}")
    return samples


def serve_replay(engine, trace, cfg: ServeConfig, *, clients: int,
                 smoke: bool, k: int = 1, metrics_port: int | None = None,
                 timeout: float | None = None, watch=None) -> dict:
    """Replay ``trace`` through a :class:`DKSService` over ``engine`` with
    ``clients`` closed-loop clients; under ``smoke`` also serve trees and
    scrape ``/metrics`` (ephemeral port unless one is given).  ``watch``:
    a ``(LiveDir, watch directory)`` pair whose fragments are hot-swapped
    into the service while it runs.  Returns the served results, the
    stats, the tree check, the scrape and the wall time; ``replay_s`` and
    ``replay_stats`` are the replay's own time and a stats snapshot taken
    as it returns (before the tree and scrape checks).  The service is
    stopped on return."""
    if smoke and metrics_port is None:
        metrics_port = 0
    out: dict = {"tree_check": None, "scraped": None}
    t0 = time.perf_counter()
    with DKSService(engine, cfg) as svc:
        server = watcher = None
        if watch is not None:
            from repro_torch.live import EngineSwapper, GraphWatcher
            swapper = EngineSwapper(svc)
            swapper.wire_metrics()
            watcher = GraphWatcher(*watch,
                                   on_delta=swapper.on_delta).start()
            print(f"watching {watch[1]} for fragments (hot swap on every "
                  f"delta)")
        if metrics_port is not None:
            server = MetricsServer(svc.registry, tracer=svc.tracer,
                                   port=metrics_port).start()
            print(f"metrics: {server.url}/metrics")
        try:
            t_replay = time.perf_counter()
            out["served"] = replay(svc, trace, n_clients=clients,
                                   timeout=timeout)
            out["replay_s"] = time.perf_counter() - t_replay
            out["replay_stats"] = svc.stats()
            if smoke:
                out["tree_check"] = verify_trees(
                    svc, engine, trace, k=max(2, k), timeout=timeout)
                out["scraped"] = verify_metrics_scrape(svc, server)
            out["stats"] = svc.stats()
        finally:
            if server is not None:
                server.stop()
            if watcher is not None:
                watcher.stop()
    out["wall_s"] = time.perf_counter() - t0
    return out


def check_smoke(stats, tree_check, deadline_frac: float) -> str:
    """Assert the smoke's serving invariants on a replay's ServeStats;
    returns the one-line summary."""
    assert stats.mean_batch_fill > 1.0, (
        f"no coalescing: mean batch-fill {stats.mean_batch_fill}")
    warm = stats.cache_hits + stats.single_flight_hits
    assert warm > 0, "repeated queries neither hit the cache nor " \
        "attached to an in-flight run"
    if deadline_frac > 0:
        # Same-budget deadline bursts must have ridden a shared lane
        # driver: mean fill > 1 implies a multi-lane deadline bucket.
        assert stats.deadline_dispatches > 0, "no deadline dispatches"
        assert stats.mean_deadline_fill > 1.0, (
            f"deadline requests never coalesced: fill "
            f"{stats.mean_deadline_fill} over "
            f"{stats.deadline_dispatches} dispatches")
        assert stats.deadline_driver_supersteps <= \
            stats.deadline_lane_supersteps, "driver stepped more " \
            "than its lanes billed — freeze accounting is broken"
    assert stats.tree_requests > 0, "smoke never requested trees"
    assert stats.tree_cache_hits > 0, \
        "warm tree request missed the tree-pool cache"
    kw, n_keys = tree_check
    return ("smoke invariants hold: batch-fill > 1, "
            f"warm reuse > 0 ({stats.cache_hits} cache hits + "
            f"{stats.single_flight_hits} single-flight), "
            f"deadline fill {stats.mean_deadline_fill:.2f} over "
            f"{stats.deadline_dispatches} shared drivers "
            f"({stats.deadline_driver_supersteps} driver vs "
            f"{stats.deadline_lane_supersteps} lane supersteps); "
            f"trees: {n_keys} distinct covering trees for {kw}, "
            f"{stats.tree_cache_hits}/{stats.tree_requests} warm")


def wait_for(cond, timeout: float, what: str) -> None:
    """Poll ``cond`` every 20 ms; AssertionError after ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


def swap_smoke(args, timeout: float = 120.0) -> None:
    """The swap-under-load leg: a live ring graph served under open-ended
    client load, one fragment dropped mid-run, one hot swap.

    The ring makes the swap observable in the answers: the probe pair
    sits 8 hops apart (tree weight 8.0) until the delta's shortcut edge
    collapses it to 1.0 — so every served probe weight in {8.0, 1.0}
    shows that no request saw a half-swapped graph, and post-swap probes
    at 1.0 show that the swap landed.  Every wait and join is bounded by
    ``timeout`` seconds.
    """
    from repro_torch.live import EngineSwapper, GraphWatcher, LiveDir
    from repro_torch.store import ingest_tsv

    with tempfile.TemporaryDirectory(prefix="repro-swap-smoke-") as tmp:
        tmp = Path(tmp)
        n, groups = 32, 4
        lines = [f"e{i:03d} g{i % groups}\t"
                 f"e{(i + 1) % n:03d} g{(i + 1) % n % groups}\tknows\t1.0"
                 for i in range(n)]
        base = tmp / "base.tsv"
        base.write_text("\n".join(lines) + "\n")
        live = LiveDir.initialize(tmp / "live", ingest_tsv(base))
        watch_dir = tmp / "incoming"
        watch_dir.mkdir()

        policy = ExecutionPolicy(
            backend=args.backend, partition=args.partition,
            max_supersteps=max(args.max_supersteps, 12),
            weights=weight_policy_from_args(args))
        engine = QueryEngine.build(artifact=live.chain(), policy=policy,
                                   device=args.device)
        old_version = engine.version
        cfg = ServeConfig(max_batch=4, max_wait_ms=10.0, cache_size=64,
                          trace_seed=args.seed)

        probe = ["e000", "e008"]   # 8 hops apart until the shortcut lands
        pool = [probe, ["e004", "g1"], ["e010", "g2"], ["e020", "g3"]]
        probe_weights: list = []
        failures: list = []
        stop = threading.Event()

        def client(i: int) -> None:
            while not stop.is_set():
                q = pool[i % len(pool)]
                try:
                    srv = svc.query(list(q), k=1, timeout=timeout)
                    if q is probe:
                        probe_weights.append(float(srv.result.weights[0]))
                except Exception as exc:
                    failures.append((q, exc))
                    return

        with DKSService(engine, cfg) as svc:
            swapper = EngineSwapper(svc)
            swapper.wire_metrics()
            watcher = GraphWatcher(live, watch_dir, poll_s=0.05,
                                   on_delta=swapper.on_delta).start()
            threads = [threading.Thread(target=client, args=(i,),
                                        daemon=True) for i in range(4)]
            try:
                for t in threads:
                    t.start()
                wait_for(lambda: svc.stats().requests >= 12, timeout,
                         "pre-swap load")
                # Drop the fragment atomically; the watcher publishes the
                # delta and the swapper rebuilds + swaps off the
                # dispatcher.
                frag_tmp = tmp / "frag.tsv.part"
                frag_tmp.write_text("e000 g0\te008 g0\tshortcut\t1.0\n"
                                    "zzz fresh\te000 g0\tmentions\t0.9\n")
                os.replace(frag_tmp, watch_dir / "frag-0001.tsv")
                wait_for(lambda: swapper.swaps >= 1 or watcher.error,
                         timeout, "the hot swap")
                wait_for(lambda: failures or svc.stats().requests >= 24,
                         timeout, "post-swap load")
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout)
                watcher.stop(timeout)
            assert not any(t.is_alive() for t in threads), \
                "a client thread outlived its join"

            assert not failures, f"requests failed across the swap: {failures}"
            chain = live.chain()
            assert chain.depth == 1
            assert svc.engine.version == f"artifact:{chain.content_hash}", \
                "serving engine is not on the chained version"
            assert svc.engine.version != old_version
            assert svc.engine.device == engine.device

            # Post-swap answers: the shortcut collapsed the probe, and the
            # delta-only keyword resolves.
            post = svc.query(list(probe), k=1, timeout=timeout)
            assert float(post.result.weights[0]) == 1.0, \
                f"post-swap probe weight {post.result.weights[0]} != 1.0"
            fresh = svc.query(["fresh", "g0"], k=1, timeout=timeout)
            assert float(fresh.result.weights[0]) == 1.0, \
                f"post-delta keyword probe weight {fresh.result.weights[0]}"
            bad = [w for w in probe_weights if w not in (8.0, 1.0)]
            assert not bad, (
                f"probe weights outside {{8.0, 1.0}}: {sorted(set(bad))} — "
                "a request saw a half-swapped graph")

            stats = svc.stats()
            assert stats.engine_swaps >= 1, stats.engine_swaps
            samples = parse_prometheus(svc.registry.render())
            assert samples["dks_engine_swaps_total"] == stats.engine_swaps
            assert samples["dks_delta_applied_total"] >= 1
            assert samples["dks_graph_staleness_seconds"] == 0.0, \
                "staleness gauge nonzero after the swap landed"

            ts = svc.tracer.stats()
            assert ts["begun"] == ts["finished"], (
                f"trace completeness broke across the swap: {ts}")
            swaps = [t for t in svc.recent_traces() if t.name == "dks.swap"]
            assert swaps, "no dks.swap trace recorded"
            span_names = [sp.name for sp in swaps[-1].spans]
            assert span_names == ["build", "warm", "swap"], span_names
            n_probe = len(probe_weights)
    print(f"swap smoke invariants hold: {stats.requests} requests, 0 "
          f"failures across {stats.engine_swaps} hot swap(s); probe "
          f"weight 8.0 -> 1.0 ({n_probe} probes, no mixed-build "
          f"answers); version {old_version[:21]}… -> "
          f"{svc.engine.version[:21]}…; traces complete "
          f"({ts['begun']} begun == finished), dks.swap spans "
          f"{span_names}; warmed {len(swapper.last_warmed)} hot shapes")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sec-rdfabout-cpu",
                    choices=sorted(DKS_CONFIGS))
    ap.add_argument("--artifact", default=None,
                    help="serve a graph-store artifact (mmap-load; its "
                         "content hash keys the result cache)")
    ap.add_argument("--live", default=None, metavar="DIR",
                    help="serve a LiveDir's delta chain (engine version = "
                         "the chained hash)")
    ap.add_argument("--watch", default=None, metavar="WATCH_DIR",
                    help="with --live: tail this fragment directory during "
                         "the replay, hot-swapping the engine on every "
                         "published delta")
    ap.add_argument("--swap-mid-run", action="store_true",
                    help="append the swap-under-load leg (live ring graph, "
                         "fragment dropped mid-run, hard asserts on zero "
                         "failures and build isolation)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--unique", type=int, default=8,
                    help="distinct queries in the trace (repeats warm the "
                         "cache)")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument("--cache-size", type=int, default=256)
    ap.add_argument("--deadline-frac", type=float, default=0.25,
                    help="fraction of requests carrying a latency budget")
    ap.add_argument("--deadline-ms", type=float, default=75.0)
    ap.add_argument("--max-supersteps", type=int, default=24)
    add_partition_args(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    add_weight_policy_args(ap)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics, /healthz, and "
                         "/traces on this port for the run (0 = "
                         "ephemeral; --smoke scrapes it either way)")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="fraction of requests whose trace records spans "
                         "(deterministic per seed)")
    ap.add_argument("--trace-log", default=None,
                    help="append finished sampled traces to this path as "
                         "JSONL (the structured event log)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the direct-engine parity pass")
    ap.add_argument("--smoke", action="store_true",
                    help="small run + hard asserts on coalescing, cache "
                         "hits, answer parity, trees and the /metrics "
                         "scrape")
    args = ap.parse_args(argv)
    resolve_backend(ap, args)
    if args.watch is not None and args.live is None:
        ap.error("--watch needs --live DIR")

    if args.smoke:
        args.requests = min(args.requests, 20)
        args.unique = min(args.unique, 5)
        args.max_batch = min(args.max_batch, 4)
        args.max_wait_ms = 50.0
        args.max_supersteps = min(args.max_supersteps, 12)

    t0 = time.time()
    policy = ExecutionPolicy(
        backend=args.backend, partition=args.partition,
        max_supersteps=args.max_supersteps,
        weights=weight_policy_from_args(args))
    live = None
    if args.live is not None:
        from repro_torch.live import LiveDir
        live = LiveDir(args.live)
        engine = QueryEngine.build(artifact=live.chain(), policy=policy,
                                   device=args.device)
        source = repr(live)
    else:
        ds, engine = build_engine(args.dataset, policy, device=args.device,
                                  artifact=args.artifact)
        source = args.artifact or ds.name
    print(f"loaded {source}: V={engine.n_nodes:,} E_sym={engine.n_edges:,} "
          f"on {engine.device} ({time.time()-t0:.1f}s)")
    if policy.partition == "sharded":
        print(describe_partition(engine))
    if not policy.weights.is_default:
        print(f"weight policy: {policy.weights}")

    trace = make_trace(
        engine.index, args.requests, unique=args.unique, k=args.k,
        deadline_frac=args.deadline_frac, deadline_ms=args.deadline_ms,
        seed=args.seed)
    cfg = ServeConfig(max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms,
                      cache_size=args.cache_size,
                      trace_sample=args.trace_sample,
                      trace_log=args.trace_log,
                      trace_seed=args.seed)
    print(f"replaying {len(trace)} requests ({args.unique} unique) through "
          f"{args.clients} clients; max_batch={cfg.max_batch} "
          f"max_wait_ms={cfg.max_wait_ms:g}")
    run = serve_replay(engine, trace, cfg, clients=args.clients,
                       smoke=args.smoke, k=args.k,
                       metrics_port=args.metrics_port,
                       watch=(live, args.watch) if args.watch else None)
    if run["scraped"] is not None:
        print(f"metrics scrape verified: {len(run['scraped'])} samples "
              f"parsed, counters match ServeStats")
    stats = run["stats"]
    print(f"\n--- ServeStats ({run['wall_s']:.2f}s wall) ---")
    print(stats.summary())
    print(f"replay alone: {len(trace)} requests in {run['replay_s']:.3f}s, "
          f"{run['replay_stats'].throughput_rps:.2f} requests/s")
    split = latency_split(run["served"])
    print(f"latency split  queue p95={split['queue_p95_ms']:.1f}ms over "
          f"{split['n_queue']} dispatched; device "
          f"p95={split['device_p95_ms']:.1f}ms")

    if not args.no_verify:
        n_exact, n_approx = verify_served(engine, trace, run["served"])
        print(f"\nverified: {n_exact} exact answers equal the direct "
              f"engine, {n_approx} approximate answers carry valid sound "
              f"bounds")
    if args.smoke:
        print(check_smoke(stats, run["tree_check"], args.deadline_frac))
    if args.swap_mid_run:
        swap_smoke(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
