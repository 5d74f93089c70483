"""The port's serving subsystem (``repro_torch.serve``) against
``repro.serve`` on the CPU: the same ``make_trace`` replayed through both
services gives the same answers and the same served trees; the
micro-batcher's coalescing and shape separation, the result cache,
single-flight, deadline buckets with per-lane bounds, strict admission,
engine swaps, tree pagination, the adaptive lane policy (decision for
decision against ``repro``'s), and the two CLIs at a small size.

The engines run ``backend="torch"`` on the CPU against ``repro``'s
``"jnp"``.  Coalescing is made deterministic by holding the dispatcher
on one request while the others queue (``held_dispatcher``), so every
admission window stays at 5 ms or less.  Tolerance: none for weights,
bounds and counters; times are excluded.  Every future wait carries a
timeout.
"""

import contextlib
import threading
import time

import numpy as np
import pytest

from repro.engine import AdaptiveLanePolicy as LanePolicyJ
from repro.engine import ExecutionPolicy as PolicyJ
from repro.engine import QueryEngine as EngineJ
from repro.graph import generators as gen_j
from repro.graph.structure import build_graph as build_graph_j
from repro.serve import DKSService as ServiceJ
from repro.serve import ServeConfig as ConfigJ
from repro.serve.loadgen import make_trace as make_trace_j
from repro.serve.loadgen import replay as replay_j

from repro_torch.configs import DKSBenchConfig
from repro_torch.engine import AdaptiveLanePolicy
from repro_torch.engine import ExecutionPolicy as PolicyT
from repro_torch.engine import QueryEngine as EngineT
from repro_torch.graph import generators as gen_t
from repro_torch.graph.structure import build_graph as build_graph_t
from repro_torch.launch import dks_query, serve_dks
from repro_torch.obs import parse_prometheus
from repro_torch.serve import DKSService, ResultCache, ServeConfig
from repro_torch.serve.loadgen import TraceRequest, make_trace, replay

WAIT = 30  # seconds: the most any future is waited for


@pytest.fixture(scope="module")
def engines():
    gj, tokens = gen_j.lod_like_graph(600, 1800, seed=11, vocab=120)
    gt, _ = gen_t.lod_like_graph(600, 1800, seed=11, vocab=120)
    ref = EngineJ.build(gj, tokens=tokens,
                        policy=PolicyJ(max_supersteps=32))
    port = EngineT.build(gt, tokens=tokens,
                         policy=PolicyT(max_supersteps=32), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def mid_df_tokens(index, n, lo=2, hi=60):
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if lo <= index.df(t) <= hi]
    assert len(toks) >= n
    return toks[:n]


@contextlib.contextmanager
def held_dispatcher(svc, engine, query):
    """Occupy the service's dispatcher with one request until the block
    exits: everything submitted inside queues up and drains together."""
    entered, release = threading.Event(), threading.Event()
    orig = engine.query_batch

    def blocked(*args, **kwargs):
        del engine.query_batch        # later dispatches run unblocked
        entered.set()
        release.wait(WAIT)
        return orig(*args, **kwargs)

    engine.query_batch = blocked
    blocker = svc.submit(query, k=3)
    assert entered.wait(WAIT), "the dispatcher never took the blocker"
    try:
        yield blocker
    finally:
        release.set()
        blocker.result(timeout=WAIT)


def tree_key(t):
    return (t.root, tuple(sorted((e.u, e.v) for e in t.edges)))


def answer_keys(res):
    return [(a.root, a.edges, a.weight) for a in res.answers]


def chain_engines():
    """A heavy direct edge found early, the cheap 10-hop path later."""
    src = [0, 0] + list(range(2, 10)) + [10]
    dst = [1, 2] + list(range(3, 11)) + [1]
    w = np.asarray([100.0] + [1.0] * 10, np.float32)
    tokens = np.arange(11, dtype=np.int32).reshape(11, 1)
    ref = EngineJ.build(build_graph_j(src, dst, 11, w=w), tokens=tokens)
    port = EngineT.build(build_graph_t(src, dst, 11, w=w), tokens=tokens,
                         device="cpu")
    return ref, port


# ---------------------------------------------------------------------------
# Against repro
# ---------------------------------------------------------------------------


def test_loadgen_trace_matches_reference(engines):
    ref, port = engines
    kw = dict(unique=4, deadline_frac=0.25, deadline_ms=50.0, seed=1)
    trace = make_trace(port.index, 12, **kw)
    assert [(t.keywords, t.k, t.deadline_ms) for t in trace] == \
        [(t.keywords, t.k, t.deadline_ms)
         for t in make_trace_j(ref.index, 12, **kw)]
    assert {len(t.keywords) for t in trace} <= {2, 3}
    assert sum(t.deadline_ms is not None for t in trace) == 3
    assert trace == make_trace(port.index, 12, **kw)


def test_replay_answers_and_trees_match_reference(engines):
    """The same trace through both services: every served answer equal,
    then a page of served trees per unique query equal too."""
    ref, port = engines
    trace = make_trace(port.index, 16, unique=5, k=2, seed=3)
    got, want = [], []
    for service, config, eng, run in (
            (DKSService, ServeConfig, port, replay),
            (ServiceJ, ConfigJ, ref, replay_j)):
        out = got if eng is port else want
        with service(eng, config(max_batch=4, max_wait_ms=2.0,
                                 cache_size=64, tree_page_size=4)) as svc:
            if eng is port:
                out.append(run(svc, trace, n_clients=4, timeout=WAIT))
            else:
                out.append(run(svc, trace, n_clients=4))
            pages = []
            for q in dict.fromkeys(t.keywords for t in trace):
                for ranking in ("diverse", "weight"):
                    page = svc.submit(list(q), k=2, return_trees=True,
                                      tree_ranking=ranking).result(WAIT).trees
                    pages.append((page.total, page.exhausted,
                                  page.next_cursor, [
                                      (tree_key(t), t.weight, t.node_labels,
                                       t.root_label) for t in page.items]))
            out.append(pages)
            out.append(svc.stats())
    for srv_t, srv_j in zip(got[0], want[0]):
        assert not srv_t.approximate and not srv_j.approximate
        np.testing.assert_array_equal(srv_t.result.weights,
                                      srv_j.result.weights)
        np.testing.assert_array_equal(srv_t.result.roots,
                                      srv_j.result.roots)
        assert answer_keys(srv_t.result) == answer_keys(srv_j.result)
        assert srv_t.result.supersteps == srv_j.result.supersteps
    assert got[1] == want[1]
    assert got[2].requests == want[2].requests == len(trace) + len(got[1])


def test_deadline_expiry_matches_reference():
    """An expired deadline returns best-so-far with a valid bracket; the
    bounds equal ``repro``'s service on the same graph."""
    ref, port = chain_engines()
    out = []
    for service, config, eng in ((DKSService, ServeConfig, port),
                                 (ServiceJ, ConfigJ, ref)):
        with service(eng, config(cache_size=8)) as svc:
            exact = svc.submit([0, 1], k=1).result(WAIT)
            assert not exact.approximate and exact.best_weight == 10.0
            svc.invalidate_cache()
            served = svc.submit([0, 1], k=1, deadline_ms=0.0).result(WAIT)
            assert served.approximate and not served.result.done
            assert served.sound_opt_lower_bound <= served.opt_lower_bound
            assert served.sound_opt_lower_bound <= 10.0
            assert served.result.weights[0] >= 10.0
            assert served.result.spa is not None
            assert svc.stats().cache_hits == 0      # never cached
            again = svc.submit([0, 1], k=1).result(WAIT)
            assert not again.cache_hit and not again.approximate
            done = svc.submit([0, 1], k=1,
                              deadline_ms=60_000.0).result(WAIT)
            assert done.cache_hit and not done.approximate
            out.append((served.opt_lower_bound, served.sound_opt_lower_bound,
                        served.result.spa, served.result.spa_ratio,
                        served.result.supersteps,
                        served.result.weights.tolist()))
    assert out[0] == out[1]


def test_streamed_until_matches_reference(engines):
    ref, port = engines
    q = mid_df_tokens(port.index, 3)
    res = {}
    for name, eng in (("port", port), ("ref", ref)):
        updates = []
        r = eng.query_streamed(q, k=1, extract=False,
                               on_update=updates.append,
                               until=lambda u: u.step >= 1)
        res[name] = (r.done, r.spa, r.spa_ratio, r.supersteps,
                     [(u.step, u.spa_ratio, u.opt_lower_bound,
                       u.sound_opt_lower_bound) for u in updates])
    assert res["port"] == res["ref"]
    done, spa, _, _, ups = res["port"]
    assert len(ups) == 2 and not done and spa is not None
    assert all(cur[1] <= prev[1] for prev, cur in zip(ups, ups[1:]))
    assert all(cur[2] >= prev[2] for prev, cur in zip(ups, ups[1:]))
    full = port.query_streamed(q, k=1, extract=False)
    assert full.done and full.spa is None


@pytest.mark.parametrize("trace", [
    ((6, 10.0), (8, 500.0), (6, 10.0), (8, 500.0), (6, 10.0), (8, 500.0)),
    ((4, 100.0),),
    ((2, 3.0), (4, 9.0), (16, 40.0), (4, 7.0)),
])
def test_adaptive_lane_policy_decides_as_reference(trace):
    hot = (((3, 2, 6), 40), ((2, 1, 12), 5))
    for retrace in (0.0, 200.0):
        pt = AdaptiveLanePolicy(max_lanes=16, retrace_cost_ms=retrace)
        pj = LanePolicyJ(max_lanes=16, retrace_cost_ms=retrace)
        for step in range(len(trace) + 1):
            for n in (1, 3, 5, 7, 9, 16, 40):
                dt, dj = pt.lanes_for(n, hot), pj.lanes_for(n, hot)
                assert (dt.lanes, dt.reason, dt.est_ms) == \
                    (dj.lanes, dj.reason, dj.est_ms)
            assert pt.target_fill() == pj.target_fill()
            if step < len(trace):
                pt.observe(*trace[step])
                pj.observe(*trace[step])
        assert pt.snapshot() == pj.snapshot()
        assert pt.per_lane_ms() == pj.per_lane_ms()


# ---------------------------------------------------------------------------
# The behaviors of repro's serving tests
# ---------------------------------------------------------------------------


def test_concurrent_clients_match_direct_engine(engine):
    toks = mid_df_tokens(engine.index, 9)
    pool = [tuple(toks[0:2]), tuple(toks[2:4]), tuple(toks[4:6]),
            tuple(toks[6:9]), tuple(toks[3:6])]
    trace = [TraceRequest(pool[i % len(pool)]) for i in range(15)]
    with DKSService(engine, ServeConfig(max_batch=4, max_wait_ms=5.0,
                                        cache_size=64)) as svc:
        served = replay(svc, trace, n_clients=8, timeout=WAIT)
        stats = svc.stats()
    assert stats.requests == len(trace)
    assert stats.batch_dispatches > 0
    assert stats.cache_hits + stats.single_flight_hits > 0
    refs = {q: engine.query(list(q), k=1) for q in pool}
    for req, srv in zip(trace, served):
        assert not srv.approximate
        np.testing.assert_array_equal(srv.result.weights,
                                      refs[req.keywords].weights)
        assert answer_keys(srv.result) == answer_keys(refs[req.keywords])


def test_batcher_coalesces_same_shape_and_separates(engine):
    toks = mid_df_tokens(engine.index, 10)
    m2 = [toks[0:2], toks[2:4], toks[4:6], toks[6:8]]
    m3 = [toks[0:3], toks[6:9]]
    with DKSService(engine, ServeConfig(max_batch=4, max_wait_ms=2.0,
                                        cache_size=0)) as svc:
        with held_dispatcher(svc, engine, toks[7:10]):
            futures = [svc.submit(q, k=1) for q in m2 + m3]
        served = [f.result(timeout=WAIT) for f in futures]
        stats = svc.stats()
    assert [s.batch_size for s in served[:4]] == [4, 4, 4, 4]
    assert [s.batch_size for s in served[4:]] == [2, 2]
    assert stats.batch_dispatches == 3            # the blocker's too
    assert stats.mean_batch_fill == 7 / 3
    assert stats.cache_hits == 0 and stats.cache_misses == 0  # cache off
    for q, srv in zip(m2 + m3, served):
        np.testing.assert_array_equal(srv.result.weights,
                                      engine.query(q, k=1).weights)


def test_cache_hit_skips_execution_and_normalizes(engine):
    q = mid_df_tokens(engine.index, 2)
    with DKSService(engine, ServeConfig(max_batch=2, max_wait_ms=1.0,
                                        cache_size=8)) as svc:
        first = svc.query(q, k=1, timeout=WAIT)
        assert not first.cache_hit and first.batch_size == 1
        executes = engine.execute_count
        traces = engine.cache_stats["traces"]
        second = svc.query(q, k=1, timeout=WAIT)
        permuted = svc.query(list(reversed(q)), k=1, timeout=WAIT)
        assert second.cache_hit and permuted.cache_hit
        assert second.batch_size == 0
        assert engine.execute_count == executes
        assert engine.cache_stats["traces"] == traces
        np.testing.assert_array_equal(permuted.result.weights,
                                      first.result.weights)
        stats = svc.stats()
        assert stats.cache_hits == 2 and stats.cache_misses == 1
        assert not svc.query(q, k=2, timeout=WAIT).cache_hit
        assert not svc.query(q, k=1, max_supersteps=8,
                             timeout=WAIT).cache_hit
        assert svc.invalidate_cache() > 0
        assert not svc.query(q, k=1, timeout=WAIT).cache_hit


def test_single_flight_coalesces_identical_misses(engine):
    toks = mid_df_tokens(engine.index, 6)
    q = toks[0:2]
    ref = engine.query(q, k=1)
    with DKSService(engine, ServeConfig(max_batch=8, max_wait_ms=2.0,
                                        cache_size=8)) as svc:
        with held_dispatcher(svc, engine, toks[3:6]):
            executes = engine.execute_count
            futures = [svc.submit(q, k=1) for _ in range(5)]
        served = [f.result(timeout=WAIT) for f in futures]
        stats = svc.stats()
    # Two dispatches: the blocker's, and one for the five identical
    # requests.
    assert engine.execute_count == executes + 2
    leaders = [s for s in served if not s.coalesced and not s.cache_hit]
    assert len(leaders) == 1
    assert sum(s.coalesced for s in served) == 4
    assert stats.requests == 6 and stats.single_flight_hits == 4
    assert stats.cache_misses == 2   # the blocker's and one durable miss
    for srv in served:
        np.testing.assert_array_equal(srv.result.weights, ref.weights)
    with DKSService(engine, ServeConfig(cache_size=8)) as svc:
        first = svc.query(q, k=1, timeout=WAIT)
        again = svc.query(q, k=1, timeout=WAIT)
    assert not first.cache_hit and again.cache_hit and not again.coalesced


def test_cache_lru_eviction_and_disable():
    cache = ResultCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1       # refreshes a
    cache.put("c", 3)                # evicts b (LRU)
    assert cache.get("b") is None
    assert cache.get("a") == 1 and cache.get("c") == 3
    st = cache.stats()
    assert st["evictions"] == 1 and st["size"] == 2
    disabled = ResultCache(capacity=0)
    disabled.put("a", 1)
    assert disabled.get("a") is None
    assert disabled.stats()["hits"] == 0 and disabled.stats()["misses"] == 0


def test_deadline_bucket_coalesces_and_shares_supersteps(engine):
    toks = mid_df_tokens(engine.index, 11)
    queries = [toks[0:2], toks[2:4], toks[4:6], toks[6:8]]
    solo = [engine.query(q, k=1, extract=False) for q in queries]
    with DKSService(engine, ServeConfig(max_batch=4, max_wait_ms=2.0,
                                        cache_size=0)) as svc:
        with held_dispatcher(svc, engine, toks[8:11]):
            futures = [svc.submit(q, k=1, deadline_ms=60_000.0)
                       for q in queries]
        served = [f.result(timeout=WAIT) for f in futures]
        stats = svc.stats()
    assert stats.deadline_dispatches == 1
    assert stats.deadline_batched_requests == 4
    assert stats.mean_deadline_fill == 4.0
    for srv, ref in zip(served, solo):
        assert not srv.approximate and srv.batch_size == 4
        np.testing.assert_array_equal(srv.result.weights, ref.weights)
    assert stats.deadline_lane_supersteps == sum(r.supersteps for r in solo)
    assert stats.deadline_driver_supersteps == \
        max(r.supersteps for r in solo)
    assert stats.deadline_driver_supersteps < stats.deadline_lane_supersteps


def test_deadline_bucket_expiry_per_lane_bounds():
    ref, engine = chain_engines()
    with DKSService(engine, ServeConfig(max_batch=4, max_wait_ms=2.0,
                                        cache_size=0)) as svc:
        with held_dispatcher(svc, engine, [3, 4]):
            futures = [svc.submit([0, 1], k=1, deadline_ms=0.0),
                       svc.submit([2, 10], k=1, deadline_ms=0.0)]
        served = [f.result(timeout=WAIT) for f in futures]
        stats = svc.stats()
    assert stats.deadline_dispatches == 1 and stats.mean_deadline_fill == 2.0
    out = ref.query_deadline_batch([[0, 1], [2, 10]], k=1, deadline_s=0.0)
    for srv, q, (rj, ij) in zip(served, [(0, 1), (2, 10)], out):
        best = engine.query(list(q), k=1).best_weight
        assert srv.approximate and not srv.result.done
        assert srv.result.spa == rj.spa is not None
        assert srv.opt_lower_bound == ij["opt_lower_bound"]
        assert srv.sound_opt_lower_bound == ij["sound_opt_lower_bound"]
        assert srv.sound_opt_lower_bound <= srv.opt_lower_bound
        assert srv.sound_opt_lower_bound <= best
        assert srv.result.weights[0] >= best


def test_strict_admission_rejects_unmatched_alone(engine):
    good = mid_df_tokens(engine.index, 2)
    missing = max(engine.index.vocabulary()) + 1000
    with DKSService(engine, ServeConfig(max_batch=4, max_wait_ms=5.0,
                                        cache_size=0)) as svc:
        bad_future = svc.submit([missing, missing + 1], k=1)
        good_future = svc.submit(good, k=1)
        with pytest.raises(KeyError, match=str(missing)):
            bad_future.result(timeout=WAIT)
        served = good_future.result(timeout=WAIT)
    np.testing.assert_array_equal(served.result.weights,
                                  engine.query(good, k=1).weights)


def test_set_engine_inflight_served_by_admitting_build(engine):
    g2, tokens2 = gen_t.lod_like_graph(300, 900, seed=5, vocab=80)
    engine2 = EngineT.build(g2, tokens=tokens2, device="cpu")
    both = set(engine2.index.vocabulary())
    toks = [t for t in sorted(engine.index.vocabulary(), key=engine.index.df)
            if engine.index.df(t) >= 2 and t in both]
    q = toks[:2]
    with DKSService(engine, ServeConfig(max_batch=8, max_wait_ms=2.0,
                                        cache_size=8)) as svc:
        with held_dispatcher(svc, engine, toks[2:5]):
            queued = svc.submit(q, k=1)      # admitted under the old build
            svc.set_engine(engine2)          # graph rebuild mid-flight
        served = queued.result(timeout=WAIT)
        np.testing.assert_array_equal(served.result.weights,
                                      engine.query(q, k=1).weights)
        post = svc.query(q, k=1, timeout=WAIT)
        assert not post.cache_hit
        np.testing.assert_array_equal(post.result.weights,
                                      engine2.query(q, k=1).weights)
        assert svc.stats().engine_swaps == 1


def test_default_equal_override_coalesces(engine):
    toks = mid_df_tokens(engine.index, 7)
    with DKSService(engine, ServeConfig(max_batch=2, max_wait_ms=2.0,
                                        cache_size=0)) as svc:
        with held_dispatcher(svc, engine, toks[4:7]):
            f1 = svc.submit(toks[0:2], k=1)
            f2 = svc.submit(toks[2:4], k=1, max_supersteps=32)  # the policy's
        r1, r2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
    assert r1.batch_size == 2 and r2.batch_size == 2


def test_unhashable_and_unknown_overrides_fail_alone(engine):
    good = mid_df_tokens(engine.index, 2)
    with DKSService(engine, ServeConfig(max_wait_ms=1.0,
                                        cache_size=0)) as svc:
        with pytest.raises(TypeError, match="unhashable"):
            svc.submit(good, k=1, max_supersteps=[8]).result(timeout=WAIT)
        with pytest.raises(TypeError, match="unknown policy override"):
            svc.submit(good, k=1, no_such_knob=1).result(timeout=WAIT)
        ok = svc.query(good, k=1, timeout=WAIT)
    np.testing.assert_array_equal(ok.result.weights,
                                  engine.query(good, k=1).weights)


def test_stopped_service_rejects_submits(engine):
    svc = DKSService(engine, ServeConfig())
    with pytest.raises(RuntimeError):
        svc.submit(mid_df_tokens(engine.index, 2), k=1)
    svc.start()
    svc.stop()
    with pytest.raises(RuntimeError):
        svc.submit(mid_df_tokens(engine.index, 2), k=1)


def test_return_trees_render_labels_and_cache():
    """Served trees carry the graph's labels, rank by diversity, paginate,
    and a warm identical request is served whole from the tree-pool
    cache; invalidation drains the tree cache too."""
    labels = ["paris hotel", "piano bar", "cafe central", "bistro nord",
              "museum", "shop"]
    g = build_graph_t([0, 2, 0, 3, 4, 5], [2, 1, 3, 1, 0, 1], 6,
                      w=np.ones(6, np.float32), labels=labels)
    engine = EngineT.build(g, device="cpu")
    with DKSService(engine, ServeConfig(cache_size=8,
                                        tree_page_size=2)) as svc:
        page = svc.query(["paris", "piano"], k=2, return_trees=True,
                         timeout=WAIT).trees
        assert page is not None and page.ranking == "diverse"
        assert page.total >= 2 and len(page.items) == 2
        assert len({tree_key(t) for t in page.items}) == 2
        for t in page.items:
            assert t.root_label == labels[t.root]
            assert all(lbl == labels[n]
                       for n, lbl in zip(t.nodes, t.node_labels))
        assert {2, 3} <= {n for t in page.items for n in t.nodes} - {0, 1}
        assert svc.stats().tree_requests == 1
        executes = engine.execute_count
        warm = svc.query(["paris", "piano"], k=2, return_trees=True,
                         timeout=WAIT)
        assert warm.cache_hit and engine.execute_count == executes
        assert [tree_key(t) for t in warm.trees.items] == \
            [tree_key(t) for t in page.items]
        assert svc.stats().tree_cache_hits == 1
        assert svc.invalidate_cache() >= 2
        assert not svc.query(["paris", "piano"], k=2, return_trees=True,
                             timeout=WAIT).cache_hit


def test_return_trees_end_to_end_from_artifact(tmp_path):
    """The answer pipeline off an ingested artifact: served trees are
    label-rendered from the artifact's label blob (the graph carries no
    labels in memory), equal to what repro serves from the same artifact,
    and a warm identical request comes whole from the tree-pool cache."""
    from repro.store import open_artifact as open_artifact_j

    from repro_torch.graph.index import InvertedIndex
    from repro_torch.store import open_artifact, write_artifact

    labels = ["paris hotel", "piano bar", "cafe central", "bistro nord",
              "museum", "shop"]
    g = build_graph_t([0, 2, 0, 3, 4, 5], [2, 1, 3, 1, 0, 1], 6,
                      w=np.ones(6, np.float32), labels=labels)
    art = write_artifact(tmp_path / "art", g, InvertedIndex.from_labels(labels))
    engine = EngineT.build(artifact=open_artifact(art.path), device="cpu")
    ref = EngineJ.build(artifact=open_artifact_j(art.path))
    assert engine.graph.labels is None  # labels live only in the blob
    assert engine.version == ref.version
    cfg = dict(cache_size=8, tree_page_size=2)
    with DKSService(engine, ServeConfig(**cfg)) as svc, \
            ServiceJ(ref, ConfigJ(**cfg)) as svc_j:
        page = svc.query(["paris", "piano"], k=2, return_trees=True,
                         timeout=WAIT).trees
        page_j = svc_j.query(["paris", "piano"], k=2,
                             return_trees=True).trees
        assert page.total == page_j.total >= 2 and len(page.items) == 2
        assert [(tree_key(t), t.node_labels, t.root_label)
                for t in page.items] == \
            [(tree_key(t), t.node_labels, t.root_label)
             for t in page_j.items]
        for t in page.items:
            assert all(lbl == labels[n]
                       for n, lbl in zip(t.nodes, t.node_labels))
        executes = engine.execute_count
        warm = svc.query(["paris", "piano"], k=2, return_trees=True,
                         timeout=WAIT)
        assert warm.cache_hit and engine.execute_count == executes
        assert [tree_key(t) for t in warm.trees.items] == \
            [tree_key(t) for t in page.items]
        assert svc.stats().tree_cache_hits == 1


def test_tree_ranking_and_pagination(engine):
    toks = mid_df_tokens(engine.index, 2)
    with DKSService(engine, ServeConfig(cache_size=8, tree_page_size=2,
                                        tree_pool_factor=4)) as svc:
        page = svc.query(toks, k=3, return_trees=True, tree_ranking="weight",
                         timeout=WAIT).trees
        assert page.ranking == "weight"
        ws = [t.weight for t in page.items]
        assert ws == sorted(ws)
        seen = list(page.items)
        cursor = page.next_cursor
        while cursor is not None:
            nxt = svc.query(toks, k=3, return_trees=True,
                            tree_ranking="weight", tree_cursor=cursor,
                            timeout=WAIT)
            assert nxt.cache_hit and nxt.trees.cursor == cursor
            seen.extend(nxt.trees.items)
            cursor = nxt.trees.next_cursor
        assert len(seen) == page.total
        assert len({tree_key(t) for t in seen}) == page.total
        div = svc.query(toks, k=3, return_trees=True,
                        tree_ranking="diverse", tree_page_size=page.total,
                        timeout=WAIT)
        assert {tree_key(t) for t in div.trees.items} == \
            {tree_key(t) for t in seen}
        with pytest.raises(ValueError, match="tree_ranking"):
            svc.submit(toks, k=1, return_trees=True,
                       tree_ranking="bogus").result(timeout=WAIT)
        assert svc.query(toks, k=3, return_trees=True,
                         timeout=WAIT).trees is not None


def test_adaptive_lane_policy_degrades_to_pow2_until_measured():
    pol = AdaptiveLanePolicy(max_lanes=16)
    d = pol.lanes_for(5)
    assert d.lanes == 8 and d.reason == "pow2" and d.est_ms is None
    assert pol.lanes_for(16).lanes == 16
    assert pol.lanes_for(100).lanes == 16


def test_adaptive_lane_policy_prefers_cheap_warm_counts():
    pol = AdaptiveLanePolicy(max_lanes=16, retrace_cost_ms=200.0)
    for _ in range(3):
        pol.observe(6, 10.0)
        pol.observe(8, 500.0)
    d = pol.lanes_for(5)
    assert d.lanes == 6 and d.reason == "warm"
    d2 = pol.lanes_for(7)
    assert d2.lanes == 7 and d2.reason == "exact"
    snap = pol.snapshot()
    assert snap["last_lanes"] == 7 and snap["decisions"]["warm"] >= 1


def test_adaptive_padding_serves_parity_and_exports_metrics(engine):
    toks = mid_df_tokens(engine.index, 6)
    queries = [toks[i:i + 3] for i in range(3)]
    with DKSService(engine, ServeConfig(
            max_batch=8, max_wait_ms=4.0,
            pad_batches="adaptive", cache_size=0)) as svc:
        first = [f.result(WAIT) for f in [svc.submit(q, k=1)
                                          for q in queries]]
        second = [f.result(WAIT) for f in [svc.submit(q, k=1)
                                           for q in reversed(queries)]]
        snap = svc.lane_policy.snapshot()
        metrics = parse_prometheus(svc.registry.render())
    for q, served in zip(queries + queries[::-1], first + second):
        np.testing.assert_array_equal(served.result.weights,
                                      engine.query(q, k=1).weights)
    assert snap["observed_counts"]
    assert sum(snap["decisions"].values()) >= 1
    assert "dks_lane_policy_last_lanes" in metrics
    assert "dks_lane_policy_decision_pow2_total" in metrics


def test_serve_config_rejects_unknown_pad_mode():
    with pytest.raises(ValueError, match="pad_batches"):
        ServeConfig(pad_batches="nope")


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


TINY = DKSBenchConfig(name="tiny", n_nodes=600, n_edges=1800, vocab=120,
                      seed=11)


@pytest.fixture
def tiny_dataset(monkeypatch):
    monkeypatch.setitem(dks_query.DKS_CONFIGS, "tiny", TINY)


def test_serve_dks_smoke_holds_its_invariants(tiny_dataset, capsys):
    t0 = time.perf_counter()
    assert serve_dks.main(["--smoke", "--dataset", "tiny", "--backend",
                           "torch", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "smoke invariants hold" in out
    assert "metrics scrape verified" in out
    assert "exact answers equal the direct engine" in out
    assert time.perf_counter() - t0 < 60


@pytest.mark.parametrize("flags", [
    ["--telemetry", "--parity", "--extract"],
    ["--stream"],
    ["--explain", "--backend", "torch"],
])
def test_dks_query_cli(tiny_dataset, capsys, flags):
    assert dks_query.main(["--dataset", "tiny", "--device", "cpu",
                           "--k", "2", *flags]) == 0
    out = capsys.readouterr().out
    assert "DKS finished in" in out
    if "--telemetry" in flags:
        assert "superstep telemetry" in out
        assert "parity: cuda == torch bit-identical" in out
    if "--stream" in flags:
        assert "step  0" in out and "[exit]" in out
    if "--explain" in flags:
        assert "device_dispatch" in out


@pytest.mark.parametrize("argv", [
    ["--artifact", "x"], ["--live", "x"], ["--watch", "x"],
    ["--swap-mid-run"]])
def test_store_and_live_flags_raise_until_ported(tiny_dataset, capsys, argv):
    """The graph store is ported: each flag now reaches it, and none
    raises NotImplementedError.  A missing artifact or live dir raises the
    store's own error, ``--watch`` needs ``--live``, and
    ``--swap-mid-run`` runs the swap-under-load leg to its invariants."""
    from repro_torch.store import ArtifactError
    cli = ["--smoke", "--dataset", "tiny", "--backend", "torch",
           "--device", "cpu", *argv]
    if argv[0] == "--swap-mid-run":
        assert serve_dks.main(cli) == 0
        assert "swap smoke invariants hold" in capsys.readouterr().out
    elif argv[0] == "--watch":
        with pytest.raises(SystemExit):
            serve_dks.main(cli)
        assert "--watch needs --live" in capsys.readouterr().err
    else:
        with pytest.raises(ArtifactError, match="no (graph artifact|live "
                                                "graph) at x"):
            serve_dks.main(cli)
    if argv[0] == "--artifact":
        with pytest.raises(ArtifactError, match="no graph artifact"):
            dks_query.main(["--device", "cpu", *argv])


def test_serve_dks_live_watch_and_artifact(tiny_dataset, tmp_path, capsys):
    """``serve_dks --live DIR --watch WATCH_DIR`` serves a LiveDir's chain
    with the watcher running, and ``--artifact`` serves an ingested
    artifact; both verify every served answer against the direct engine."""
    from repro_torch.launch import ingest as ingest_cli
    art = str(tmp_path / "art")
    assert ingest_cli.main(["--dataset", "tiny", "--out", art,
                            "--device", "cpu", "--verify-queries", "0"]) == 0
    assert serve_dks.main(["--artifact", art, "--requests", "8",
                           "--clients", "2", "--backend", "torch",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"loaded {art}" in out and "exact answers equal" in out
    lines = [f"a{i} g{i % 8}\ta{i + 1} g{(i + 1) % 8}" for i in range(24)]
    (tmp_path / "base.tsv").write_text("\n".join(lines) + "\n")
    (tmp_path / "incoming").mkdir()
    assert ingest_cli.main(["--input", str(tmp_path / "base.tsv"), "--live",
                            str(tmp_path / "live"), "--device", "cpu"]) == 0
    assert serve_dks.main(["--live", str(tmp_path / "live"), "--watch",
                           str(tmp_path / "incoming"), "--requests", "8",
                           "--unique", "4", "--clients", "2", "--backend",
                           "torch", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "loaded LiveDir(" in out and "watching" in out
    assert "exact answers equal" in out


def test_sharded_partition_raises_until_ported():
    """Ported: ``partition="sharded"`` builds on ``"torch"``; with
    ``"cuda"`` it raises ``NotImplementedError``, as ``repro``'s
    ``"pallas"`` with ``"sharded"`` does."""
    assert PolicyT(partition="sharded").backend == "torch"
    with pytest.raises(NotImplementedError, match="sharded"):
        PolicyT(partition="sharded", backend="cuda")
    with pytest.raises(NotImplementedError, match="sharded"):
        PolicyJ(partition="sharded", backend="pallas")
    with pytest.raises(ValueError, match="partition"):
        PolicyT(partition="bogus")


def test_service_on_a_sharded_engine_serves_engine_answers(engine):
    """``DKSService`` over a sharded CPU engine (3 shards, uncapped)
    serves ``engine.query``'s answers, which are the single engine's."""
    sharded = EngineT.build(engine.graph, index=engine.index, device="cpu",
                            policy=PolicyT(partition="sharded", n_shards=3,
                                           frontier_frac=1.0,
                                           max_supersteps=32))
    toks = mid_df_tokens(engine.index, 9)
    pool = [tuple(toks[0:2]), tuple(toks[2:4]), tuple(toks[6:9]),
            tuple(toks[3:6])]
    trace = [TraceRequest(pool[i % len(pool)]) for i in range(10)]
    with DKSService(sharded, ServeConfig(max_batch=4, max_wait_ms=5.0,
                                         cache_size=64)) as svc:
        served = replay(svc, trace, n_clients=4, timeout=WAIT)
        assert svc.stats().requests == len(trace)
    for req, srv in zip(trace, served):
        ref = sharded.query(list(req.keywords), k=1)
        assert not srv.approximate
        np.testing.assert_array_equal(srv.result.weights, ref.weights)
        assert answer_keys(srv.result) == answer_keys(ref)
        np.testing.assert_array_equal(
            ref.weights, engine.query(list(req.keywords), k=1).weights)


def test_serve_dks_and_dks_query_take_the_partition(tiny_dataset, capsys):
    """``--partition sharded``: the serve smoke holds its invariants on
    ``"torch"`` (the backend's default there), ``dks_query`` answers, and
    an explicit ``--backend cuda`` is refused."""
    assert serve_dks.main(["--smoke", "--dataset", "tiny", "--partition",
                           "sharded", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "partition: sharded, 1 shard(s) of 600 nodes" in out
    assert "backend torch" in out and "smoke invariants hold" in out
    assert dks_query.main(["--dataset", "tiny", "--device", "cpu",
                           "--partition", "sharded", "--extract"]) == 0
    assert "DKS finished in" in capsys.readouterr().out
    for cli in (serve_dks, dks_query):
        with pytest.raises(SystemExit):
            cli.main(["--dataset", "tiny", "--device", "cpu", "--partition",
                      "sharded", "--backend", "cuda"])
        assert "--backend torch only" in capsys.readouterr().err
