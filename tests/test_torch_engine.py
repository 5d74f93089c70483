"""Port parity, the slice end to end: ``repro_torch``'s ``QueryEngine`` on
the CPU, under ``backend="torch"`` and ``backend="cuda"`` (whose wrappers
run the kernels' plain versions on CPU tensors), answers exactly as
``repro``'s engine under ``"jnp"`` and ``"pallas"`` (interpret mode):
weights, roots, supersteps, messages, flags and answer trees, including
the aggregator's tie order and nodes that receive nothing."""

import numpy as np
import pytest
import torch

from repro.core.steiner_ref import dreyfus_wagner as dw_j
from repro.engine import ExecutionPolicy as PolicyJ
from repro.engine import QueryEngine as EngineJ
from repro.graph import generators as gen_j
from repro.graph import structure as st_j
from repro.graph.index import InvertedIndex as IndexJ

from repro_torch import INF
from repro_torch.core.steiner_ref import dreyfus_wagner as dw_t
from repro_torch.device import resolve_device
from repro_torch.engine import ExecutionPolicy as PolicyT
from repro_torch.engine import QueryEngine as EngineT
from repro_torch.graph import generators as gen_t
from repro_torch.graph import structure as st_t
from repro_torch.graph.index import InvertedIndex as IndexT
from repro_torch.kernels.lane_superstep import ops as ls_ops

TWIN = {"torch": "jnp", "cuda": "pallas"}


@pytest.fixture(scope="module")
def engines():
    gj, tokens = gen_j.lod_like_graph(300, 1200, seed=7, vocab=80)
    gt, _ = gen_t.lod_like_graph(300, 1200, seed=7, vocab=80)
    ref = {b: EngineJ.build(gj, tokens=tokens, policy=PolicyJ(
        backend=b, max_supersteps=16)) for b in ("jnp", "pallas")}
    port = {b: EngineT.build(gt, tokens=tokens, policy=PolicyT(
        backend=b, max_supersteps=16), device="cpu") for b in TWIN}
    index = ref["jnp"].index
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 60]
    return ref, port, toks


def assert_same_result(rt, rj):
    np.testing.assert_array_equal(rt.weights, rj.weights)
    np.testing.assert_array_equal(rt.roots, rj.roots)
    for f in ("m", "k", "kw_nodes", "supersteps", "msgs_bfs", "msgs_deep",
              "explored_frac", "done", "budget_hit", "capped", "spa",
              "spa_ratio", "answers_exhausted", "unmatched"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert [(a.root, a.edges, a.weight, a.raw_value, a.nodes)
            for a in rt.answers] == \
        [(a.root, a.edges, a.weight, a.raw_value, a.nodes)
         for a in rj.answers]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_query_matches_reference(engines, backend):
    ref, port, toks = engines
    query = toks[:3]
    rt = port[backend].query(query, k=2)
    assert rt.found and rt.answers
    for b in {"jnp", TWIN[backend]}:
        assert_same_result(rt, ref[b].query(query, k=2))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_query_batch_matches_reference(engines, backend):
    ref, port, toks = engines
    queries = [toks[0:2], toks[2:5], toks[5:8], toks[1:3]]  # m-bucketed
    got = port[backend].query_batch(queries, k=2)
    want = ref[TWIN[backend]].query_batch(queries, k=2)
    for rt, rj in zip(got, want):
        assert_same_result(rt, rj)
    padded = port[backend].query_batch(queries, k=2, extract=False, n_real=2)
    assert padded[2:] == [None, None]
    np.testing.assert_array_equal(padded[1].weights, got[1].weights)


def both_engines(n, groups, edges, backend, max_supersteps=64):
    """One graph given by explicit edges and keyword groups, as a repro
    engine and a port engine."""
    src, dst, w = (np.asarray(x) for x in zip(*edges))
    offs = np.concatenate([[0], np.cumsum([len(g) for g in groups])])
    nodes = np.concatenate([np.sort(g) for g in groups]).astype(np.int32)
    gj = st_j.build_graph(src, dst, n, w=w.astype(np.float32))
    gt = st_t.build_graph(src, dst, n, w=w.astype(np.float32))
    toks = list(range(len(groups)))
    ej = EngineJ.build(gj, index=IndexJ.from_postings(toks, offs, nodes),
                       policy=PolicyJ(backend=TWIN[backend],
                                      max_supersteps=max_supersteps))
    et = EngineT.build(gt, index=IndexT.from_postings(toks, offs, nodes),
                       policy=PolicyT(backend=backend,
                                      max_supersteps=max_supersteps),
                       device="cpu")
    return ej, et, toks


@pytest.mark.parametrize("n_shards", [1, 3])
def test_sharded_engine_matches_reference_dense(engines, n_shards):
    """The port's sharded partition, uncapped, answers a bucket exactly as
    ``repro``'s dense engine does: weights, roots, counters, trees."""
    ref, port, toks = engines
    sharded = EngineT.build(
        port["torch"].graph, index=port["torch"].index, device="cpu",
        policy=PolicyT(partition="sharded", n_shards=n_shards,
                       frontier_frac=1.0, max_supersteps=16))
    queries = [toks[0:2], toks[2:5], toks[5:8], toks[1:3]]
    for rt, rj in zip(sharded.query_batch(queries, k=2),
                      ref["jnp"].query_batch(queries, k=2)):
        assert_same_result(rt, rj)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_tie_order_keeps_lower_index_first(backend):
    """A unit-weight ring with keywords at opposite nodes: every node roots
    an answer of weight 20.  The aggregator must pick the lowest
    (node, slot) indices among the ties, as ``lax.top_k`` does."""
    n = 40
    edges = [(i, (i + 1) % n, 1.0) for i in range(n)]
    ej, et, toks = both_engines(n, [[0], [20]], edges, backend)
    rj = ej.query(toks, k=3, extract=False)
    rt = et.query(toks, k=3, extract=False)
    np.testing.assert_array_equal(rt.weights, [20.0, 20.0, 20.0])
    np.testing.assert_array_equal(rt.roots, [0, 1, 2])
    assert_same_result(rt, rj)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_nodes_that_receive_nothing_stay_inf(backend):
    """Isolated nodes and a disconnected pair: their relax segments are
    empty every superstep, and the whole final table still equals the
    reference's (INF where nothing ever arrived)."""
    edges = [(0, 1, 2.0), (1, 2, 1.0), (2, 3, 3.0), (1, 4, 1.0),
             (7, 8, 1.0)]
    ej, et, toks = both_engines(12, [[0, 7], [3], [4]], edges, backend)
    rj = ej.query(toks, k=2, keep_state=True)
    rt = et.query(toks, k=2, keep_state=True)
    assert_same_result(rt, rj)
    S = rt.state.S[0].numpy()
    np.testing.assert_array_equal(S, np.asarray(rj.state.S))
    assert np.all(S[[5, 6, 9, 10, 11]] == INF)


@pytest.mark.parametrize("seed", range(3))
def test_top1_matches_dreyfus_wagner(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 14))
    e = n + int(rng.integers(0, 8))
    g = gen_t.random_weighted_graph(n, e, seed=seed)
    m = int(rng.integers(2, 4))
    groups = [rng.choice(n, size=int(rng.integers(1, 3)), replace=False)
              for _ in range(m)]
    opt = dw_t(g, groups)
    assert opt == dw_j(gen_j.random_weighted_graph(n, e, seed=seed), groups)
    offs = np.concatenate([[0], np.cumsum([len(x) for x in groups])])
    idx = IndexT.from_postings(list(range(m)), offs, np.concatenate(
        [np.sort(x) for x in groups]).astype(np.int32))
    for backend in TWIN:
        eng = EngineT.build(g, index=idx, policy=PolicyT(backend=backend),
                            device="cpu")
        assert eng.query(list(range(m)), k=1).best_weight == \
            pytest.approx(opt, abs=1e-3)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_capped_run_reports_the_same_spa(engines, backend):
    ref, port, toks = engines
    query = toks[3:6]
    rj = ref[TWIN[backend]].query(query, k=2, max_supersteps=2)
    rt = port[backend].query(query, k=2, max_supersteps=2)
    assert rt.capped and rt.spa is not None
    assert_same_result(rt, rj)


def test_build_without_device_raises_on_a_cpu_only_box(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, tokens = gen_t.lod_like_graph(30, 60, seed=1, vocab=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineT.build(g, tokens=tokens)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.to_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cache_token_execute_count_and_guards(engines):
    _, port, toks = engines
    eng = port["torch"]
    before = eng.execute_count
    eng.query(toks[:2], k=1, extract=False)
    eng.query_batch([toks[:2], toks[2:4], toks[4:7]], k=1, extract=False)
    assert eng.execute_count == before + 3  # one query + two m-buckets
    assert eng.cache_token(toks[:2]) == eng.cache_token(toks[:2][::-1])
    assert eng.cache_token(toks[:2]) != port["cuda"].cache_token(toks[:2])
    assert eng.cache_token(toks[:2], max_supersteps=3) != \
        eng.cache_token(toks[:2])
    with pytest.raises(ValueError, match="weight policy is fixed"):
        eng.query(toks[:2], weights=None)
    with pytest.raises(KeyError):
        eng.query([toks[0], 10_000])
    res = eng.query([toks[0], 10_000], strict=False, extract=False)
    assert res.unmatched == (10_000,) and not res.found
    # The plain path has no (m, K) limit: on CPU tensors six keywords on
    # "cuda" answer as on "torch".
    wide = port["cuda"].query(toks[:6], k=1, extract=False)
    np.testing.assert_array_equal(
        wide.weights, port["torch"].query(toks[:6], k=1, extract=False).weights)


def test_backend_override_runs_the_fused_superstep(engines, monkeypatch):
    """``backend="cuda"`` asked per call on an engine built for "torch"
    steps through the fused lane-superstep wrapper once per superstep (on
    a CUDA tensor that wrapper launches the kernel) and answers as the
    engine built for "cuda"."""
    _, port, toks = engines
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return fused(*args)

    fused = ls_ops.fused_lane_step
    monkeypatch.setattr(ls_ops, "fused_lane_step", spy)
    query = toks[:3]
    port["torch"].query(query, k=2)
    assert calls == []
    rt = port["torch"].query(query, k=2, backend="cuda")
    assert len(calls) == rt.supersteps > 0
    assert_same_result(rt, port["cuda"].query(query, k=2))
    with pytest.raises(ValueError, match="unknown backend"):
        port["torch"].query(query, k=2, backend="pallas")


@pytest.mark.parametrize("query,k", [([0, 3, 5, 10, 12, 15], 1),
                                     ([0, 15], 5)], ids=["m6k1", "m2k5"])
def test_wide_m_and_k_on_cuda_equal_torch_and_pallas(query, k):
    """Past the old kernel range (m = 6; k = 5): ``backend="cuda"`` (the
    wrappers' plain versions on CPU tensors) answers as ``"torch"`` and as
    ``repro``'s ``"pallas"``, through ``query`` and ``query_batch``, on a
    grid with one token per node."""
    tokens = np.arange(16)[:, None]
    ej = EngineJ.build(gen_j.grid_graph(4, 4), tokens=tokens,
                       policy=PolicyJ(backend="pallas"))
    rj = ej.query(query, k=k)
    assert rj.found
    for backend in TWIN:
        et = EngineT.build(gen_t.grid_graph(4, 4), tokens=tokens,
                           policy=PolicyT(backend=backend), device="cpu")
        assert_same_result(et.query(query, k=k), rj)
        [rb] = et.query_batch([query], k=k)
        assert_same_result(rb, rj)


# ---------------------------------------------------------------------------
# The stepwise surfaces: streams, deadline buckets, executor accounting
# ---------------------------------------------------------------------------

UPDATE_FIELDS = ("step", "frontier", "msgs_bfs", "msgs_deep", "nu_full",
                 "spa", "opt_lower_bound", "sound_opt_lower_bound",
                 "spa_ratio", "done", "unmatched", "proven_optimal")


@pytest.fixture(scope="module")
def stepwise():
    """``repro``'s ``"jnp"`` engine and the port's two backends on
    ``lod_like_graph(600, 1800, seed=11, vocab=120)``."""
    gj, tokens = gen_j.lod_like_graph(600, 1800, seed=11, vocab=120)
    gt, _ = gen_t.lod_like_graph(600, 1800, seed=11, vocab=120)
    ref = EngineJ.build(gj, tokens=tokens, policy=PolicyJ(max_supersteps=32))
    port = {b: EngineT.build(gt, tokens=tokens, policy=PolicyT(
        backend=b, max_supersteps=32), device="cpu") for b in TWIN}
    index = ref.index
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 60]
    return ref, port, toks


def same_updates(got, want):
    assert len(got) == len(want) > 0
    for ut, uj in zip(got, want):
        for f in UPDATE_FIELDS:
            assert getattr(ut, f) == getattr(uj, f), (ut.step, f)
        np.testing.assert_array_equal(ut.weights, uj.weights)
        np.testing.assert_array_equal(ut.roots, uj.roots)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_stream_matches_reference(stepwise, backend):
    """Every update, step by step: weights, roots, frontier, messages,
    ``nu_full``, ``spa``, both running bounds and ``spa_ratio``."""
    ref, port, toks = stepwise
    for query, k in ((toks[0:3], 2), (toks[3:5], 1)):
        got = list(port[backend].query_stream(query, k=k))
        same_updates(got, list(ref.query_stream(query, k=k)))
        assert got[0].step == 0 and got[-1].done
        ratios = [u.spa_ratio for u in got]
        assert all(cur <= prev for prev, cur in zip(ratios, ratios[1:]))
        result = port[backend].query_streamed(query, k=k)
        assert_same_result(result, ref.query_streamed(query, k=k))
        np.testing.assert_array_equal(result.weights, got[-1].weights)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_streamed_until_matches_reference(stepwise, backend):
    ref, port, toks = stepwise
    query = toks[0:3]
    seen_t, seen_j = [], []
    rt = port[backend].query_streamed(
        query, k=2, on_update=seen_t.append, until=lambda u: u.step >= 2)
    rj = ref.query_streamed(
        query, k=2, on_update=seen_j.append, until=lambda u: u.step >= 2)
    same_updates(seen_t, seen_j)
    assert len(seen_t) == 3 and not rt.done and rt.spa is not None
    assert_same_result(rt, rj)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_capped_and_unmatched_streams_match_reference(backend):
    """A superstep cap on a grid (a forced stop, never proven optimal)
    and a query with a token on no node (strict raises at the call, not
    at the first iteration; best-effort reports it on every update)."""
    tokens = np.arange(16)[:, None]
    ej = EngineJ.build(gen_j.grid_graph(4, 4), tokens=tokens)
    et = EngineT.build(gen_t.grid_graph(4, 4), tokens=tokens,
                       policy=PolicyT(backend=backend), device="cpu")
    got = list(et.query_stream([0, 15], k=1, max_supersteps=2))
    same_updates(got, list(ej.query_stream([0, 15], k=1, max_supersteps=2)))
    # The cap fires ``done`` (and ``capped``) but proves nothing.
    assert len(got) == 3 and got[-1].done and not got[-1].proven_optimal
    with pytest.raises(KeyError):
        et.query_stream([0, 99], k=1)
    got = list(et.query_stream([0, 99], k=1, strict=False))
    same_updates(got, list(ej.query_stream([0, 99], k=1, strict=False)))
    assert got[-1].unmatched == (99,) and got[-1].best_weight >= INF


def same_deadline_out(got, want):
    assert len(got) == len(want)
    for pt, pj in zip(got, want):
        if pj is None:
            assert pt is None
            continue
        (rt, it), (rj, ij) = pt, pj
        assert_same_result(rt, rj)
        assert it == ij


@pytest.mark.parametrize("deadline_s", [0.0, 600.0], ids=["at0", "never"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_deadline_batch_matches_reference(stepwise, backend, deadline_s):
    """``deadline_s=0`` interrupts after ``init`` on every backend; 600 s
    is a deadline no run reaches.  Results, per-lane bounds,
    ``interrupted``, ``driver_supersteps`` and the extraction split equal
    ``repro``'s; padding lanes come back as None."""
    ref, port, toks = stepwise
    queries = [toks[0:2], toks[2:4], toks[4:6], toks[1:3]]
    kw = dict(k=2, deadline_s=deadline_s, n_real=3)
    got = port[backend].query_deadline_batch(queries, **kw)
    same_deadline_out(got, ref.query_deadline_batch(queries, **kw))
    assert got[3] is None
    info = got[0][1]
    assert info["interrupted"] == (deadline_s == 0.0)
    if deadline_s == 0.0:
        assert info["driver_supersteps"] == 0
        assert info["extraction"] == {"overlapped": 0, "inline": 0}
    else:
        lanes = [r.supersteps for r, _ in got[:3]]
        assert info["driver_supersteps"] == max(lanes) < sum(lanes)
        assert info["extraction"]["overlapped"] == 3
    one = port[backend].query_deadline(toks[0:3], k=2, deadline_s=deadline_s,
                                       extract_pool=4)
    same_deadline_out([one], [ref.query_deadline(
        toks[0:3], k=2, deadline_s=deadline_s, extract_pool=4)])
    with pytest.raises(ValueError, match="same keyword count"):
        port[backend].query_deadline_batch([toks[0:2], toks[0:3]], k=1,
                                           deadline_s=1.0)
    assert port[backend].query_deadline_batch([], k=1, deadline_s=1.0) == []


def test_executor_accounting_matches_reference(stepwise):
    """``trace_count`` reads as ``repro``'s: 1 for the fused executor, 2
    for the stepwise pair, per (m, k, overrides); ``execute_count``
    counts one per bucket and one per stepwise superstep."""
    gj, tokens = gen_j.lod_like_graph(600, 1800, seed=11, vocab=120)
    gt, _ = gen_t.lod_like_graph(600, 1800, seed=11, vocab=120)
    ref = EngineJ.build(gj, tokens=tokens, policy=PolicyJ(max_supersteps=32))
    port = EngineT.build(gt, tokens=tokens, policy=PolicyT(max_supersteps=32),
                         device="cpu")
    toks = stepwise[2]
    for eng in (port, ref):
        eng.query(toks[0:3], k=2, extract=False)
        eng.query(toks[3:6], k=2, extract=False)
        list(eng.query_stream(toks[0:3], k=2))
        eng.query_deadline(toks[0:2], k=1, deadline_s=600.0, extract=False)
        eng.query(toks[0:2], k=1, extract=False, message_budget=50.0)
    for kind in ("fused", "stepwise"):
        for m, k, over in ((3, 2, {}), (2, 1, {}),
                           (2, 1, {"message_budget": 50.0})):
            assert port.trace_count(m, k, kind=kind, **over) == \
                ref.trace_count(m, k, kind=kind, **over), (kind, m, k, over)
    assert port.trace_count(3, 2, kind="stepwise") == 2
    assert port.cache_stats == ref.cache_stats == {"executables": 4,
                                                   "traces": 6}
    assert port.execute_count == ref.execute_count
    assert port.n_edges == ref.n_edges
