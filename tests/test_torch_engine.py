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
