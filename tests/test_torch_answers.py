"""The port's answer subsystem (``repro_torch.answers``) against
``repro.answers`` on the CPU: the split-pair table, the batched
backtrace's candidate and record arrays, the extracted trees and the
tracer's counters, the device-sorted scan order on tied tables and past
the candidate window, diversified ranking, rendering / pagination,
streaming extraction, and ``QueryEngine.query_batch`` with the batched
extraction on and off.

Reference tables come straight off ``repro``'s fused lane driver, as in
``tests/test_answers.py``.  On the CPU the ``"cuda"`` backtracer's wrapper
runs the kernel's plain version; ``"torch"`` calls that version directly.
Tolerance: none — the records are integers, every compared value a min,
a compare or one f32 add, and the trees are host code on equal inputs.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import answers as ans_j
from repro.core.reconstruct import AnswerTree as TreeJ
from repro.core.reconstruct import backtrace as backtrace_j
from repro.core.reconstruct import collect_answers as collect_j
from repro.engine import ExecutionPolicy as PolicyJ
from repro.engine import QueryEngine as EngineJ
from repro.graph import generators as gen_j
from repro.graph import structure as st_j

from repro_torch import INF
from repro_torch import answers as ans_t
from repro_torch.core.reconstruct import AnswerTree as TreeT
from repro_torch.core.reconstruct import HostScan
from repro_torch.core.reconstruct import backtrace as backtrace_t
from repro_torch.core.reconstruct import collect_answers as collect_t
from repro_torch.engine import ExecutionPolicy as PolicyT
from repro_torch.engine import QueryEngine as EngineT
from repro_torch.engine import engine as engine_t
from repro_torch.graph import generators as gen_t
from repro_torch.graph import structure as st_t
from repro_torch.kernels.batched_backtrace import ops as bt_ops

RECORDS = ("cand_idx", "cand_val", "fail", "node", "kind", "child0",
           "child1", "edge_u")
TIGHT = {"degree_cap": 1, "buffer": 3}


def lane_tables(g, masks_host, k, L=4, max_supersteps=24):
    """Final lane-batched tables straight off ``repro``'s fused driver."""
    engine = EngineJ.build(
        g, tokens=np.zeros((g.n_nodes, 1), np.int64),
        policy=PolicyJ(max_supersteps=max_supersteps))
    m = masks_host.shape[0]
    kw = np.zeros((L, m, engine.device_graph.v_pad), bool)
    kw[:, :, : g.n_nodes] = masks_host
    fn = engine._executable(engine._config(m, k), "fused")
    states = engine._execute(fn, engine.device_graph, jnp.asarray(kw))
    return np.array(states.S), kw


@functools.lru_cache(maxsize=None)
def seeded_case(seed):
    """``tests/test_answers.py``'s random bucket: both graphs, the host
    masks, k and the reference tables."""
    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(10, 24))
    e = n + int(rng.integers(6, 30))
    gj = gen_j.random_weighted_graph(n, e, seed=seed)
    gt = gen_t.random_weighted_graph(n, e, seed=seed)
    m = int(rng.integers(2, 4))
    k = int(rng.integers(1, 4))
    masks_host = np.zeros((m, n), bool)
    for t in range(m):
        masks_host[t, rng.choice(n, size=max(1, n // 4), replace=False)] = True
    S_all, kw = lane_tables(gj, masks_host, k)
    return gj, gt, masks_host, k, S_all, kw


def key(tree):
    return (tree.root, tree.edges, tree.weight, tree.raw_value, tree.nodes)


def same_answers(got, want):
    assert len(got) == len(want)
    for (ans, ex), (ref, ex_ref) in zip(got, want):
        assert [key(a) for a in ans] == [key(a) for a in ref]
        assert ex == ex_ref


# -- device-batched backtrace ------------------------------------------


@pytest.mark.parametrize("m", range(1, 7))
def test_split_pair_table_equals_reference(m):
    for a, b in zip(ans_t.split_pair_table(m), ans_j.split_pair_table(m)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("caps", [{}, TIGHT], ids=["default", "tight"])
@pytest.mark.parametrize("seed", range(6))
def test_backtrace_records_and_trees_equal_reference(seed, caps):
    """The record arrays, the extracted trees, ``exhausted`` and
    ``stats()`` equal ``repro``'s and the host collector's, on both
    backends; rows of a lane's table reach the host only for its
    stragglers, and never the whole table."""
    gj, gt, masks_host, k, S_all, kw = seeded_case(seed)
    n = gt.n_nodes
    ref = ans_j.BatchedBacktracer(gj, **caps)
    want_recs = ref.backtrace_lanes(S_all, kw, k)
    want = ref.extract_lanes(S_all, kw, k=k, n_nodes=n)
    host = [collect_t(S_all[lane], gt, masks_host, k=k)
            for lane in range(S_all.shape[0])]
    same_answers(want, [collect_j(S_all[lane], gj, masks_host, k=k)
                        for lane in range(S_all.shape[0])])
    for backend in ("cuda", "torch"):
        bt = ans_t.BatchedBacktracer(gt, device="cpu", backend=backend,
                                     **caps)
        launched = bt_ops.launches
        recs = bt.backtrace_lanes(torch.from_numpy(S_all), kw, k)
        for name in RECORDS:
            got_a, want_a = getattr(recs, name), getattr(want_recs, name)
            np.testing.assert_array_equal(got_a, want_a, err_msg=name)
            assert got_a.dtype == want_a.dtype, name
        got = bt.extract_lanes(torch.from_numpy(S_all), kw, k=k, n_nodes=n)
        same_answers(got, want)
        same_answers(got, host)
        assert bt.stats() == ref.stats()
        assert bt_ops.launches == launched  # the CPU path launches nothing
        assert bt.table_copies == 0
        assert bt.rows_fetched == 0 or bt.host_fallbacks > 0
        assert bt.rows_fetched <= S_all.shape[0] * n
    if not caps:
        assert ref.device_resolved > 0
    else:
        assert ref.host_fallbacks > 0


@pytest.mark.parametrize("seed", range(4))
def test_host_backtrace_equals_reference(seed):
    """The host search the stragglers take (its edge scan one numpy pass
    per node) finds ``repro``'s tree, or its None, for every finite cell of
    a final table and for values with no decomposition."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        gj = gen_j.random_weighted_graph(30, 80, seed=seed)
        gt = gen_t.random_weighted_graph(30, 80, seed=seed)
    else:
        gj, _ = gen_j.lod_like_graph(120, 500, seed=seed, vocab=20)
        gt, _ = gen_t.lod_like_graph(120, 500, seed=seed, vocab=20)
    n = gt.n_nodes
    m, k = 2 + seed % 2, 1 + seed
    masks_host = rng.random((m, n)) < 0.08
    S = lane_tables(gj, masks_host, k, L=1, max_supersteps=32)[0][0]
    found = 0
    for v in range(n):
        for ks in range(1, 1 << m):
            for val in {*S[v, ks].tolist(), 0.5, float(rng.integers(1, 9))}:
                if val >= INF:
                    continue
                got = backtrace_t(S, gt, masks_host, v, ks, val)
                assert got == backtrace_j(S, gj, masks_host, v, ks, val)
                found += got is not None
    assert found > 0


def test_device_sort_is_the_stable_argsort_on_ties():
    """Many equal values and INF padding: the stable device sort walks the
    cells in ``np.argsort(kind="stable")``'s order, so the device scan is
    the host scan."""
    rng = np.random.default_rng(0)
    col = rng.integers(0, 4, size=(500, 6)).astype(np.float32)
    col[rng.random(col.shape) < 0.4] = INF
    vals, idx = torch.sort(torch.from_numpy(col).reshape(-1), stable=True)
    host = HostScan(col)
    np.testing.assert_array_equal(idx.numpy(), host.order)
    scan = ans_t.batched._DeviceScan(vals, idx, 6, vals[:7].numpy(),
                                     idx[:7].numpy())
    assert [scan[p] for p in range(len(col) * 6)] == \
        [host[p] for p in range(len(col) * 6)]


def test_tied_ring_extracts_as_reference():
    """A unit ring with keywords at opposite nodes: every node roots a
    tree of weight 20 and the K=5 slots tie; the device order picks the
    same cells as the host and ``repro``."""
    n = 40
    src = np.arange(n)
    dst = (src + 1) % n
    w = np.ones(n, np.float32)
    gj = st_j.build_graph(src, dst, n, w=w)
    gt = st_t.build_graph(src, dst, n, w=w)
    masks_host = np.zeros((2, n), bool)
    masks_host[0, [0, 10]] = True
    masks_host[1, [20, 30]] = True
    S_all, kw = lane_tables(gj, masks_host, k=5, L=2, max_supersteps=48)
    ref = ans_j.BatchedBacktracer(gj)
    bt = ans_t.BatchedBacktracer(gt, device="cpu")
    want = ref.extract_lanes(S_all, kw, k=5, n_nodes=n)
    same_answers(bt.extract_lanes(S_all, kw, k=5, n_nodes=n), want)
    same_answers(want, [collect_t(S_all[lane], gt, masks_host, k=5)
                        for lane in range(2)])
    assert bt.stats() == ref.stats()


@pytest.mark.parametrize("factor", [1, 4])
def test_refill_past_the_window(factor):
    """``tests/test_reconstruct.py``'s cases: a path whose best cells all
    collapse to one chain (the scan refills past the candidates, fetching
    further chunks of the device order), and a single edge that cannot
    give k=5 trees (exhausted)."""
    for src, dst, n, groups, k in (([0, 1, 2, 3], [1, 2, 3, 4], 5,
                                    [[0], [4]], 3),
                                   ([0], [1], 2, [[0], [1]], 5)):
        w = np.ones(len(src), np.float32)
        gj = st_j.build_graph(src, dst, n, w=w)
        gt = st_t.build_graph(src, dst, n, w=w)
        masks_host = np.zeros((2, n), bool)
        for t, nodes in enumerate(groups):
            masks_host[t, nodes] = True
        S_all, kw = lane_tables(gj, masks_host, k=k, L=1, max_supersteps=32)
        ref = ans_j.BatchedBacktracer(gj)
        bt = ans_t.BatchedBacktracer(gt, device="cpu")
        want = ref.extract_lanes(S_all, kw, k=k, candidate_factor=factor,
                                 n_nodes=n)
        got = bt.extract_lanes(S_all, kw, k=k, candidate_factor=factor,
                               n_nodes=n)
        same_answers(got, want)
        same_answers(got, [collect_t(S_all[0], gt, masks_host, k=k,
                                     candidate_factor=factor)])
        assert got[0][1]  # exhausted: one tree in the table
        assert bt.stats() == ref.stats()
        assert bt.table_copies == 0
        assert bt.rows_fetched == 0 or bt.host_fallbacks > 0
        assert bt.rows_fetched <= n


def test_backtrace_wrapper_checks_inputs():
    gj, gt, masks_host, k, S_all, kw = seeded_case(0)
    bt = ans_t.BatchedBacktracer(gt, device="cpu")
    S = torch.from_numpy(S_all)
    L, vp, n_sets, K = S.shape
    args = [torch.zeros(L, 1, dtype=torch.int32), torch.zeros(L, 1),
            bt._indptr, bt._esrc, bt._ew]
    pa, pb = (torch.from_numpy(t)
              for t in ans_t.split_pair_table(kw.shape[1]))
    with pytest.raises(ValueError, match="kw must be"):
        bt_ops.batched_backtrace(S, torch.from_numpy(kw).int(), *args, pa, pb,
                                 64, 8)
    with pytest.raises(ValueError, match="contiguous"):
        bt_ops.batched_backtrace(S, torch.from_numpy(kw), *args,
                                 pa.t().contiguous().t(), pb, 64, 8)
    # Past the kernel's range a tensor off the CPU is refused before any
    # launch; the plain version takes any m and K.
    meta = [t.to("meta") for t in args]
    for shape, m, what in (((1, 4, 128, 2), 7, "m <= 6"),
                           ((1, 4, 4, 9), 2, "k <= 8")):
        pm, qm = (torch.from_numpy(t).to("meta")
                  for t in ans_t.split_pair_table(m))
        with pytest.raises(ValueError, match=what):
            bt_ops.batched_backtrace(
                torch.zeros(shape, device="meta"),
                torch.zeros(1, m, 4, dtype=torch.bool, device="meta"),
                *(t[:1] if t.dim() == 2 else t for t in meta), pm, qm, 64, 8)


# -- diversified ranking, rendering, streaming --------------------------


def trees(lib):
    def tree(root, edges, weight):
        nodes = tuple(sorted({n for e in edges for n in e} | {root}))
        return lib(root=root, edges=tuple(sorted(edges)), weight=weight,
                   raw_value=weight, nodes=nodes)

    return [tree(0, [(0, 1), (1, 2)], 2.0), tree(0, [(0, 1), (1, 3)], 2.1),
            tree(7, [(7, 8), (8, 9)], 2.2), tree(0, [(0, 1), (1, 4)], 2.3),
            tree(0, [(0, 1), (1, 2)], 2.0), tree(7, [(7, 8)], 3.0),
            tree(3, [], 0.0)]


def test_diversify_equals_reference():
    tj, tt = trees(TreeJ), trees(TreeT)
    for i in range(len(tj)):
        for j in range(len(tj)):
            assert ans_t.tree_distance(tt[i], tt[j]) == \
                ans_j.tree_distance(tj[i], tj[j])
    for lam in (0.0, 0.5, 1.0):
        assert ans_t.diversified_order(tt, lam) == \
            ans_j.diversified_order(tj, lam)
        for k in (0, 2, 5):
            assert [key(t) for t in ans_t.top_k_diverse(tt, k, lam)] == \
                [key(t) for t in ans_j.top_k_diverse(tj, k, lam)]
    for th in (0.3, 0.6, 1.0):
        assert ans_t.cluster_trees(tt, th) == ans_j.cluster_trees(tj, th)
    with pytest.raises(ValueError):
        ans_t.diversified_order(tt, lambda_=1.5)
    assert ans_t.diversified_order([], 0.5) == []


def test_render_and_paginate_equal_reference():
    gj = gen_j.random_weighted_graph(10, 20, seed=1)
    gt = gen_t.random_weighted_graph(10, 20, seed=1)
    tj, tt = trees(TreeJ)[:4], trees(TreeT)[:4]
    labels = {i: f"entity-{i}" for i in range(10)}
    for cursor, size, fn, g in ((0, 2, labels.get, True),
                                (2, 2, None, False), (99, 2, None, True),
                                (1, 0, labels.get, True)):
        pj = ans_j.paginate(tj, [0, 2, 1, 3], cursor=cursor, page_size=size,
                            ranking="diverse", exhausted=False, label_fn=fn,
                            graph=gj if g else None)
        pt = ans_t.paginate(tt, [0, 2, 1, 3], cursor=cursor, page_size=size,
                            ranking="diverse", exhausted=False, label_fn=fn,
                            graph=gt if g else None)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        assert [t.describe() for t in pt.items] == \
            [t.describe() for t in pj.items]
    single = trees(TreeT)[-1]
    assert "single node" in ans_t.render_tree(single).describe()
    assert ans_t.default_label(4) == ans_j.default_label(4)


def test_extraction_overlap_equals_reference():
    rng = np.random.default_rng(7)
    n = 12
    gj = gen_j.random_weighted_graph(n, 30, seed=3)
    gt = gen_t.random_weighted_graph(n, 30, seed=3)
    masks_host = np.zeros((2, n), bool)
    masks_host[0, rng.choice(n, 3, replace=False)] = True
    masks_host[1, rng.choice(n, 3, replace=False)] = True
    S_all, _ = lane_tables(gj, masks_host, k=2, L=3)
    with ans_j.ExtractionOverlap(gj, k=2) as oj, \
            ans_t.ExtractionOverlap(gt, k=2) as ot:
        for ov, S in ((oj, S_all), (ot, torch.from_numpy(S_all))):
            ov.submit(0, S[0], masks_host)
            ov.submit(0, S[0], masks_host)  # idempotent per lane
            ov.submit(1, S[1], masks_host)
        assert ot.pending(0) and ot.pending(1) and not ot.pending(2)
        for lane in (0, 1):
            same_answers([ot.result(lane)], [oj.result(lane)])
        same_answers([ot.result(2, torch.from_numpy(S_all[2]), masks_host)],
                     [oj.result(2, S_all[2], masks_host)])
        assert ot.stats() == oj.stats() == {"overlapped": 2, "inline": 1}
        with pytest.raises(ValueError):
            ot.result(9)


# -- the engine ----------------------------------------------------------


@pytest.fixture(scope="module")
def typed_engines():
    rng = np.random.default_rng(3)
    n = 60
    src, dst = rng.integers(0, n, 200), rng.integers(0, n, 200)
    pred = rng.integers(0, 3, 200)
    conf = rng.uniform(0.05, 1.0, 200).astype(np.float32)
    names = ["knows", "funds", "cites"]
    gj = st_j.build_graph(src, dst, n, pred=pred, conf=conf,
                          pred_names=names)
    gt = st_t.build_graph(src, dst, n, pred=pred, conf=conf,
                          pred_names=names)
    tokens = rng.integers(0, 12, size=(n, 2))
    ej = EngineJ.build(gj, tokens=tokens, policy=PolicyJ(max_supersteps=24))
    ports = {b: EngineT.build(gt, tokens=tokens, policy=PolicyT(
        backend=b, max_supersteps=24), device="cpu") for b in ("torch",
                                                               "cuda")}
    return ej, ports


QUERIES = [[1, 5], [2, 7], [3, 9], [0, 4, 8], [6, 10], [11, 2, 5]]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_query_batch_extraction_equals_reference(typed_engines, backend,
                                                 monkeypatch):
    """``query_batch`` through the batched backtracer (no row of a table
    reaches the host when no lane straggles, and never a whole table) and
    through the host collector both
    answer as ``repro``'s, with its ``extraction_stats``."""
    ej, ports = typed_engines
    et = EngineT.build(ports[backend].graph, index=ports[backend].index,
                       policy=ports[backend].policy, device="cpu")
    assert et.extraction_stats == {"device_resolved": 0, "host_fallbacks": 0}
    before = ej.extraction_stats
    want = ej.query_batch(QUERIES, k=3, extract_pool=4)
    ext = {n: ej.extraction_stats[n] - before[n] for n in before}
    assert ext["device_resolved"] > 0

    def no_host_collector(*args, **kwargs):
        raise AssertionError("the host collector ran on a batched bucket")

    with monkeypatch.context() as mp:
        mp.setattr(engine_t, "collect_answers", no_host_collector)
        got = et.query_batch(QUERIES, k=3, extract_pool=4)
    assert et.extraction_stats == ext
    bt = et._backtracer()
    assert bt.backend == backend
    assert bt.table_copies == 0
    assert bt.rows_fetched == 0 or ext["host_fallbacks"] > 0
    et.batched_extraction = False
    host = et.query_batch(QUERIES, k=3, extract_pool=4)
    assert et.extraction_stats == ext
    for rt, rh, rj in zip(got, host, want):
        for r in (rt, rh):
            np.testing.assert_array_equal(r.weights, rj.weights)
            assert [key(a) for a in r.answers] == [key(a) for a in rj.answers]
            assert [key(a) for a in r.answer_pool] == \
                [key(a) for a in rj.answer_pool]
            assert (r.answers_exhausted, r.pool_exhausted) == \
                (rj.answers_exhausted, rj.pool_exhausted)
    found = [r for r in got if r.found]
    assert found
    for r in found:
        for a in r.answers:
            for u, v in a.edges:
                assert et.edge_info(u, v) == ej.edge_info(u, v)
                assert et.edge_info(u, v)[0] in ("knows", "funds", "cites")
            assert [et.node_label(x) for x in a.nodes] == \
                [ej.node_label(x) for x in a.nodes]
    assert et.edge_info(0, 0) is None


def test_node_label_uses_graph_labels():
    g = gen_t.grid_graph(2, 2)
    g.labels = ["a b", "b c", "c d", "d a"]
    eng = EngineT.build(g, device="cpu")
    assert [eng.node_label(v) for v in range(4)] == g.labels
    g2 = gen_t.grid_graph(2, 2)
    eng2 = EngineT.build(g2, tokens=np.arange(4)[:, None], device="cpu")
    assert eng2.node_label(3) == "node:3"
    assert eng2.edge_info(0, 1) is None  # untyped
