"""Port parity, host graph layer: graph build, weight policies, generators,
the inverted index, ``to_device`` and the interop carriers give arrays
identical to ``repro``'s from identical seeds and inputs."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.graph import generators as gen_j
from repro.graph import structure as st_j
from repro.graph import weights as wt_j
from repro.graph.index import InvertedIndex as IndexJ
from repro.graph.index import mid_df_tokens as mid_df_j

from repro_torch import INF as INF_T
from repro_torch import interop
from repro_torch.graph import generators as gen_t
from repro_torch.graph import structure as st_t
from repro_torch.graph import weights as wt_t
from repro_torch.graph.index import InvertedIndex as IndexT
from repro_torch.graph.index import mid_df_tokens as mid_df_t
from repro_torch.kernels.lane_superstep import ops as ls_ops

GRAPH_FIELDS = [f.name for f in dataclasses.fields(st_j.Graph)]


def assert_same_graph(gj, gt):
    for name in GRAPH_FIELDS:
        a, b = getattr(gj, name), getattr(gt, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.dtype == b.dtype, name
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert a == b, name


def typed_graph(lib):
    rng = np.random.default_rng(3)
    n = 40
    src = rng.integers(0, n, 120)
    dst = rng.integers(0, n, 120)
    pred = rng.integers(0, 3, 120)
    conf = rng.uniform(0.05, 1.0, 120).astype(np.float32)
    return lib.build_graph(src, dst, n, pred=pred, conf=conf,
                           pred_names=["knows", "funds", "cites"])


def test_inf_sentinel_matches():
    from repro import INF as INF_J
    assert INF_T == INF_J


def test_rmat_edges_identical():
    for seed in (0, 5):
        sj, dj = gen_j.rmat_edges(300, 1000, seed=seed)
        s_t, d_t = gen_t.rmat_edges(300, 1000, seed=seed)
        np.testing.assert_array_equal(sj, s_t)
        np.testing.assert_array_equal(dj, d_t)


@pytest.mark.parametrize("make", [
    lambda lib: lib.lod_like_graph(250, 900, seed=11, vocab=60, tau=20),
    lambda lib: (lib.random_weighted_graph(60, 140, seed=2), None),
    lambda lib: (lib.grid_graph(5, 7, w=2.0), None),
], ids=["lod_like", "random_weighted", "grid"])
def test_generators_identical(make):
    gj, tj = make(gen_j)
    gt, tt = make(gen_t)
    assert_same_graph(gj, gt)
    if tj is not None:
        np.testing.assert_array_equal(tj, tt)


def test_degree_weights_and_typed_build_identical():
    dst = np.random.default_rng(0).integers(0, 50, 400).astype(np.int32)
    np.testing.assert_array_equal(st_j.degree_weights(dst, 50, tau=12),
                                  st_t.degree_weights(dst, 50, tau=12))
    assert st_j.MIN_EDGE_WEIGHT == st_t.MIN_EDGE_WEIGHT
    assert_same_graph(typed_graph(st_j), typed_graph(st_t))


@pytest.mark.parametrize("kw", [
    dict(kind="confidence", blend=1.0),
    dict(kind="confidence", blend=0.5, predicates=("knows", "cites")),
    dict(predicates=("funds",)),
])
def test_weight_policy_identical(kw):
    gj = wt_j.apply_weight_policy(typed_graph(st_j), wt_j.WeightPolicy(**kw))
    gt = wt_t.apply_weight_policy(typed_graph(st_t), wt_t.WeightPolicy(**kw))
    assert_same_graph(gj, gt)
    dj = gj.to_device()
    dt = gt.to_device(device="cpu")
    np.testing.assert_array_equal(np.asarray(dj.w), dt.w.numpy())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kind="confidence", blend=1.0),
    dict(predicates=("funds",)),
])
def test_typed_artifact_weight_policy_identical(tmp_path, kw):
    """A typed (format v2) artifact written by repro opens in the port
    with its predicate table and typed buffers, and the port's engine
    packs the same effective weights as repro's under every policy."""
    from repro.engine import ExecutionPolicy as PolicyJ
    from repro.engine import QueryEngine as EngineJ
    from repro.store import write_artifact as write_artifact_j

    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.store import open_artifact

    tokens = np.arange(40, dtype=np.int32).reshape(40, 1)
    gj = typed_graph(st_j)   # the writer caches its sorted layouts
    art_j = write_artifact_j(tmp_path / "typed", gj,
                             IndexJ.from_token_matrix(tokens))
    art = open_artifact(art_j.path, verify="full")
    assert art.typed and art.predicates == ["knows", "funds", "cites"]
    assert art.content_hash == art_j.content_hash
    assert_same_graph(gj, art.graph())
    ej = EngineJ.build(artifact=art_j,
                       policy=PolicyJ(weights=wt_j.WeightPolicy(**kw)))
    et = QueryEngine.build(artifact=art, device="cpu", policy=ExecutionPolicy(
        weights=wt_t.WeightPolicy(**kw)))
    np.testing.assert_array_equal(np.asarray(ej.device_graph.w),
                                  et.device_graph.w.numpy())
    assert et.edge_info(int(art.graph().src[0]), int(art.graph().dst[0])) \
        == ej.edge_info(int(art.graph().src[0]), int(art.graph().dst[0]))


def test_v1_artifact_opens_and_serves_bit_identically(tmp_path):
    """An untyped artifact whose manifest says format v1 (the pre-typed
    layout) opens in the port, and its engine answers as the in-memory
    build and as repro's engine on it under the default WeightPolicy;
    non-default policies need the typed channel it lacks."""
    import json

    from repro.engine import QueryEngine as EngineJ
    from repro.store import open_artifact as open_artifact_j

    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.store import from_graph, open_artifact, write_artifact

    g, tokens = gen_t.lod_like_graph(400, 1200, seed=5, vocab=80)
    result = from_graph(g, tokens=tokens)
    art = write_artifact(tmp_path / "a", result.graph, result.index)
    assert art.format_version == 2 and not art.typed
    manifest = json.loads((art.path / "manifest.json").read_text())
    manifest["format_version"] = 1
    (art.path / "manifest.json").write_text(json.dumps(manifest))

    reopened = open_artifact(art.path)
    assert reopened.format_version == 1
    assert not reopened.typed and reopened.predicates == []
    e_mem = QueryEngine.build(g, index=result.index, device="cpu")
    e_art = QueryEngine.build(artifact=reopened, device="cpu")
    ref = EngineJ.build(artifact=open_artifact_j(art.path))
    toks = sorted(result.index.vocabulary(), key=result.index.df)
    q = [t for t in toks if 2 <= result.index.df(t) <= 40][:3]
    r_mem, r_art = (e.query(q, k=2, extract=False) for e in (e_mem, e_art))
    r_ref = ref.query(q, k=2, extract=False)
    for other in (r_mem, r_ref):
        np.testing.assert_array_equal(r_art.weights, other.weights)
        assert r_art.supersteps == other.supersteps
    with pytest.raises(ValueError, match="typed"):
        QueryEngine.build(artifact=reopened, device="cpu",
                          policy=ExecutionPolicy(
                              weights=wt_t.WeightPolicy(kind="confidence")))


@pytest.mark.parametrize("pad", [(None, None), (260, 2100)])
def test_to_device_identical(pad):
    gj, _ = gen_j.lod_like_graph(250, 900, seed=4, vocab=30)
    gt, _ = gen_t.lod_like_graph(250, 900, seed=4, vocab=30)
    dj = gj.to_device(pad_nodes_to=pad[0], pad_edges_to=pad[1])
    dt = gt.to_device(device="cpu", pad_nodes_to=pad[0], pad_edges_to=pad[1])
    for name in ("src", "dst", "w", "valid", "out_degree", "node_valid"):
        a, b = np.asarray(getattr(dj, name)), getattr(dt, name).numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    assert (dj.n_nodes, dj.n_edges, dj.v_pad, dj.e_pad) == \
        (dt.n_nodes, dt.n_edges, dt.v_pad, dt.e_pad)
    assert float(dj.e_min()) == float(dt.e_min())


def test_in_edge_offsets_cover_each_nodes_real_in_edges():
    gt, _ = gen_t.lod_like_graph(250, 900, seed=4, vocab=30)
    dt = gt.to_device(device="cpu", pad_nodes_to=260, pad_edges_to=2100)
    off = dt.in_offsets
    assert off.dtype == torch.int64 and off.shape == (dt.v_pad + 1,)
    assert int(off[-1]) == dt.n_edges
    dst = dt.dst.numpy()
    for v in range(dt.v_pad):
        assert np.all(dst[off[v]:off[v + 1]] == v)


def hubs_by_definition(in_offsets):
    """The nodes with more than HUB_IN_DEGREE in-edges, most first, ties by
    id: the list the lane-superstep kernel gives a warp each."""
    deg = np.diff(np.asarray(in_offsets))
    hubs = [v for v in range(len(deg)) if deg[v] > st_t.HUB_IN_DEGREE]
    return np.array(sorted(hubs, key=lambda v: (-deg[v], v)), np.int32)


@pytest.mark.parametrize("make,n_hubs", [
    (lambda: gen_t.lod_like_graph(3000, 40000, seed=1, vocab=40,
                                  tau=300)[0], 422),
    (lambda: gen_t.grid_graph(5, 7, w=2.0), 0),
], ids=["lod_like", "grid"])
def test_hub_nodes_are_the_nodes_past_the_in_degree_threshold(make, n_hubs):
    g = make()
    dt = g.to_device(device="cpu", pad_nodes_to=g.n_nodes + 5)
    hubs = dt.hub_nodes
    assert hubs.dtype == torch.int32 and hubs.shape == (n_hubs,)
    np.testing.assert_array_equal(hubs.numpy(),
                                  hubs_by_definition(dt.in_offsets))
    # The ops-module helper gives the same list for the full edge list.
    got = ls_ops.hub_nodes(dt.in_offsets)
    assert got.dtype == torch.int32
    assert torch.equal(got, hubs)


def test_hub_helper_follows_cut_edge_lists():
    """Offsets of a cut edge list (finite weights only, then the in-edges
    of light nodes only) get their own list, by the same definition."""
    g, _ = gen_t.lod_like_graph(3000, 40000, seed=1, vocab=40, tau=300)
    dt = g.to_device(device="cpu")
    n_e = dt.n_edges
    dst = dt.dst[:n_e].long()
    finite = dt.w[:n_e] < INF_T / 2
    deg = torch.bincount(dst[finite], minlength=dt.v_pad)
    for keep in (finite, finite & (deg[dst] <= 100)):
        off = torch.zeros(dt.v_pad + 1, dtype=torch.int64)
        off[1:] = torch.cumsum(torch.bincount(dst[keep], minlength=dt.v_pad),
                               0)
        got = ls_ops.hub_nodes(off)
        np.testing.assert_array_equal(got.numpy(), hubs_by_definition(off))
        assert 0 < got.numel() < dt.hub_nodes.numel()
    assert ls_ops.hub_nodes(torch.zeros(9, dtype=torch.int64)).numel() == 0


def test_inverted_index_identical():
    _, tokens = gen_j.lod_like_graph(200, 600, seed=9, vocab=50)
    ij = IndexJ.from_token_matrix(tokens)
    it = IndexT.from_token_matrix(tokens)
    pj, pt = ij.to_postings(), it.to_postings()
    assert pj[0] == pt[0]
    np.testing.assert_array_equal(pj[1], pt[1])
    np.testing.assert_array_equal(pj[2], pt[2])
    assert mid_df_j(ij, 2, 20) == mid_df_t(it, 2, 20)
    query = mid_df_t(it, 2, 20)[:3] + [10_000]
    np.testing.assert_array_equal(
        ij.keyword_masks(query, 200, v_pad=210, on_missing="ignore"),
        it.keyword_masks(query, 200, v_pad=210, on_missing="ignore"))
    assert ij.missing_tokens(query) == it.missing_tokens(query) == [10_000]
    with pytest.raises(KeyError):
        it.keyword_masks(query, 200)
    carried = interop.index_from_postings(*pj)
    assert carried.token_dfs() == it.token_dfs()
    labels = ["Paris piano", "piano bar", "paris", "Bar"]
    lj, lt = IndexJ.from_labels(labels), IndexT.from_labels(labels)
    assert {t: list(lj.lookup(t)) for t in lj.vocabulary()} == \
        {t: list(lt.lookup(t)) for t in lt.vocabulary()}


def test_graph_from_numpy_carries_every_field():
    gj = typed_graph(st_j)
    gt = interop.graph_from_numpy(
        {f: getattr(gj, f) for f in GRAPH_FIELDS})
    assert_same_graph(gj, gt)
    assert gt.indptr is not gj.indptr  # copied, not shared
    with pytest.raises(ValueError):
        interop.graph_from_numpy({"n_nodes": 1, "bogus": 2})
