"""The port at the paper's bluk-bnb scale, held against ``repro`` on the
CPU at sizes a test can afford:

- (a) ``message_counts`` past 2^24: the port counts exactly (an int64 sum
  rounded to f32 once); ``repro``'s inline f32 sum (``repro/core/dks.py``,
  ``superstep``) is shown beside it;
- (b) the ``"torch"`` relax over chunks of edges equals the unchunked relax
  and ``repro``'s ``relax``, exactly, at forced chunk sizes;
- (c) the stragglers' row-wise view of a lane's table gives the trees and
  counters of a whole-table copy, and copies no whole table;
- (d) ``bluk-bnb-cpu`` through both engines with the port's relax at a
  small forced chunk.

Tolerance: none.  Every lattice value is a min, a compare or one f32 add,
and a message count is an integer rounded to f32 once.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import answers as ans_j
from repro.configs.dks_paper import BLUK_BNB_CPU as BLUK_J
from repro.core import dks as dks_j
from repro.core import driver as drv_j
from repro.engine import ExecutionPolicy as PolicyJ
from repro.engine import QueryEngine as EngineJ
from repro.graph.generators import lod_like_graph as lod_j

from repro_torch import answers as ans_t
from repro_torch import interop
from repro_torch.configs import BLUK_BNB_CPU
from repro_torch.core import dks as dks_t
from repro_torch.core.reconstruct import collect_answers as collect_t
from repro_torch.engine import ExecutionPolicy as PolicyT
from repro_torch.engine import QueryEngine as EngineT
from repro_torch.graph.generators import lod_like_graph as lod_t
from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
from repro_torch.kernels.subset_combine.ref import subset_combine_ref

BIG = 1 << 24
M, K, LANES = 3, 3, 3


def crafted_counts(big_first: bool):
    """One node of out-degree 2^24 and 1,000 of degree 1, all firing: lane
    0 first-time fires (BFS), lane 1 re-fires (deep)."""
    deg = np.ones(1001, np.int32)
    deg[0 if big_first else -1] = BIG
    fire = np.ones((2, 1001), bool)
    first = fire.copy()
    first[1] = False
    return deg, fire, first


def repro_counts(deg, fire, first):
    """``repro``'s inline count (``repro/core/dks.py``, ``superstep``) on
    the CPU, one lane at a time as its ``vmap`` runs it."""
    d = jnp.asarray(deg).astype(jnp.float32)
    out = []
    for lane in range(fire.shape[0]):
        ff, ch = jnp.asarray(first[lane]), jnp.asarray(fire[lane])
        out.append((float(jnp.sum(jnp.where(ff, d, 0.0))),
                    float(jnp.sum(jnp.where(ch & ~ff, d, 0.0)))))
    return out


@pytest.mark.parametrize("big_first", [True, False])
def test_message_counts_exact_past_2_24(big_first):
    deg, fire, first = crafted_counts(big_first)
    graph = types.SimpleNamespace(out_degree=torch.from_numpy(deg))
    state = types.SimpleNamespace(changed=torch.from_numpy(fire),
                                  first_fire=torch.from_numpy(first))
    n_bfs, n_deep = dks_t.message_counts(graph, state)
    assert n_bfs.dtype == n_deep.dtype == torch.float32
    exact = int(deg.astype(np.int64).sum())
    assert exact == BIG + 1000 and exact > BIG
    ref = repro_counts(deg, fire, first)
    print(f"big_first={big_first}: exact {exact}, port "
          f"{float(n_bfs[0])} / {float(n_deep[1])}, repro (XLA CPU) "
          f"{ref[0][0]} / {ref[1][1]}")
    assert float(n_bfs[0]) == float(np.float32(exact))
    assert float(n_deep[1]) == float(np.float32(exact))
    assert float(n_bfs[1]) == float(n_deep[0]) == 0.0


def test_message_counts_equal_reference_below_2_24():
    """Random degrees and fires: below 2^24 the exact count is ``repro``'s
    f32 sum, whatever the order."""
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 5000, 3001).astype(np.int32)
    fire = rng.random((4, 3001)) < 0.6
    first = fire & (rng.random((4, 3001)) < 0.5)
    n_bfs, n_deep = dks_t.message_counts(
        types.SimpleNamespace(out_degree=torch.from_numpy(deg)),
        types.SimpleNamespace(changed=torch.from_numpy(fire),
                              first_fire=torch.from_numpy(first)))
    ref = repro_counts(deg, fire, first)
    assert [(float(b), float(d)) for b, d in zip(n_bfs, n_deep)] == ref


# --------------------------------------------------------------------------
# (b) the relax over chunks of edges
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def graphs():
    """A lod-like graph of a few thousand edges (hubs of in-degree past
    ``HUB_IN_DEGREE``) in both packages, host and device."""
    gj, _ = lod_j(800, 3000, seed=11, vocab=40, tau=60)
    gt, _ = lod_t(800, 3000, seed=11, vocab=40, tau=60)
    return gj, gt, gj.to_device(), gt.to_device(device="cpu")


@functools.lru_cache(maxsize=None)
def mid_run():
    """A 3-lane m = 3, K = 3 state two supersteps in on :func:`graphs`, off
    ``repro``'s driver and carried to the port through interop."""
    _, _, dj, dt = graphs()
    cfg = dks_j.DKSConfig(m=M, k=K)
    rng = np.random.default_rng(5)
    masks = np.zeros((LANES, M, dj.v_pad), bool)
    for lane in range(LANES):
        for kw in range(M):
            masks[lane, kw, rng.choice(dj.n_nodes, 5, replace=False)] = True
    st = drv_j.lane_init(dj, jnp.asarray(masks), cfg)
    step = jax.jit(jax.vmap(lambda x: dks_j.superstep(dj, x, cfg)))
    for _ in range(2):
        st = step(st)
    fields = {f.name: np.asarray(getattr(st, f.name))
              for f in dataclasses.fields(st)}
    return dj, dt, st, interop.state_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("chunk", [1, 7, None, "all"])
def test_chunked_relax_equals_unchunked_and_reference(chunk):
    dj, dt, st_j, st_t = mid_run()
    n_e = dt.src.shape[0]
    args = (st_t.S, st_t.changed, dt.src, dt.dst, dt.w, dt.valid)
    whole = dks_t.receive_candidates(
        dks_t.edge_candidates(st_t.S, st_t.changed, dt.src, dt.w, dt.valid),
        dt.dst, dt.v_pad)
    got = dks_t.relax_edges(*args, chunk_edges=n_e if chunk == "all"
                            else chunk)
    assert torch.equal(got, whole)
    cfg = dks_j.DKSConfig(m=M, k=K)
    want = jax.vmap(lambda S, ch: dks_j.relax(dj, S, ch, cfg))(st_j.S,
                                                               st_j.changed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_node_chunks_equal_reference(monkeypatch):
    """A budget of a few nodes' rows: the "torch" superstep (merge and
    combine by chunks of nodes), the lane kernel's plain version and the
    subset-combine plain version equal ``repro`` and the unchunked run."""
    dj, dt, st_j, st_t = mid_run()
    cfg_t = dks_t.DKSConfig(m=M, k=K)
    done = torch.tensor([True, False, False])
    args = (st_t.S, st_t.changed, done, dt.in_offsets, dt.src, dt.w)
    whole = (fused_lane_step_ref(*args, M), subset_combine_ref(st_t.S, M),
             dks_t.superstep(dt, st_t, cfg_t))
    monkeypatch.setattr(dks_t, "NODE_CHUNK_BYTES", 5000)
    monkeypatch.setattr(dks_t, "RELAX_CHUNK_BYTES", 5000)
    assert torch.equal(fused_lane_step_ref(*args, M), whole[0])
    assert torch.equal(subset_combine_ref(st_t.S, M), whole[1])
    got = dks_t.superstep(dt, st_t, cfg_t)
    for f in dks_t.STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(whole[2], f)), f
    cfg_j = dks_j.DKSConfig(m=M, k=K)
    want = jax.vmap(lambda x: dks_j.superstep(dj, x, cfg_j))(st_j)
    np.testing.assert_array_equal(got.S.numpy(), np.asarray(want.S))
    np.testing.assert_array_equal(got.msgs_bfs.numpy(),
                                  np.asarray(want.msgs_bfs))


# --------------------------------------------------------------------------
# (c) the stragglers' row-wise view
# --------------------------------------------------------------------------


def test_row_view_equals_whole_table_path():
    """Stragglers on a graph whose hubs pass ``degree_cap``: the trees,
    ``exhausted`` and ``stats()`` of the row-wise view equal ``repro``'s
    backtracer (a whole-table host copy per straggling lane) and the host
    collector on the whole table; no whole table reaches the host."""
    gj, gt, dj, _ = graphs()
    cfg = dks_j.DKSConfig(m=M, k=K)
    kw = np.zeros((LANES, M, dj.v_pad), bool)
    rng = np.random.default_rng(9)
    for lane in range(LANES):
        for t in range(M):
            kw[lane, t, rng.choice(gj.n_nodes, 4, replace=False)] = True
    S = np.array(drv_j.run_lanes(dj, jnp.asarray(kw), cfg).S)
    cap = 4
    assert int(np.diff(gt.indptr).max()) > cap
    ref = ans_j.BatchedBacktracer(gj, degree_cap=cap)
    want = ref.extract_lanes(S, kw, k=K, n_nodes=gj.n_nodes)
    bt = ans_t.BatchedBacktracer(gt, device="cpu", degree_cap=cap)
    got = bt.extract_lanes(torch.from_numpy(S), kw, k=K, n_nodes=gt.n_nodes)
    host = [collect_t(S[lane], gt, kw[lane, :, : gt.n_nodes], k=K)
            for lane in range(LANES)]
    for g, w, h in zip(got, want, host):
        trees = [[(a.root, a.edges, a.weight, a.raw_value, a.nodes)
                  for a in x[0]] for x in (g, w, h)]
        assert trees[0] == trees[1] == trees[2]
        assert g[1] == w[1] == h[1]
    assert bt.stats() == ref.stats()
    assert bt.host_fallbacks > 0
    assert bt.table_copies == 0
    assert 0 < bt.rows_fetched < LANES * gt.n_nodes


# --------------------------------------------------------------------------
# (d) bluk-bnb-cpu through both engines
# --------------------------------------------------------------------------


def test_bluk_bnb_cpu_bucket_equals_reference(monkeypatch):
    """``bluk-bnb-cpu`` (80,000 nodes, 230,000 edges), a bucket of 2 lanes
    (m = 3, k = 3) through ``repro``'s engine and the port's ``"torch"``
    engine with its relax in chunks of 20,000 edges: weights, roots,
    supersteps, message counts, flags and trees equal."""
    cfg = BLUK_BNB_CPU
    assert (cfg.n_nodes, cfg.n_edges, cfg.vocab, cfg.seed, cfg.tau) == (
        BLUK_J.n_nodes, BLUK_J.n_edges, BLUK_J.vocab, BLUK_J.seed, BLUK_J.tau)
    gj, tokens = lod_j(cfg.n_nodes, cfg.n_edges, seed=cfg.seed,
                       vocab=cfg.vocab, tau=cfg.tau)
    gt, _ = lod_t(cfg.n_nodes, cfg.n_edges, seed=cfg.seed, vocab=cfg.vocab,
                  tau=cfg.tau)
    ej = EngineJ.build(gj, tokens=tokens, policy=PolicyJ(max_supersteps=24))
    et = EngineT.build(gt, tokens=tokens, policy=PolicyT(max_supersteps=24),
                       device="cpu")
    # Tokens carried by nodes next to the graph's busiest node, so that
    # the lanes have answers.
    hub = int(np.argmax(np.diff(gt.indptr)))
    near = gt.indices[gt.indptr[hub]:gt.indptr[hub + 1]][:64]
    pool = sorted({int(t) for t in tokens[near].ravel()
                   if 2 <= et.index.df(int(t)) <= 400})
    rng = np.random.default_rng(3)
    bucket = [[int(t) for t in rng.choice(pool, M, replace=False)]
              for _ in range(2)]
    chunk = 20_000 * 2 * (1 << M) * K * 4
    monkeypatch.setattr(dks_t, "RELAX_CHUNK_BYTES", chunk)
    got = et.query_batch(bucket, k=K)
    want = ej.query_batch(bucket, k=K)
    for rt, rj in zip(got, want):
        np.testing.assert_array_equal(rt.weights, rj.weights)
        np.testing.assert_array_equal(rt.roots, rj.roots)
        for f in ("supersteps", "msgs_bfs", "msgs_deep", "explored_frac",
                  "done", "budget_hit", "capped"):
            assert getattr(rt, f) == getattr(rj, f), f
        assert [(a.root, a.edges, a.weight) for a in rt.answers] == \
            [(a.root, a.edges, a.weight) for a in rj.answers]
    assert any(r.found for r in got)
    assert et.extraction_stats == ej.extraction_stats
