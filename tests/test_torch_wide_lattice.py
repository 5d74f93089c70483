"""Port parity past the DKS kernels' templated range (m = 6 keywords,
K = 8 slots), on the CPU, bit for bit: the plain versions that the wide
CUDA route is held to on the card (``subset_combine``,
``fused_lane_step``, ``padded_topk`` and the batched backtrace's walk)
against ``repro`` at (m, K) = (3, 10), (2, 16), (7, 3) and (8, 2), and
``QueryEngine`` on ``"torch"`` against ``repro``'s engine at m = 4,
K = 10 and m = 7, K = 3.  The file takes about a minute and a half on one worker,
nearly all of it compiling ``repro``'s programs at m = 7 and 8.

``repro``'s Pallas kernels run in interpret mode where they trace in a
few seconds (K = 10 and 16 at m <= 3); at m = 7 and 8 the reference is
its jnp path.  No tolerance: every lattice value is a min, a compare or
one f32 add, the records are integers and the trees host code on equal
inputs.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import INF
from repro import answers as ans_j
from repro.core import dks as dks_j
from repro.core import driver as drv_j
from repro.core.semiring import sorted_unique_k, topk_merge
from repro.engine import ExecutionPolicy as PolicyJ
from repro.engine import QueryEngine as EngineJ
from repro.graph import generators as gen_j
from repro.kernels.lane_superstep import (fused_lane_superstep as fused_j,
                                          lane_csr_from_device_graph)
from repro.kernels.segment_minplus.kernel import padded_topk as topk_pallas
from repro.kernels.segment_minplus.ref import padded_topk_ref as topk_ref_j
from repro.kernels.subset_combine.ops import subset_combine as sc_pallas
from repro.kernels.subset_combine.ref import subset_combine_ref as sc_ref_j

from repro_torch import answers as ans_t
from repro_torch.engine import ExecutionPolicy as PolicyT
from repro_torch.engine import QueryEngine as EngineT
from repro_torch.graph import generators as gen_t
from repro_torch.kernels.batched_backtrace import ops as bt_ops
from repro_torch.kernels.lane_superstep import ops as ls_ops
from repro_torch.kernels.segment_minplus import ops as sm_ops
from repro_torch.kernels.subset_combine import ops as sc_ops

# (m, K) past the templated range; whether repro's Pallas kernel traces
# there in interpret mode within the file's budget.
WIDE = [(3, 10, True), (2, 16, True), (7, 3, False), (8, 2, False)]
IDS = [f"m{m}k{k}" for m, k, _ in WIDE]


def random_table(v, m, k, seed):
    """Sorted-unique, INF-padded lattice tables, the empty set all INF."""
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 40, size=(v, 1 << m, k)).astype(np.float32)
    s[rng.random(s.shape) > 0.5] = INF
    s = np.array(sorted_unique_k(jnp.asarray(s), k))
    s[:, 0, :] = INF
    return s


@functools.partial(jax.jit, static_argnums=1)
def combine_j(S, cfg):
    """``repro``'s batched jnp combine (the engine's), compiled."""
    return dks_j.combine(S, cfg)


@pytest.mark.parametrize("m,k,pallas", WIDE, ids=IDS)
def test_subset_combine_plain_matches_repro(m, k, pallas):
    """Against the Pallas kernel (interpret) and the sequential jnp oracle
    where they trace quickly, else the engine's batched jnp combine."""
    s = random_table(16, m, k, seed=m * 100 + k)
    launched = sc_ops.launches
    got = sc_ops.subset_combine(torch.from_numpy(s), m).numpy()
    assert sc_ops.launches == launched  # the CPU path launches nothing
    np.testing.assert_array_equal(got, np.asarray(combine_j(
        jnp.asarray(s), dks_j.DKSConfig(m=m, k=k))))
    if pallas:
        np.testing.assert_array_equal(got, np.asarray(sc_ref_j(
            jnp.asarray(s), m)))
        np.testing.assert_array_equal(got, np.asarray(sc_pallas(
            jnp.asarray(s), m, interpret=True, block_v=8)))


@pytest.mark.parametrize("m,k,pallas", WIDE, ids=IDS)
def test_padded_topk_plain_matches_repro(m, k, pallas):
    """F = 2^m keyword sets of candidates from 6 in-edges (C = 6 K)."""
    f, c = 1 << m, 6 * k
    rng = np.random.default_rng(f + c)
    cand = rng.integers(1, 60, size=(16, c, f)).astype(np.float32)
    cand[rng.random(cand.shape) > 0.6] = INF
    got = sm_ops.padded_topk(torch.from_numpy(cand), k).numpy()
    assert got.shape == (16, f, k)
    np.testing.assert_array_equal(got, np.asarray(topk_ref_j(
        jnp.asarray(cand), k)))
    if pallas:
        np.testing.assert_array_equal(got, np.asarray(topk_pallas(
            jnp.asarray(cand), k, block_v=8, interpret=True)))


@functools.lru_cache(maxsize=None)
def graphs():
    """One graph in both packages, with hubs (in-degrees past 32)."""
    gj, _ = gen_j.lod_like_graph(120, 700, seed=3, vocab=40)
    gt, _ = gen_t.lod_like_graph(120, 700, seed=3, vocab=40)
    return gj, gt


@functools.partial(jax.jit, static_argnums=3)
def table_step(dj, S, changed, cfg):
    """The table part of ``repro``'s jnp superstep (relax, merge, combine),
    vmapped over lanes, compiled; and the next ``changed`` as
    ``finish_superstep`` sets it.  (The whole superstep's aggregators take
    minutes to compile at m = 8.)"""
    def one(s, c):
        s1 = dks_j.combine(topk_merge(s, dks_j.relax(dj, s, c, cfg)), cfg)
        return s1, jnp.any(s1 < s, axis=(1, 2)) & dj.node_valid
    return jax.vmap(one)(S, changed)


def mid_run(m, k, n_lanes, seed, steps):
    """``repro``'s lane-initialised state of a random bucket, ``steps``
    table steps in (lane 0 with a keyword on no node), and the graphs."""
    gj, gt = graphs()
    dj = gj.to_device()
    cfg = dks_j.DKSConfig(m=m, k=k, max_supersteps=8)
    kw = np.random.default_rng(seed).random((n_lanes, m, dj.v_pad)) < 0.05
    kw[:, :, gj.n_nodes:] = False
    kw[0, 0] = False
    st = drv_j.lane_init(dj, jnp.asarray(kw), cfg)
    S, changed = st.S, st.changed
    for _ in range(steps):
        S, changed = table_step(dj, S, changed, cfg)
    return dataclasses.replace(st, S=S, changed=changed), kw, cfg


@pytest.mark.parametrize("m,k,pallas", WIDE, ids=IDS)
def test_fused_lane_step_plain_matches_repro(m, k, pallas):
    """A mid-run state of 3 lanes (two steps in), lane 1 done: the port's
    plain fused step equals ``repro``'s fused lane superstep (Pallas,
    interpret) and the table part of its jnp superstep."""
    st_j, _, cfg = mid_run(m, k, 3, seed=m * 10 + k, steps=2)
    dj = graphs()[0].to_device()
    dt = graphs()[1].to_device(device="cpu")
    S0 = np.array(st_j.S)
    done = torch.tensor([False, True, False])
    launched = ls_ops.launches
    got = ls_ops.fused_lane_step(
        torch.from_numpy(S0), torch.from_numpy(np.array(st_j.changed)),
        done, dt.in_offsets, dt.src, dt.w, m).numpy()
    assert ls_ops.launches == launched
    np.testing.assert_array_equal(got[1], S0[1])
    want = [np.asarray(table_step(dj, st_j.S, st_j.changed, cfg)[0])]
    if pallas:
        cfg_p = dataclasses.replace(cfg, relax_impl="pallas",
                                    combine_impl="pallas")
        want.append(np.asarray(fused_j(
            dj, lane_csr_from_device_graph(dj, dmax=4), st_j, cfg_p,
            interpret=True).S))
    for w in want:
        for lane in (0, 2):
            np.testing.assert_array_equal(got[lane], w[lane])
    assert not np.array_equal(got[2], S0[2])


@pytest.mark.parametrize("m,k,pallas", WIDE, ids=IDS)
def test_backtrace_walk_plain_matches_repro(m, k, pallas):
    """Tables of a 3-lane bucket six steps in (lane 0 with a keyword on no
    node): the port's walk records equal ``repro.answers``'s, under the
    default caps, and at m <= 3 under tight ones too (each cap is one
    more compile of ``repro``'s walk)."""
    st_j, kw, _ = mid_run(m, k, 3, seed=m + 7 * k, steps=6)
    S_all = np.array(st_j.S)
    gj, gt = graphs()
    for caps in ({}, {"degree_cap": 1, "buffer": 3})[:1 + pallas]:
        want = ans_j.BatchedBacktracer(gj, **caps).backtrace_lanes(S_all, kw,
                                                                   k)
        launched = bt_ops.launches
        got = ans_t.BatchedBacktracer(gt, device="cpu", **caps
                                      ).backtrace_lanes(S_all, kw, k)
        assert bt_ops.launches == launched
        for name in ("cand_idx", "cand_val", "fail", "node", "kind",
                     "child0", "child1", "edge_u"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)),
                                          err_msg=f"{name} {caps}")
        assert bool(got.fail[0].all())
        assert int((got.kind > 0).sum()) > got.kind.shape[1]


def same_result(rt, rj):
    np.testing.assert_array_equal(rt.weights, rj.weights)
    np.testing.assert_array_equal(rt.roots, rj.roots)
    for f in ("m", "k", "supersteps", "msgs_bfs", "msgs_deep", "done"):
        assert getattr(rt, f) == getattr(rj, f), f
    assert [(a.root, a.edges, a.weight, a.raw_value, a.nodes)
            for a in rt.answers] == \
        [(a.root, a.edges, a.weight, a.raw_value, a.nodes)
         for a in rj.answers]


@pytest.mark.parametrize("m,k", [(4, 10), (7, 3)], ids=["m4k10", "m7k3"])
def test_engine_on_torch_matches_repro(m, k):
    """``query_batch`` on ``"torch"`` answers as ``repro``'s engine
    (weights, roots, counters and trees), and at m = 4 ``query`` too, with
    the sound exit.  At m = 7 both run to an empty frontier
    (``exit_mode="none"``): ``repro``'s sound-exit bound takes 30 s more
    to compile there."""
    exit_mode = "sound" if m <= 4 else "none"
    gj, tokens = gen_j.lod_like_graph(150, 500, seed=4, vocab=16)
    gt, _ = gen_t.lod_like_graph(150, 500, seed=4, vocab=16)
    ej = EngineJ.build(gj, tokens=tokens, policy=PolicyJ(
        max_supersteps=16, exit_mode=exit_mode))
    et = EngineT.build(gt, tokens=tokens, device="cpu", policy=PolicyT(
        backend="torch", max_supersteps=16, exit_mode=exit_mode))
    rng = np.random.default_rng(m * 10 + k)
    queries = [sorted(int(t) for t in rng.choice(16, size=m, replace=False))
               for _ in range(2)]
    got = et.query_batch(queries, k=k)
    assert all(r.found and len(r.answers) > 1 for r in got)
    for rt, rj in zip(got, ej.query_batch(queries, k=k)):
        same_result(rt, rj)
    if m <= 4:
        same_result(et.query(queries[0], k=k), ej.query(queries[0], k=k))
