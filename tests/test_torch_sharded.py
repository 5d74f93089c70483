"""The port's sharded partition (``repro_torch.core.dks_sharded`` behind
``ExecutionPolicy(partition="sharded")``) against ``repro``'s on the CPU,
plus the paper's Eq. 2 exit hook and the baselines.

``repro``'s sharded path needs a device mesh, so its side runs once per
module in a subprocess with 8 host devices
(``--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it) and hands its results back as JSON.
The packer, the exit hook and the baselines need no mesh and run
in-process.  Tolerance: none — every lattice value is a min, a compare or
one f32 add, so port and reference agree bit for bit, uncapped and capped,
at 1, 3 and 8 shards over node counts that 3 and 8 do not divide.
"""

import dataclasses
import inspect
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import DKSConfig as ConfigJ
from repro.core import run_dks_instrumented as run_instrumented_j
from repro.core.baselines import dks_no_early_exit as no_exit_j
from repro.core.baselines import vanilla_parallel_bfs as bfs_j
from repro.core.dks_sharded import pack_frontier_graph as pack_j
from repro.core.fagin import paper_exit_hook as hook_j
from repro.engine import ExecutionPolicy as PolicyJ
from repro.graph import generators as gen_j

from repro_torch import INF
from repro_torch.core import dks
from repro_torch.core.baselines import dks_no_early_exit, vanilla_parallel_bfs
from repro_torch.core.dks import DKSConfig, STATE_FIELDS
from repro_torch.core.dks_sharded import (
    FrontierGraph,
    pack_frontier_graph,
    relax_frontier,
    relax_frontier_lanes,
    run_dks_frontier,
    run_dks_frontier_instrumented,
)
from repro_torch.core.driver import lane_init, run_lanes
from repro_torch.core.fagin import paper_exit_hook
from repro_torch.core.spa import spa_cover_dp
from repro_torch.core.steiner_ref import dreyfus_wagner
from repro_torch.engine import ExecutionPolicy as PolicyT
from repro_torch.engine import QueryEngine as EngineT
from repro_torch.graph import generators as gen_t
from repro_torch.graph.index import InvertedIndex

SRC = str(Path(__file__).resolve().parent.parent / "src")
SHARDS = (1, 3, 8)
FRACS = (1.0, 0.1)          # no cap, and a cap that overflows
N_LANE_GRAPH, E_LANE_GRAPH = 70, 180   # 70 = 3*23 + 1 = 8*8 + 6
LANE_GROUPS = ([[3], [17, 40], [41]], [[0], [69], [33]],
               [[5, 6], [50], [12]])
ENGINE_SHARDS = 3           # 200 lod nodes: 3 does not divide them
RESULT_FIELDS = ("m", "k", "kw_nodes", "supersteps", "msgs_bfs",
                 "msgs_deep", "explored_frac", "done", "budget_hit",
                 "capped", "spa", "spa_ratio", "answers_exhausted",
                 "weights", "roots")
UPDATE_FIELDS = ("step", "weights", "roots", "frontier", "msgs_bfs",
                 "msgs_deep", "nu_full", "spa", "opt_lower_bound",
                 "sound_opt_lower_bound", "spa_ratio", "done")


# -- summaries: the same code runs here and in the reference subprocess --

def plain(x):
    """A JSON-comparable copy of a result field."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if isinstance(x, (tuple, list)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def summary(res, fields):
    out = {f: plain(getattr(res, f)) for f in fields}
    if hasattr(res, "answers"):
        out["answers"] = [plain([a.root, a.edges, a.weight, a.raw_value,
                                 a.nodes]) for a in res.answers]
    return out


def lane_masks(v_pad):
    masks = np.zeros((len(LANE_GROUPS), 3, v_pad), bool)
    for lane, groups in enumerate(LANE_GROUPS):
        for i, grp in enumerate(groups):
            masks[lane, i, grp] = True
    return masks


def engine_queries(index):
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 40]
    return toks[:2], toks[2:5], [toks[2:5], toks[5:8], toks[1:4]]


# The reference runs as two programs at once (the lane driver; the
# engine), each with the header below; each prints one JSON object.
REFERENCE_HEADER = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax.numpy as jnp
from repro import INF, shardmap
from repro.core import DKSConfig
from repro.core.dks_sharded import pack_frontier_graph
from repro.core.driver import run_lanes
from repro.core.spa import spa_cover_dp
from repro.engine import ExecutionPolicy, QueryEngine
from repro.graph.generators import lod_like_graph, random_weighted_graph
from repro.graph.index import InvertedIndex

out = {}
"""

REFERENCE_LANES = """
g = random_weighted_graph(N_LANE_GRAPH, E_LANE_GRAPH, seed=5)
for ns in SHARDS:
    fg = pack_frontier_graph(
        g, n_shards=ns, mesh=shardmap.make_mesh((ns,), ("data",)))
    e_min = float(fg.e_min())
    for frac in FRACS:
        cfg = DKSConfig(m=3, k=2, max_supersteps=48, frontier_frac=frac)
        st = run_lanes(fg, jnp.asarray(lane_masks(fg.v_pad)), cfg)
        row = {f: plain(np.asarray(getattr(st, f))) for f in STATE_FIELDS}
        row["spa"] = [float(spa_cover_dp(
            jnp.minimum(st.s_front[i] + e_min, INF), 3))
            for i in range(len(LANE_GROUPS))]
        out[f"lanes/{ns}/{frac}"] = row
print("RESULT::" + json.dumps(out))
"""

REFERENCE_ENGINE = """
gl, tokens = lod_like_graph(200, 600, seed=7, vocab=60)
index = InvertedIndex.from_token_matrix(tokens)
_, q3, bucket = engine_queries(index)
for name, frac in (("uncapped", 1.0), ("capped", 0.25)):
    eng = QueryEngine.build(gl, index=index, policy=ExecutionPolicy(
        partition="sharded", n_shards=ENGINE_SHARDS, max_supersteps=32,
        frontier_frac=frac))
    out[name] = {"batch": [summary(r, RESULT_FIELDS)
                           for r in eng.query_batch(bucket, k=2)]}
    if name == "uncapped":
        out[name]["stream"] = [summary(u, UPDATE_FIELDS)
                               for u in eng.query_stream(q3, k=2)]
        out[name]["deadline"] = [
            [summary(r, RESULT_FIELDS), plain(info)]
            for r, info in eng.query_deadline_batch(bucket, k=2,
                                                    deadline_s=0.0)]
        res, info = eng.query_instrumented(q3, k=2)
        out[name]["instrumented"] = {
            "result": summary(res, RESULT_FIELDS),
            "history": info["history"], "timings": sorted(info["timings"])}

go = random_weighted_graph(64, 320, seed=3)
eng = QueryEngine.build(
    go, index=InvertedIndex.from_token_matrix(
        (np.arange(64) % 16).reshape(64, 1)),
    policy=ExecutionPolicy(partition="sharded", n_shards=8,
                           exit_mode="none", frontier_frac=0.01,
                           max_supersteps=48))
out["overflow"] = summary(eng.query([3, 3], k=1, extract=False),
                          RESULT_FIELDS)
print("RESULT::" + json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_run():
    """``repro``'s sharded runs, started in two subprocesses with 8
    devices at the module's first test: the in-process tests run while
    they work."""
    consts = {name: globals()[name] for name in (
        "SHARDS", "FRACS", "N_LANE_GRAPH", "E_LANE_GRAPH", "LANE_GROUPS",
        "ENGINE_SHARDS", "RESULT_FIELDS", "UPDATE_FIELDS")}
    consts["STATE_FIELDS"] = STATE_FIELDS
    head = "\n".join(
        [f"{k} = {v!r}" for k, v in consts.items()]
        + [textwrap.dedent(inspect.getsource(f))
           for f in (plain, summary, lane_masks, engine_queries)]
        + [REFERENCE_HEADER])
    procs = [subprocess.Popen(
        [sys.executable, "-c", head + body], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
             "HOME": str(Path.home()), "JAX_PLATFORMS": "cpu"})
        for body in (REFERENCE_LANES, REFERENCE_ENGINE)]
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(reference_run):
    """``repro``'s sharded results, as JSON from the subprocesses."""
    out = {}
    for proc in reference_run:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"stderr:\n{stderr[-4000:]}"
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("RESULT::")][-1]
        out.update(json.loads(line.split("RESULT::", 1)[1]))
    return out


@pytest.fixture(scope="module")
def lod():
    g, tokens = gen_t.lod_like_graph(200, 600, seed=7, vocab=60)
    index = InvertedIndex.from_token_matrix(tokens)
    engines = {name: EngineT.build(g, index=index, device="cpu",
                                   policy=PolicyT(
                                       partition="sharded",
                                       n_shards=ENGINE_SHARDS,
                                       max_supersteps=32,
                                       frontier_frac=frac))
               for name, frac in (("uncapped", 1.0), ("capped", 0.25))}
    engines["single"] = EngineT.build(
        g, index=index, device="cpu", policy=PolicyT(max_supersteps=32))
    return engines, engine_queries(index)


def json_round(x):
    return json.loads(json.dumps(x))


# -- the packer ----------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_pack_matches_reference(n_shards):
    """Every array of the packed layout equals ``repro``'s packer's."""
    for gj, gt in ((gen_j.random_weighted_graph(N_LANE_GRAPH, E_LANE_GRAPH,
                                                seed=5),
                    gen_t.random_weighted_graph(N_LANE_GRAPH, E_LANE_GRAPH,
                                                seed=5)),
                   (gen_j.lod_like_graph(200, 600, seed=7, vocab=60)[0],
                    gen_t.lod_like_graph(200, 600, seed=7, vocab=60)[0])):
        fj = pack_j(gj, n_shards=n_shards)
        ft = pack_frontier_graph(gt, n_shards, device="cpu")
        for name in ("edge_src", "edge_dst_l", "edge_w", "out_degree",
                     "node_valid"):
            np.testing.assert_array_equal(getattr(ft, name).numpy(),
                                          np.asarray(getattr(fj, name)),
                                          err_msg=name)
        assert (ft.n_nodes, ft.n_edges, ft.n_shards, ft.v_pad, ft.n_loc) \
            == (fj.n_nodes, fj.n_edges, fj.n_shards, fj.v_pad, fj.n_loc)
        assert float(ft.e_min()) == float(fj.e_min())
    with pytest.raises(ValueError, match="n_shards"):
        pack_frontier_graph(gt, 0, device="cpu")


# -- the relax and the driver --------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_frontier_relax_equals_dense_relax(n_shards):
    """Uncapped, the frontier relax of a mid-run bucket equals the dense
    edge-list relax on every real node, and nothing overflows; a cap of
    one node per shard overflows the lanes whose frontier outgrows it."""
    g = gen_t.random_weighted_graph(N_LANE_GRAPH, E_LANE_GRAPH, seed=5)
    dg = g.to_device("cpu")
    fg = pack_frontier_graph(g, n_shards, device="cpu")
    cfg = DKSConfig(m=3, k=2, frontier_frac=1.0)
    n = g.n_nodes
    st = lane_init(dg, torch.from_numpy(lane_masks(n)), cfg)
    st = dks.superstep(dg, st, cfg)
    S = torch.full((st.S.shape[0], fg.v_pad) + st.S.shape[2:], INF)
    S[:, :n] = st.S
    changed = torch.zeros(st.S.shape[0], fg.v_pad, dtype=torch.bool)
    changed[:, :n] = st.changed
    R, overflow = relax_frontier_lanes(fg, S, changed, cfg)
    assert torch.equal(R[:, :n], dks.relax(dg, st.S, st.changed, cfg))
    assert torch.equal(R[:, n:], torch.full_like(R[:, n:], INF))
    assert not overflow.any()
    R1, ov1 = relax_frontier(fg, S[1], changed[1], cfg)
    assert torch.equal(R1, R[1]) and not bool(ov1)
    tiny = DKSConfig(m=3, k=2, frontier_frac=0.0)   # f_cap = 1
    _, overflow = relax_frontier_lanes(fg, S, changed, tiny)
    per_shard = changed.reshape(len(LANE_GROUPS), n_shards, -1).sum(dim=2)
    assert torch.equal(overflow, (per_shard > 1).any(dim=1))


# -- the engine ----------------------------------------------------------

def test_engine_sharded_equals_single(lod):
    """Uncapped, the sharded engine answers as the single one (weights,
    supersteps, trees, streams); executors count as ``repro``'s (one
    preparation for any number of same-shape queries), and cache tokens
    keep the partitions apart."""
    engines, (q2, q3, _) = lod
    sh, single = engines["uncapped"], engines["single"]
    for q in (q2, q3):
        rs, rh = single.query(q, k=2), sh.query(q, k=2)
        for f in ("weights", "roots", "supersteps", "msgs_bfs", "msgs_deep",
                  "explored_frac", "done", "budget_hit"):
            assert np.array_equal(getattr(rs, f), getattr(rh, f)), f
        assert [(a.root, a.edges) for a in rs.answers] == \
            [(a.root, a.edges) for a in rh.answers]
    ups = list(sh.query_stream(q3, k=2))
    assert ups[-1].done and np.array_equal(ups[-1].weights,
                                           single.query(q3, k=2).weights)
    ratios = [u.spa_ratio for u in ups]
    assert all(a >= b for a, b in zip(ratios, ratios[1:]))
    assert sh.trace_count(len(q3), 2) == 1
    assert sh.cache_token(q3, 2) != single.cache_token(q3, 2)
    assert sh.v_pad == 201 and sh.n_nodes == 200
    assert sh.device_graph.n_edges == single.device_graph.n_edges


def test_artifact_engine_packs_the_sharded_layout(tmp_path, lod):
    """``QueryEngine.build(artifact=...)`` packs the sharded layout too,
    and answers as the graph-built sharded engine, trees included."""
    from repro_torch.store import write_artifact
    engines, (_, q3, bucket) = lod
    built = engines["uncapped"]
    art = write_artifact(tmp_path / "a", built.graph, built.index)
    eng = EngineT.build(artifact=art.path, device="cpu",
                        policy=built.policy)
    assert isinstance(eng.device_graph, FrontierGraph)
    assert eng.version == f"artifact:{art.content_hash}"
    for rt, rb in zip(eng.query_batch(bucket, k=2),
                      built.query_batch(bucket, k=2)):
        assert json_round(summary(rt, RESULT_FIELDS)) == \
            json_round(summary(rb, RESULT_FIELDS))


def test_policy_and_build_guards():
    """``cuda`` with ``sharded`` raises as ``repro``'s ``pallas`` with
    ``sharded`` does; the partition is fixed at build; a CPU engine's
    default shard count is 1."""
    with pytest.raises(NotImplementedError, match="sharded"):
        PolicyT(backend="cuda", partition="sharded")
    with pytest.raises(NotImplementedError, match="sharded"):
        PolicyJ(backend="pallas", partition="sharded")
    assert PolicyT(partition="sharded").dks_config(2, 1).frontier_frac == 0.25
    g, tokens = gen_t.lod_like_graph(60, 150, seed=2, vocab=20)
    with pytest.raises(ValueError, match="n_shards"):
        EngineT.build(g, tokens=tokens, device="cpu",
                      policy=PolicyT(partition="sharded", n_shards=0))
    eng = EngineT.build(g, tokens=tokens, device="cpu",
                        policy=PolicyT(partition="sharded"))
    assert isinstance(eng.device_graph, FrontierGraph)
    assert eng.device_graph.n_shards == 1
    for over in ({"partition": "single"}, {"n_shards": 2},
                 {"backend": "cuda"}):
        with pytest.raises((ValueError, NotImplementedError)):
            eng.query([int(tokens[0, 0])], k=1, **over)


# -- the paper's Eq. 2 exit hook and the baselines ------------------------

@pytest.mark.parametrize("seed", range(3))
def test_paper_exit_hook_matches_reference(seed):
    """The literal Eq. 2 hook (``tests/test_fidelity.py``'s graphs) stops
    both packages at the same superstep with the same answer, the
    Dreyfus-Wagner optimum; on a sharded graph it stops where it stops
    on the dense one."""
    gj = gen_j.random_weighted_graph(14, 26, seed=seed)
    gt = gen_t.random_weighted_graph(14, 26, seed=seed)
    rng = np.random.default_rng(seed)
    groups = [[int(rng.integers(0, 14))] for _ in range(2)]
    masks = np.zeros((2, 14), bool)
    for i, grp in enumerate(groups):
        masks[i, grp] = True
    cfg_j = ConfigJ(m=2, k=1, max_supersteps=64, exit_mode="none")
    cfg_t = DKSConfig(m=2, k=1, max_supersteps=64, exit_mode="none")
    dgj, dgt = gj.to_device(), gt.to_device("cpu")
    want, _ = run_instrumented_j(dgj, jnp.asarray(masks), cfg_j,
                                 exit_hook=hook_j(gj, masks, cfg_j,
                                                  float(dgj.e_min())))
    hook = paper_exit_hook(gt, masks, cfg_t, float(dgt.e_min()))
    got, info = dks.run_dks_instrumented(dgt, torch.from_numpy(masks),
                                         cfg_t, exit_hook=hook)
    assert float(got.topk_w[0, 0]) == float(want.topk_w[0])
    assert int(got.step[0]) == int(want.step) == len(info["history"])
    assert float(got.topk_w[0, 0]) == pytest.approx(
        dreyfus_wagner(gt, groups), abs=1e-3)
    fg = pack_frontier_graph(gt, 3, device="cpu")
    m2 = np.zeros((2, fg.v_pad), bool)
    m2[:, :14] = masks
    sh, sh_info = run_dks_frontier_instrumented(
        fg, torch.from_numpy(m2),
        dataclasses.replace(cfg_t, frontier_frac=1.0), exit_hook=hook)
    assert torch.equal(sh.topk_w, got.topk_w)
    assert int(sh.step[0]) == int(got.step[0])
    assert set(sh_info["timings"]) == set(info["timings"])


def test_vanilla_bfs_matches_reference():
    """Hop distances and superstep counts equal ``repro``'s, on the 6 x 6
    grid of ``tests/test_fidelity.py`` and on a random graph with
    unreachable nodes, from one source and from several."""
    for make in (lambda gen: gen.grid_graph(6, 6),
                 lambda gen: gen.random_weighted_graph(40, 35, seed=4)):
        dgj, dgt = make(gen_j).to_device(), make(gen_t).to_device("cpu")
        for srcs in ([0], [3, 17, 30]):
            src = np.zeros(dgt.v_pad, bool)
            src[srcs] = True
            dist_j, steps_j = bfs_j(dgj, jnp.asarray(src))
            dist_t, steps_t = vanilla_parallel_bfs(dgt, torch.from_numpy(src))
            np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))
            assert steps_t == int(steps_j)
    grid = gen_t.grid_graph(6, 6).to_device("cpu")
    src = torch.zeros(grid.v_pad, dtype=torch.bool)
    src[0] = True
    dist, steps = vanilla_parallel_bfs(grid, src)
    assert int(dist[35]) == 10 and steps <= 12


def test_dks_no_early_exit_matches_reference():
    gj = gen_j.random_weighted_graph(30, 80, seed=2)
    gt = gen_t.random_weighted_graph(30, 80, seed=2)
    masks = np.zeros((3, 30), bool)
    masks[0, 1] = masks[1, 7] = masks[2, 19] = True
    want = no_exit_j(gj.to_device(), jnp.asarray(masks),
                     ConfigJ(m=3, k=2, max_supersteps=48))
    got = dks_no_early_exit(gt.to_device("cpu"), torch.from_numpy(masks),
                            DKSConfig(m=3, k=2, max_supersteps=48))
    for f in ("topk_w", "step", "msgs_bfs", "msgs_deep", "done"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)



# -- against repro's sharded run (the subprocess) --------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_lanes_match_reference(ref, n_shards):
    """A bucket of 3 lanes through the lane driver on a FrontierGraph:
    every state field of every lane equals ``repro``'s, uncapped and
    capped (with the same SPA bound); uncapped, it also equals the dense
    run on every real node."""
    g = gen_t.random_weighted_graph(N_LANE_GRAPH, E_LANE_GRAPH, seed=5)
    fg = pack_frontier_graph(g, n_shards, device="cpu")
    n = g.n_nodes
    dense = run_lanes(g.to_device("cpu"), torch.from_numpy(lane_masks(n)),
                      DKSConfig(m=3, k=2, max_supersteps=48))
    for frac in FRACS:
        want = ref[f"lanes/{n_shards}/{frac}"]
        cfg = DKSConfig(m=3, k=2, max_supersteps=48, frontier_frac=frac)
        st = run_lanes(fg, torch.from_numpy(lane_masks(fg.v_pad)), cfg)
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(want[f]),
                err_msg=f"{f} at frontier_frac={frac}")
        spa = [float(spa_cover_dp(torch.clamp(
            st.s_front[i] + fg.e_min(), max=INF), 3))
            for i in range(len(LANE_GROUPS))]
        assert spa == want["spa"]
        if frac == 1.0:
            assert not st.budget_hit.any()
            assert torch.equal(st.S[:, :n], dense.S)
            for f in ("topk_w", "topk_root", "step", "msgs_bfs",
                      "msgs_deep", "done"):
                assert torch.equal(getattr(st, f), getattr(dense, f)), f
        else:
            assert st.budget_hit.any()
    one = run_dks_frontier(fg, torch.from_numpy(lane_masks(fg.v_pad)[0]),
                           DKSConfig(m=3, k=2, max_supersteps=48,
                                     frontier_frac=1.0))
    np.testing.assert_array_equal(one.topk_w[0].numpy(),
                                  ref[f"lanes/{n_shards}/1.0"]["topk_w"][0])


@pytest.mark.parametrize("name", ["uncapped", "capped"])
def test_engine_query_and_batch_match_reference(ref, lod, name):
    """``query_batch`` (answer trees through the batched backtracer, on
    tables cut back to the real nodes) and ``query`` (the host collector)
    equal ``repro``'s sharded engine, field for field."""
    engines, (_, q3, bucket) = lod
    eng, want = engines[name], ref[name]
    assert bucket[0] == q3
    assert json_round(summary(eng.query(q3, k=2), RESULT_FIELDS)) == \
        want["batch"][0]
    got = [summary(r, RESULT_FIELDS) for r in eng.query_batch(bucket, k=2)]
    assert json_round(got) == want["batch"]
    assert all(r["answers"] for r in got)
    if name == "capped":
        assert any(r["budget_hit"] for r in got)


def test_engine_stepwise_surfaces_match_reference(ref, lod):
    """``query_stream`` update by update, ``query_deadline_batch`` at
    deadline 0, and ``query_instrumented``'s result, history rows and
    timing keys equal ``repro``'s sharded engine."""
    engines, (_, q3, bucket) = lod
    eng, want = engines["uncapped"], ref["uncapped"]
    got = [summary(u, UPDATE_FIELDS) for u in eng.query_stream(q3, k=2)]
    assert json_round(got) == want["stream"]
    streamed = eng.query_streamed(q3, k=2)
    assert json_round(plain(streamed.weights)) == want["stream"][-1]["weights"]
    got = [[summary(r, RESULT_FIELDS), plain(info)] for r, info in
           eng.query_deadline_batch(bucket, k=2, deadline_s=0.0)]
    assert json_round(got) == want["deadline"]
    res, info = eng.query_instrumented(q3, k=2)
    assert json_round({"result": summary(res, RESULT_FIELDS),
                       "history": info["history"],
                       "timings": sorted(info["timings"])}) == \
        want["instrumented"]


def test_engine_overflow_forces_a_stop_with_a_finite_spa(ref):
    """A per-shard frontier past ``f_cap`` ends the run with
    ``budget_hit`` and a finite SPA ratio — the paper's Sec. 5.4 forced
    stop, not silent message dropping — as ``repro``'s does."""
    g = gen_t.random_weighted_graph(64, 320, seed=3)
    eng = EngineT.build(
        g, tokens=(np.arange(64) % 16).reshape(64, 1), device="cpu",
        policy=PolicyT(partition="sharded", n_shards=8, exit_mode="none",
                       frontier_frac=0.01, max_supersteps=48))
    res = eng.query([3, 3], k=1, extract=False)
    assert json_round(summary(res, RESULT_FIELDS)) == ref["overflow"]
    assert res.budget_hit and res.done and res.weights[0] < INF
    assert np.isfinite(res.spa_ratio) and res.spa is not None