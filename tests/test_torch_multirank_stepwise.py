"""The port's stepwise DKS surfaces on a graph split one shard a rank —
``query_stream``, ``query_deadline_batch`` and ``query_instrumented`` with
the paper's Eq. 2 exit hook — against ``repro``'s sharded engine and
against the port's single-process twin, on the CPU.

As in ``tests/test_torch_multirank.py``: ranks are processes over gloo
(``repro_torch.distributed.ranks.run_ranks``, one spawn a world size for
every surface), and ``repro`` runs once per module through
``tests.test_distributed.run_in_subprocess`` with 8 forced host devices,
in a thread beside the ranks.  Tolerance: none.  Every rank, the twin and
``repro`` agree exactly on every ``StreamUpdate`` field, on the deadline
bucket's results and ``info`` at deadline 0 and at one no run reaches,
and on the instrumented run's result and history rows, uncapped and
capped, at 2 and 4 ranks.

A deadline that rank 0 passes first (its engine reads a clock that
advances ``TICK_S`` a reading; the other ranks read the real one) stops
every rank at the same superstep with the twin's results and state, and
``comm.issued`` shows that the stepwise surfaces exchange no more than the
fused driver does.
"""

import concurrent.futures
import contextlib
import dataclasses
import hashlib
import inspect
import textwrap

import numpy as np
import pytest
import torch

from tests.test_distributed import run_in_subprocess
from tests.test_torch_multirank import (RANKS_TIMEOUT_S, RESULT_FIELDS,
                                        jsonable)

from repro_torch.core.dks import STATE_FIELDS
from repro_torch.core.driver import lane_init, lane_superstep
from repro_torch.core.fagin import paper_exit_hook
from repro_torch.distributed import comm
from repro_torch.distributed.ranks import run_ranks
from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.engine import engine as engine_mod
from repro_torch.graph import generators as gen
from repro_torch.graph.index import InvertedIndex

UPDATE_FIELDS = ("step", "weights", "roots", "frontier", "msgs_bfs",
                 "msgs_deep", "nu_full", "spa", "opt_lower_bound",
                 "sound_opt_lower_bound", "spa_ratio", "done")
DEADLINES = (0.0, 600.0)     # at once, and one no run reaches
TICK_S, MID_DEADLINE_S = 1000.0, 3500.0   # rank 0 passes it 3 steps in
MID_STEPS = 3
WORLDS = (2, 4)


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


def lod_queries(index):
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 40]
    return toks[2:5], [toks[2:5], toks[5:8], toks[1:4]]


def stepwise_record(eng, q3, bucket, hook):
    """Every stepwise surface of one engine: the stream update by update,
    the deadline bucket at each of ``DEADLINES``, the instrumented run
    with ``hook``."""
    out = {"stream": [summary(u, UPDATE_FIELDS)
                      for u in eng.query_stream(q3, k=2)]}
    for d in DEADLINES:
        out[f"deadline/{d}"] = [
            [summary(r, RESULT_FIELDS), plain(info)]
            for r, info in eng.query_deadline_batch(bucket, k=2,
                                                    deadline_s=d)]
    res, info = eng.query_instrumented(q3, k=2, exit_hook=hook)
    out["instrumented"] = {"result": summary(res, RESULT_FIELDS),
                           "history": info["history"],
                           "timings": sorted(info["timings"])}
    return out


# -- the port: the same code on the ranks and on the twin ------------------

class TickClock:
    """The engine's ``time``: each ``perf_counter`` reading is ``TICK_S``
    past the last."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += TICK_S
        return self.now


@contextlib.contextmanager
def ticking():
    real = engine_mod.time
    engine_mod.time = TickClock()
    try:
        yield
    finally:
        engine_mod.time = real


def lod_engine(g, index, n_shards, device, frac):
    return QueryEngine.build(g, index=index, device=device,
                             policy=ExecutionPolicy(
                                 partition="sharded", n_shards=n_shards,
                                 max_supersteps=32, frontier_frac=frac))


def port_hook(eng, q3):
    masks, _ = eng._masks(q3)
    return paper_exit_hook(eng.graph, masks, eng._config(len(q3), 2),
                           eng._e_min, graph=eng.device_graph)


def mid_run(eng, bucket):
    """The bucket under ``MID_DEADLINE_S``, stopped where the first engine
    past it stops: results, ``info`` and a digest of every lane's state."""
    out = eng.query_deadline_batch(bucket, k=2, deadline_s=MID_DEADLINE_S,
                                   keep_state=True)
    digest = {f: hashlib.sha256(torch.cat([getattr(r.state, f)
                                           for r, _ in out])
                                .numpy().tobytes()).hexdigest()
              for f in STATE_FIELDS}
    return {"results": [[summary(r, RESULT_FIELDS), plain(info)]
                        for r, info in out], "digest": digest}


def port_cases(n_shards, device, tick):
    """Every surface on the lod graph, uncapped and capped, and the mid-run
    deadline, with the engine's clock ticking where ``tick``."""
    g, tokens = gen.lod_like_graph(200, 600, seed=7, vocab=60)
    index = InvertedIndex.from_token_matrix(tokens)
    q3, bucket = lod_queries(index)
    out = {}
    for name, frac in (("uncapped", 1.0), ("capped", 0.25)):
        eng = lod_engine(g, index, n_shards, device, frac)
        out[name] = stepwise_record(eng, q3, bucket, port_hook(eng, q3))
    eng = lod_engine(g, index, n_shards, device, 1.0)
    with ticking() if tick else contextlib.nullcontext():
        out["mid_run"] = mid_run(eng, bucket)
    return out, eng, q3, bucket


def issued_counts(eng, q3, bucket):
    """The ops each surface hands to ``torch.distributed``: a stream's
    supersteps one by one, one fused superstep, and the deadline bucket's
    and the instrumented run's totals with their supersteps."""
    stream = eng.query_stream(q3, k=2)
    next(stream)
    per_step = []
    while True:
        comm.issued.clear()
        if next(stream, None) is None:
            break
        per_step.append(dict(comm.issued))
    cfg = eng._config(len(q3), 2)
    masks, _ = eng._masks(q3)
    st = lane_init(eng.device_graph, eng._device_masks(masks[None]), cfg)
    comm.issued.clear()
    lane_superstep(eng.device_graph, st, cfg)
    fused = dict(comm.issued)
    comm.issued.clear()
    out = eng.query_deadline_batch(bucket, k=2, deadline_s=600.0)
    deadline = (dict(comm.issued), out[0][1]["driver_supersteps"])
    comm.issued.clear()
    res, _ = eng.query_instrumented(q3, k=2, exit_hook=port_hook(eng, q3))
    return {"stream": per_step, "fused": fused, "deadline": deadline,
            "instrumented": (dict(comm.issued), res.supersteps)}


def _stepwise_ranks(device):
    out, eng, q3, bucket = port_cases(None, device, comm.rank() == 0)
    assert eng.device_graph.n_held == 1
    out["issued"] = issued_counts(eng, q3, bucket)
    return jsonable(out)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    """One spawn a world size: ``(world, every rank's record)``."""
    world = request.param
    return world, run_ranks(_stepwise_ranks, world,
                            timeout_s=RANKS_TIMEOUT_S,
                            workdir=tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def twin():
    """The single-process twin at each world's shard count."""
    return {w: jsonable(port_cases(w, "cpu", True)[0]) for w in WORLDS}


# -- repro's side -----------------------------------------------------------

REPRO_STEPWISE = """
    from repro.core.fagin import paper_exit_hook
    from repro.engine import ExecutionPolicy, QueryEngine
    from repro.graph.generators import lod_like_graph
    from repro.graph.index import InvertedIndex
    g, tokens = lod_like_graph(200, 600, seed=7, vocab=60)
    index = InvertedIndex.from_token_matrix(tokens)
    q3, bucket = lod_queries(index)
    out = {}
    for ns in WORLDS:
        for name, frac in (("uncapped", 1.0), ("capped", 0.25)):
            eng = QueryEngine.build(g, index=index, policy=ExecutionPolicy(
                partition="sharded", n_shards=ns, max_supersteps=32,
                frontier_frac=frac))
            masks, _ = eng._masks(q3)
            hook = paper_exit_hook(eng.graph, masks,
                                   eng._config(len(q3), 2), eng._e_min)
            out[f"{ns}/{name}"] = stepwise_record(eng, q3, bucket, hook)
"""


@pytest.fixture(scope="module")
def repro_stepwise():
    """``repro``'s results, computed in a subprocess while the ranks run."""
    consts = {"RESULT_FIELDS": RESULT_FIELDS, "UPDATE_FIELDS": UPDATE_FIELDS,
              "DEADLINES": DEADLINES, "WORLDS": WORLDS}
    head = "\n".join([f"{k} = {v!r}" for k, v in consts.items()]
                     + [textwrap.dedent(inspect.getsource(f)) for f in (
                         plain, summary, lod_queries, stepwise_record)])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_in_subprocess,
                          head + textwrap.dedent(REPRO_STEPWISE))


# -- the checks -------------------------------------------------------------

def same_on_every_rank(outs, key):
    for r, out in enumerate(outs):
        assert out[key] == outs[0][key], f"rank {r} differs on {key}"
    return outs[0][key]


@pytest.mark.parametrize("name", ["uncapped", "capped"])
@pytest.mark.parametrize("surface", ["stream", "deadline/0.0",
                                     "deadline/600.0", "instrumented"])
def test_stepwise_surface_equals_repro_and_the_twin(
        repro_stepwise, ranks, twin, name, surface):
    world, outs = ranks
    got = same_on_every_rank(outs, name)[surface]
    assert got == twin[world][name][surface]
    assert got == repro_stepwise.result()[f"{world}/{name}"][surface]
    if surface == "stream":
        assert got[-1]["done"] and got[0]["step"] == 0
    elif surface == "deadline/0.0":
        assert all(info["interrupted"] and info["driver_supersteps"] == 0
                   for _, info in got)
    elif surface == "deadline/600.0":
        assert not any(info["interrupted"] for _, info in got)
        assert any(r["answers"] for r, _ in got)
    else:
        assert got["result"]["supersteps"] == len(got["history"])


def test_capped_runs_overflow(ranks):
    """The capped engine's lanes stop on overflow (``budget_hit``) with a
    finite SPA bound: the forced stop, not dropped messages."""
    _, outs = ranks
    capped = outs[0]["capped"]["deadline/600.0"]
    assert any(r["budget_hit"] for r, _ in capped)
    assert all(r["spa"] is not None for r, _ in capped if r["budget_hit"])


def test_deadline_passed_on_one_rank_stops_every_rank(ranks, twin):
    """Rank 0's clock passes the deadline ``MID_STEPS`` supersteps in, the
    others' never: every rank stops there, with the twin's results, bounds
    and state (the twin reads the same ticking clock)."""
    world, outs = ranks
    got = same_on_every_rank(outs, "mid_run")
    assert got == twin[world]["mid_run"]
    infos = [info for _, info in got["results"]]
    assert all(info["driver_supersteps"] == MID_STEPS for info in infos)
    assert any(info["interrupted"] for info in infos)


def test_stepwise_surfaces_exchange_no_more_than_the_fused_driver(ranks):
    """A stream superstep issues no more all_gathers than a fused superstep
    (the frontier exchange and the top-K merge: no node table is gathered
    between supersteps); the deadline bucket and the instrumented run add
    to their supersteps' only the init's merge and one gather of each
    lane's tables."""
    _, outs = ranks
    for out in outs:
        issued = out["issued"]
        per_fused = issued["fused"]["all_gather"]
        assert per_fused == 4
        assert issued["stream"] and all(
            s.get("all_gather", 0) <= per_fused for s in issued["stream"])
        for what, lanes in (("deadline", 3), ("instrumented", 1)):
            counts, steps = issued[what]
            assert counts["all_gather"] <= 2 + per_fused * steps + 4 * lanes


def test_paper_exit_hook_needs_the_graph_of_a_split_state():
    """Handed some of the node rows and no ``graph=``, the hook refuses
    rather than read a root's row at the wrong index."""
    g = gen.random_weighted_graph(14, 26, seed=1)
    masks = np.zeros((2, 14), bool)
    masks[0, 2] = masks[1, 9] = True
    eng = QueryEngine.build(g, index=InvertedIndex.from_token_matrix(
        np.arange(14).reshape(14, 1)), device="cpu")
    state = eng.query([2, 9], k=1, keep_state=True).state
    hook = paper_exit_hook(eng.graph, masks, eng._config(2, 1), eng._e_min)
    assert hook(state) in (True, False)
    with pytest.raises(ValueError, match="graph="):
        hook(dataclasses.replace(state, S=state.S[:, :7]))


def test_cli_under_torchrun_refuses_only_explain(monkeypatch, capsys):
    """Under ``torchrun`` (``WORLD_SIZE`` set) the CLIs refuse only a graph
    that is not split: the query CLI takes ``--explain`` (rank 0 serves,
    the other ranks follow) and ``--stream`` past its checks, and
    ``serve_dks`` refuses ``--partition single``, naming the fix, and
    takes ``--partition sharded``."""
    from repro_torch.launch import dks_query, serve_dks

    monkeypatch.setenv("WORLD_SIZE", "2")

    def init_from_env(device_type):   # past the checks: it would join
        raise RuntimeError(f"init {device_type}")

    monkeypatch.setattr(comm, "init_from_env", init_from_env)
    for flag in ("--explain", "--stream"):
        with pytest.raises(RuntimeError, match="init cpu"):
            dks_query.main(["--partition", "sharded", "--device", "cpu",
                            flag])
    with pytest.raises(SystemExit):
        serve_dks.main(["--partition", "single", "--device", "cpu",
                        "--smoke"])
    assert "pass --partition sharded" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="init cpu"):
        serve_dks.main(["--partition", "sharded", "--device", "cpu",
                        "--smoke"])
