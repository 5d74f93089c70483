"""The port's ``DKSService`` on a graph split one shard a rank — rank 0
admitting and batching, the other ranks replaying its records
(``repro_torch.serve.follow``) — against ``repro``'s ``DKSService`` over its
sharded engine and against the port's one-process service over the twin at
the same shard count, on the CPU.

As in ``tests/test_torch_multirank.py``: ranks are processes over gloo
(``repro_torch.distributed.ranks.run_ranks``, one spawn a world size), and
``repro`` runs once per module through
``tests.test_distributed.run_in_subprocess`` with 8 forced host devices,
in a thread beside the ranks.  Tolerance: none.  A fixed list of requests
(the 3-query bucket, its repeats as cache hits and single-flight, ``k=2``,
answer trees, deadline buckets at 0 s and 600 s, at ``k=3`` so that no
cached answer serves them) gets the same weights,
roots, trees and bounds on every side; every follower's replay log equals
rank 0's record log; at 2 ranks a live swap onto a ``LiveDir`` chain grown
by one delta, under client load, fails no request and answers as an
engine built from ``compact_chain`` and as ``repro`` after its own swap.
A follower whose replay raises ends the spawn with that error.  Rank 0's
own bookkeeping (its record log, ``on_engine``, the builds the followers
hold) is checked in one process too, as rank 0 of one rank.
"""

import concurrent.futures
import inspect
import textwrap
import threading
import time

import pytest

from tests.test_distributed import run_in_subprocess
from tests.test_torch_multirank import RANKS_TIMEOUT_S, jsonable

from repro_torch.distributed import comm
from repro_torch.distributed.ranks import run_ranks
from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.graph import generators as gen
from repro_torch.graph.index import InvertedIndex
from repro_torch.live import EngineSwapper, LiveDir
from repro_torch.serve import DKSService, ServeConfig, follow
from repro_torch.serve.follower import KEEP_BUILDS, Record, hold
from repro_torch.store import compact_chain, ingest_tsv

WORLDS = (2, 4)
SERVE_TIMEOUT_S = 60
CONFIG = {"max_batch": 4, "max_wait_ms": 20.0, "cache_size": 64,
          "pad_batches": "max"}     # one lane count: fewer repro compiles
RING, GROUPS = 32, 4               # the live graph: a ring of entities
POOL = [["e000", "e008"], ["e004", "g1"], ["e010", "g2"], ["e020", "g3"]]
POST = POOL + [["fresh", "g0"]]    # asked after the swap
FRAGMENT = ("e000 g0\te008 g0\tshortcut\t1.0\n"
            "zzz fresh\te000 g0\tmentions\t0.9\n")


def ring_tsv() -> str:
    return "".join(f"e{i:03d} g{i % GROUPS}\te{(i + 1) % RING:03d} "
                   f"g{(i + 1) % RING % GROUPS}\tknows\t1.0\n"
                   for i in range(RING))


def lod_queries(index):
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 40]
    return toks, [toks[2:5], toks[5:8], toks[1:4]]


def served_record(srv):
    """What a served answer must share across the implementations."""
    def num(x):
        return None if x is None else float(x)

    out = {"weights": srv.result.weights.tolist(),
           "roots": srv.result.roots.tolist(),
           "approximate": bool(srv.approximate),
           "opt_lower_bound": num(srv.opt_lower_bound),
           "sound_opt_lower_bound": num(srv.sound_opt_lower_bound),
           "trees": None}
    if srv.trees is not None:
        out["trees"] = [[int(t.root), float(t.weight),
                         [int(v) for v in t.nodes],
                         [[int(e.u), int(e.v)] for e in t.edges]]
                        for t in srv.trees.items]
    return out


def serve_script(svc, toks, bucket, timeout):
    """The fixed requests, burst by burst (a burst's requests in flight
    together): their served records, and whether the repeats hit the
    cache and the identical misses rode one run."""
    out = {}

    def burst(name, queries, **kw):
        futs = [svc.submit(list(q), **kw) for q in queries]
        out[name] = [served_record(f.result(timeout)) for f in futs]

    burst("bucket", bucket, k=1)
    burst("repeats", bucket + bucket, k=1)
    burst("single_flight", [toks[6:9]] * 3, k=1)
    burst("k2", bucket, k=2)
    burst("trees", bucket[:2], k=2, return_trees=True, tree_page_size=2)
    # k=3: no cached answer of another burst serves these.
    burst("deadline/0.0", bucket, k=3, deadline_ms=0.0)
    burst("deadline/600.0", bucket, k=3, deadline_ms=600_000.0)
    stats = svc.stats()
    out["warm"] = [stats.cache_hits > 0, stats.single_flight_hits > 0]
    return out


def swap_script(svc, swapper, live, fragment, timeout):
    """Client threads over ``POOL`` while ``fragment`` is appended to
    ``live`` and the service swaps onto the grown chain; then ``POST``.
    Returns the post-swap records and every failure."""
    failures, stop = [], threading.Event()

    def client(i):
        while not stop.is_set():
            try:
                svc.query(POOL[i % len(POOL)], k=1, timeout=timeout)
            except Exception as exc:
                failures.append(repr(exc))
                return

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    while svc.stats().requests < 8 and time.monotonic() < deadline:
        time.sleep(0.01)
    live.append([fragment])
    swapper.swap_to(live.chain())
    swapped = svc.stats().requests
    while svc.stats().requests < swapped + 8 and not failures \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(timeout)
    post = [served_record(svc.query(q, k=1, timeout=timeout)) for q in POST]
    return {"post": post, "failures": failures, "swaps": swapper.swaps,
            "version": svc.engine.version}


# -- the port: the ranks and the one-process twin ---------------------------

def lod_engine(device, n_shards=None):
    g, tokens = gen.lod_like_graph(200, 600, seed=7, vocab=60)
    index = InvertedIndex.from_token_matrix(tokens)
    eng = QueryEngine.build(g, index=index, device=device,
                            policy=ExecutionPolicy(
                                partition="sharded", n_shards=n_shards,
                                max_supersteps=32))
    return eng, *lod_queries(index)


def live_engine(live, device, n_shards=None):
    return QueryEngine.build(artifact=live.chain(), device=device,
                             policy=ExecutionPolicy(partition="sharded",
                                                    n_shards=n_shards,
                                                    max_supersteps=32))


def _serve_ranks(device, live_path, fragment):
    """Rank 0 serves the script (and, with ``live_path``, the swap leg);
    the other ranks follow.  Each returns its record log."""
    eng, toks, bucket = lod_engine(device)
    assert eng.device_graph.n_held == 1
    logs = []
    out = {}
    if comm.rank() > 0:
        logs.append(follow(eng))
    else:
        with DKSService(eng, ServeConfig(**CONFIG)) as svc:
            out["served"] = jsonable(serve_script(svc, toks, bucket,
                                                  SERVE_TIMEOUT_S))
        logs.append(list(svc.records))
    if live_path is not None:
        live = LiveDir(live_path)
        eng = live_engine(live, device)
        if comm.rank() > 0:
            logs.append(follow(eng))
        else:
            with DKSService(eng, ServeConfig(**CONFIG)) as svc:
                out["swap"] = jsonable(swap_script(
                    svc, EngineSwapper(svc), live, fragment,
                    SERVE_TIMEOUT_S))
            logs.append(list(svc.records))
    out["logs"] = logs
    return out


def _failing_ranks(device):
    """Rank 1's replay of the first bucket raises."""
    eng, toks, bucket = lod_engine(device)
    if comm.rank() == 1:
        def provoked(*args, **kwargs):
            raise RuntimeError("replay provoked on rank 1")

        eng.query_batch = provoked
    if comm.rank() > 0:
        follow(eng)
        return None
    with DKSService(eng, ServeConfig(**CONFIG)) as svc:
        svc.query(bucket[0], k=1, timeout=RANKS_TIMEOUT_S)
    return None


@pytest.fixture(scope="module")
def live_source(tmp_path_factory):
    """The ring as a ``LiveDir`` (for the ranks) and the fragment file."""
    tmp = tmp_path_factory.mktemp("live")
    (tmp / "ring.tsv").write_text(ring_tsv())
    live = LiveDir.initialize(tmp / "live", ingest_tsv(tmp / "ring.tsv"))
    (tmp / "frag-0001.tsv").write_text(FRAGMENT)
    return live.path, tmp / "frag-0001.tsv"


@pytest.fixture(scope="module")
def spawned(live_source, tmp_path_factory):
    """One spawn a world size, at its first use: every rank's output.
    The swap leg rides the 2-rank spawn."""
    outs = {}

    def get(world):
        if world not in outs:
            live_path, fragment = live_source if world == 2 else (None, None)
            outs[world] = run_ranks(
                _serve_ranks, world, live_path, fragment,
                timeout_s=RANKS_TIMEOUT_S,
                workdir=tmp_path_factory.mktemp("ranks"))
        return outs[world]

    return get


@pytest.fixture(params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, spawned):
    """``(world, every rank's output)``."""
    return request.param, spawned(request.param)


@pytest.fixture(scope="module")
def twin():
    """The one-process service over the twin at each world's shard
    count."""
    out = {}
    for w in WORLDS:
        eng, toks, bucket = lod_engine("cpu", w)
        with DKSService(eng, ServeConfig(**CONFIG)) as svc:
            out[w] = jsonable(serve_script(svc, toks, bucket,
                                           SERVE_TIMEOUT_S))
    return out


# -- repro's side -----------------------------------------------------------

REPRO_SERVE = """
    import tempfile
    from pathlib import Path
    from repro.engine import ExecutionPolicy, QueryEngine
    from repro.graph.generators import lod_like_graph
    from repro.graph.index import InvertedIndex
    from repro.live import EngineSwapper, LiveDir
    from repro.serve import DKSService, ServeConfig
    from repro.store import ingest_tsv
    g, tokens = lod_like_graph(200, 600, seed=7, vocab=60)
    index = InvertedIndex.from_token_matrix(tokens)
    toks, bucket = lod_queries(index)
    out = {}
    for ns in WORLDS:
        eng = QueryEngine.build(g, index=index, policy=ExecutionPolicy(
            partition="sharded", n_shards=ns, max_supersteps=32))
        with DKSService(eng, ServeConfig(**CONFIG)) as svc:
            out[str(ns)] = serve_script(svc, toks, bucket, SERVE_TIMEOUT_S)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "ring.tsv").write_text(ring_tsv())
        live = LiveDir.initialize(tmp / "live", ingest_tsv(tmp / "ring.tsv"))
        (tmp / "frag-0001.tsv").write_text(FRAGMENT)
        eng = QueryEngine.build(artifact=live.chain(), policy=ExecutionPolicy(
            partition="sharded", n_shards=2, max_supersteps=32))
        with DKSService(eng, ServeConfig(**CONFIG)) as svc:
            swap = swap_script(svc, EngineSwapper(svc), live,
                               tmp / "frag-0001.tsv", SERVE_TIMEOUT_S)
        out["swap"] = {"post": swap["post"], "failures": swap["failures"]}
"""


@pytest.fixture(scope="module")
def repro_served():
    """``repro``'s results, computed in a subprocess while the ranks run."""
    consts = {"WORLDS": WORLDS, "CONFIG": CONFIG, "RING": RING,
              "GROUPS": GROUPS, "POOL": POOL, "POST": POST,
              "FRAGMENT": FRAGMENT, "SERVE_TIMEOUT_S": SERVE_TIMEOUT_S}
    head = "\n".join(["import threading, time"]
                     + [f"{k} = {v!r}" for k, v in consts.items()]
                     + [textwrap.dedent(inspect.getsource(f)) for f in (
                         ring_tsv, lod_queries, served_record, serve_script,
                         swap_script)])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_in_subprocess,
                          head + textwrap.dedent(REPRO_SERVE))


# -- the checks -------------------------------------------------------------

@pytest.mark.parametrize("burst", ["bucket", "repeats", "single_flight",
                                   "k2", "trees"])
def test_served_answers_equal_repro_and_the_twin(repro_served, ranks, twin,
                                                 burst):
    world, outs = ranks
    got = outs[0]["served"]
    assert got[burst] == twin[world][burst]
    assert got[burst] == repro_served.result()[str(world)][burst]
    assert got["warm"] == [True, True]
    assert all(r["weights"][0] < 1e8 for r in got[burst])
    if burst == "trees":
        assert all(len(r["trees"]) == 2 for r in got[burst])


@pytest.mark.parametrize("deadline", ["0.0", "600.0"])
def test_served_deadline_buckets_equal_repro_and_the_twin(
        repro_served, ranks, twin, deadline):
    world, outs = ranks
    got = outs[0]["served"][f"deadline/{deadline}"]
    assert got == twin[world][f"deadline/{deadline}"]
    assert got == repro_served.result()[str(world)][f"deadline/{deadline}"]
    assert all(r["approximate"] == (deadline == "0.0") for r in got)
    assert all(r["sound_opt_lower_bound"] <= r["weights"][0] for r in got)


def test_every_follower_replays_rank_0s_records(ranks):
    world, outs = ranks
    lead = outs[0]["logs"]
    for r, out in enumerate(outs[1:], 1):
        assert out["logs"] == lead, f"rank {r}'s replay differs"
    for log in lead:
        assert log[0].kind == "open" and log[-1].kind == "stop"
    calls = {rec.method for rec in lead[0] if rec.kind == "call"}
    assert calls == {"query_batch", "query_deadline_batch"}
    # The padding lanes ride along: every bucket has max_batch lanes.
    assert all(len(rec.queries) == CONFIG["max_batch"] for rec in lead[0]
               if rec.kind == "call")


def test_live_swap_across_ranks(repro_served, spawned, live_source,
                                tmp_path):
    outs = spawned(2)
    for r, out in enumerate(outs[1:], 1):
        assert out["logs"][1] == outs[0]["logs"][1], f"rank {r}'s replay"
    swap = outs[0]["swap"]
    assert swap["failures"] == [] and swap["swaps"] == 1
    # Every rank installed the new build at the same record.
    log = outs[0]["logs"][1]
    kinds = [rec.kind for rec in log]
    assert kinds.count("swap") == 1
    at = kinds.index("swap")
    after = {rec.version for rec in log[at + 1:] if rec.kind == "call"}
    assert swap["version"] in after
    chain = LiveDir(live_source[0]).chain()
    assert swap["version"] == f"artifact:{chain.content_hash}"
    # The answers after the swap: the compacted chain's, and repro's.
    art = compact_chain(chain, tmp_path / "compact")
    eng = QueryEngine.build(artifact=art, device="cpu",
                            policy=ExecutionPolicy(partition="sharded",
                                                   n_shards=2,
                                                   max_supersteps=32))
    want = [[r.weights.tolist(), r.roots.tolist()]
            for r in eng.query_batch(POST, k=1)]
    got = [[r["weights"], r["roots"]] for r in swap["post"]]
    assert got == want
    assert got[0][0][0] == 1.0      # the shortcut landed
    assert swap["post"] == repro_served.result()["swap"]["post"]
    assert repro_served.result()["swap"]["failures"] == []


def test_a_follower_that_fails_ends_the_spawn(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="replay provoked on rank 1"):
        run_ranks(_failing_ranks, 2, timeout_s=RANKS_TIMEOUT_S,
                  workdir=tmp_path)
    assert time.monotonic() - t0 < RANKS_TIMEOUT_S


def test_rank_0_records_calls_and_refuses_retired_builds():
    """A service marked ``followed`` in one process is rank 0 of one rank
    (its broadcasts return at once): it logs an ``open``, a ``call`` per
    bucket and per ``on_engine`` call, and a ``stop``; a bucket that
    fails validation sends nothing; a build the followers no longer hold
    (``KEEP_BUILDS`` swaps back) fails before any record leaves."""
    eng, toks, bucket = lod_engine("cpu", 2)
    svc = DKSService(eng, ServeConfig(**CONFIG))
    svc.followed = True
    with svc:
        svc.query(bucket[0], k=1, timeout=SERVE_TIMEOUT_S)
        with pytest.raises(KeyError, match="matched no node"):
            svc.query(["no-such-token"], k=1, timeout=SERVE_TIMEOUT_S)
        ref = svc.on_engine("query", bucket[0], k=1, extract=False)
        with pytest.raises(RuntimeError, match="dispatcher thread"):
            svc.set_engine(eng)
        for v in range(KEEP_BUILDS):
            hold(svc._held, f"later-{v}", True)
        with pytest.raises(RuntimeError, match="retired"):
            svc.query(bucket[1], k=1, timeout=SERVE_TIMEOUT_S)
    kinds = [(r.kind, r.method) for r in svc.records]
    assert kinds == [("open", None), ("call", "query_batch"),
                     ("call", "query"), ("stop", None)]
    assert svc.records[2] == Record("call", eng.version, "query", bucket[0],
                                    {"k": 1, "extract": False})
    assert ref.weights.tolist() == eng.query(bucket[0], k=1).weights.tolist()
    builds = {}
    for v in ("a", "b", "c", "b"):
        hold(builds, v, v)
    assert list(builds) == ["c", "b"][-KEEP_BUILDS:]
