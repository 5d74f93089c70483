"""The port's sharded DKS engine with one shard per rank against
``repro``'s sharded engine (its frontier exchange inside ``shard_map``) and
against the port's single-process twin, on the CPU.

Ranks are processes over gloo (``repro_torch.distributed.ranks.run_ranks``:
a rendezvous file under the test's temporary directory, a time limit that
kills the ranks and fails the test).  ``repro``'s side runs through
``tests.test_distributed.run_in_subprocess`` with 8 forced host devices,
started once per module and read by each test after its own ranks ran.
Tolerance: none.  Every rank, the twin and ``repro`` agree exactly,
overflow and ``budget_hit`` included, at 2 and 4 ranks.  ``DKSService``
serves the bucket on rank 0 while the other ranks follow, with the twin's
answers.  The stepwise surfaces across ranks are
``tests/test_torch_multirank_stepwise.py``'s, and the service's
``tests/test_torch_multirank_serve.py``'s.
"""

import concurrent.futures
import inspect
import json
import textwrap

import numpy as np
import pytest
import torch

from tests.test_distributed import run_in_subprocess

from repro_torch.distributed import comm
from repro_torch.distributed.ranks import run_ranks
from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.graph import generators as gen
from repro_torch.graph.index import InvertedIndex
from repro_torch.serve import DKSService, follow

RANKS_TIMEOUT_S = 120
RESULT_FIELDS = ("m", "k", "kw_nodes", "supersteps", "msgs_bfs",
                 "msgs_deep", "explored_frac", "done", "budget_hit",
                 "capped", "spa", "spa_ratio", "answers_exhausted",
                 "weights", "roots")


def jsonable(x):
    return json.loads(json.dumps(x))


def plain(x):
    if hasattr(x, "tolist"):
        return x.tolist()
    if isinstance(x, (tuple, list)):
        return [plain(v) for v in x]
    return x


def summary(res):
    out = {f: plain(getattr(res, f)) for f in RESULT_FIELDS}
    out["answers"] = [plain([a.root, a.edges, a.weight, a.raw_value,
                             a.nodes]) for a in res.answers]
    return out


# -- DKS: the sharded engine, one shard per rank ---------------------------

def dks_cases(n_shards, device):
    """The engines and queries of one shard count: ``repro``'s lod graph
    uncapped and capped, and ``tests/test_distributed.py``'s overflow
    case (a forced stop with ``budget_hit``)."""
    g, tokens = gen.lod_like_graph(200, 600, seed=7, vocab=60)
    index = InvertedIndex.from_token_matrix(tokens)
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 40]
    bucket = [toks[2:5], toks[5:8], toks[1:4]]
    go = gen.random_weighted_graph(64, 320, seed=3)
    index_o = InvertedIndex.from_token_matrix(
        (np.arange(64) % 16).reshape(64, 1))
    out = {}
    for name, frac in (("uncapped", 1.0), ("capped", 0.25)):
        eng = QueryEngine.build(g, index=index, device=device,
                                policy=ExecutionPolicy(
                                    partition="sharded", n_shards=n_shards,
                                    max_supersteps=32, frontier_frac=frac))
        out[name] = {"batch": [summary(r) for r in eng.query_batch(bucket,
                                                                   k=2)],
                     "query": summary(eng.query(toks[:2], k=2))}
    eng = QueryEngine.build(go, index=index_o, device=device,
                            policy=ExecutionPolicy(
                                partition="sharded", n_shards=n_shards,
                                exit_mode="none", frontier_frac=0.01,
                                max_supersteps=48))
    out["overflow"] = summary(eng.query([3, 3], k=1, extract=False))
    return out, eng, toks


def _dks_ranks(device, n_shards):
    out, eng, toks = dks_cases(None, device)
    assert eng.device_graph.n_shards == n_shards
    assert eng.device_graph.n_held == 1
    # The uncapped bucket again, served: rank 0 admits, the others follow.
    g, tokens = gen.lod_like_graph(200, 600, seed=7, vocab=60)
    index = InvertedIndex.from_token_matrix(tokens)
    eng = QueryEngine.build(g, index=index, device=device,
                            policy=ExecutionPolicy(partition="sharded",
                                                   max_supersteps=32))
    bucket = [toks[2:5], toks[5:8], toks[1:4]]
    if comm.rank() > 0:
        follow(eng)
    else:
        with DKSService(eng) as svc:
            futs = [svc.submit(q, k=2) for q in bucket]
            out["served"] = [[plain(f.result(RANKS_TIMEOUT_S).weights),
                              plain(f.result().result.roots)]
                             for f in futs]
    return jsonable(out)


REPRO_DKS = """
    from repro.engine import ExecutionPolicy, QueryEngine
    from repro.graph.generators import lod_like_graph, random_weighted_graph
    from repro.graph.index import InvertedIndex
    g, tokens = lod_like_graph(200, 600, seed=7, vocab=60)
    index = InvertedIndex.from_token_matrix(tokens)
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 40]
    bucket = [toks[2:5], toks[5:8], toks[1:4]]
    go = random_weighted_graph(64, 320, seed=3)
    index_o = InvertedIndex.from_token_matrix(
        (np.arange(64) % 16).reshape(64, 1))
    out = {}
    for ns in (2, 4):
        row = {}
        for name, frac in (("uncapped", 1.0), ("capped", 0.25)):
            eng = QueryEngine.build(g, index=index, policy=ExecutionPolicy(
                partition="sharded", n_shards=ns, max_supersteps=32,
                frontier_frac=frac))
            row[name] = {"batch": [summary(r) for r in eng.query_batch(
                bucket, k=2)], "query": summary(eng.query(toks[:2], k=2))}
        eng = QueryEngine.build(go, index=index_o, policy=ExecutionPolicy(
            partition="sharded", n_shards=ns, exit_mode="none",
            frontier_frac=0.01, max_supersteps=48))
        row["overflow"] = summary(eng.query([3, 3], k=1, extract=False))
        out[str(ns)] = row
"""


@pytest.fixture(scope="module")
def repro_dks():
    """``repro``'s results, computed in a subprocess while the ranks run."""
    head = "\n".join([f"RESULT_FIELDS = {RESULT_FIELDS!r}"]
                     + [textwrap.dedent(inspect.getsource(f))
                        for f in (plain, summary)])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_in_subprocess,
                          head + textwrap.dedent(REPRO_DKS))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_engine_across_ranks_equals_repro_and_the_twin(
        repro_dks, world, tmp_path):
    ranks = run_ranks(_dks_ranks, world, world, timeout_s=RANKS_TIMEOUT_S,
                      workdir=tmp_path)
    twin, eng, _ = dks_cases(world, "cpu")
    assert eng.device_graph.n_held == world
    twin = jsonable(twin)
    served = ranks[0].pop("served")
    assert served == [[b["weights"], b["roots"]]
                      for b in twin["uncapped"]["batch"]]
    for out in ranks:
        assert out == ranks[0]
    assert ranks[0] == twin
    assert ranks[0] == repro_dks.result()[str(world)]
    assert ranks[0]["overflow"]["budget_hit"] is True
    assert ranks[0]["uncapped"]["batch"][0]["answers"]


def test_no_group_means_one_shard():
    g, tokens = gen.lod_like_graph(60, 150, seed=2, vocab=20)
    eng = QueryEngine.build(g, tokens=tokens, device="cpu",
                            policy=ExecutionPolicy(partition="sharded"))
    assert eng.device_graph.n_shards == 1 and eng.device_graph.mesh is None
