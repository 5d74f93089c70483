"""DCN-v2 on a mesh: ``recsys.param_specs``' row split with the grouped
bag kernel's plain version on each rank's rows, the deep tower and the
item tower split by columns, retrieval merged across ranks, and the
train step, against ``repro``'s GSPMD on the CPU and against the port's
one-process twin.

Ranks are processes over gloo (``run_ranks``): one 4-rank spawn runs the
(data 2, model 2) and (data 1, model 4) meshes, one 2-rank spawn (data 1,
model 2), while ``repro``'s side runs once in
``tests.test_distributed.run_in_subprocess`` with 8 forced host devices:
``recsys_cell``'s serve and retrieval functions, and its train step
(``_rec_train_step``) with the test's optimizer, each on arguments placed
by ``sharding_tree(mesh, in_specs)`` under the same mesh.

The config is DCN-v2's smoke config with two fields at 100,000 and
100,001 rows (each padded to 100,352 and split over ``model``), the other
24 at most 100 rows (whole), and ``mlp_dims=(32, 24)``: the first deep
layer splits by columns, the second stays whole.  Ids run past every
vocabulary and below 0, so the clip reaches the padded rows, which lie on
the last ``model`` rank.  Weights and inputs are drawn with numpy and
written to one file both sides read.

Tolerances: x0 exactly (each element is one row plus zeros); logits and
retrieval scores 1e-5 x the largest magnitude, retrieval positions
exactly (``tests/test_torch_recsys.py``); the loss, ``grad_norm`` and
every gradient leaf 1e-5 x its largest magnitude, two AdamW steps at
``tests/test_torch_train.py``'s ``warmup_steps=1, total_steps=2`` within
atol = rtol = 1e-5 (``tests/test_torch_train.py``): f32 products summed
in another order.
"""

import concurrent.futures
import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax

from tests.test_distributed import run_in_subprocess

from repro.configs import get_arch as get_arch_j
from repro.models import recsys as rec_j

from repro_torch import interop
from repro_torch.configs import DCN_V2, RecsysShape
from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec as P
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import cells
from repro_torch.launch.mesh import data_rows, gather_tree, shard_tree
from repro_torch.launch.train import make_recsys_step, recsys_loss_and_grads
from repro_torch.models import recsys as rec_t
from repro_torch.optim import (AdamWConfig, adamw_init, tree_leaves,
                               tree_map)

RANKS_TIMEOUT_S = 300
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
VOCAB = (100_000, 100_001)
MLP = (32, 24)
B, N_CAND, TOP_K = 16, 512, 100
OPT = {"warmup_steps": 1, "total_steps": 2}
TOL = 1e-5
ALL = ("pod", "data", "model")


def port_cfg():
    base = DCN_V2.smoke()
    return dataclasses.replace(base, vocab_sizes=VOCAB + base.vocab_sizes[2:],
                               mlp_dims=MLP)


def repro_cfg():
    base = get_arch_j("dcn-v2").config.smoke()
    return dataclasses.replace(base, vocab_sizes=VOCAB + base.vocab_sizes[2:],
                               mlp_dims=MLP)


# -- the case file ------------------------------------------------------------

def flatten(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat):
    """The inverse of ``flatten``: a node whose keys are all digits is a
    list."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def read_case(path):
    data = np.load(path)
    tree = unflatten({k: data[k] for k in data.files
                      if not k.startswith("__")})
    return tree, {k[2:]: data[k] for k in data.files if k.startswith("__")}


def ids(rng, cfg, n):
    """int32 [n, fields]: each field's ids over its vocabulary and past it
    (up to 1 % and 3 more), a few below 0."""
    high = np.array(cfg.vocab_sizes)
    out = (rng.random((n, len(high))) * (high * 1.01 + 3)).astype(np.int64)
    out[rng.random(out.shape) < 0.05] = -2
    return out.astype(np.int32)


def tie_cand():
    """int32[N_CAND]: 37 ids repeated in turn, so that each sits in every
    rank's block at other local positions; ids below 0 and past the
    padded table (100,352 rows) fold onto one row each in the clip."""
    base = np.array([-9, -1, 0, 7, 99_999, 100_000, 100_351, 100_352,
                     2 ** 31 - 1] + list(range(1000, 29_000, 1000)),
                    np.int64)
    assert base.size == 37
    return np.resize(base, N_CAND).astype(np.int32)


def write_case(path):
    """Weights at ``param_shapes`` (tables N(0, 0.5), weights
    N(0, 1 / fan_in), biases N(0, 0.1)) and the inputs: a serving batch,
    two training batches, one query and ``N_CAND`` candidates of which
    every fourth of the second half repeats one of the first half (another
    rank's block), so that equal scores meet in the merge."""
    cfg = port_cfg()
    rng = np.random.default_rng(29)

    def leaf(shape):
        if len(shape) == 1:
            return (rng.normal(size=shape) * 0.1).astype(np.float32)
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    shapes = rec_t.param_shapes(cfg)
    tree = {"tables": {k: (rng.normal(size=s) * 0.5).astype(np.float32)
                       for k, s in shapes["tables"].items()},
            "cross": [{k: leaf(v) for k, v in lw.items()}
                      for lw in shapes["cross"]],
            "deep": [{k: leaf(v) for k, v in lw.items()}
                     for lw in shapes["deep"]],
            "logit": leaf(shapes["logit"]), "item": leaf(shapes["item"])}
    dense = lambda n: rng.normal(size=(n, cfg.n_dense)).astype(np.float32)
    cand = ids(rng, cfg, N_CAND)[:, 0]
    cand[N_CAND // 2::4] = cand[:N_CAND // 2:4]
    inputs = {"dense": dense(B), "sparse": ids(rng, cfg, B),
              "qdense": dense(1), "qsparse": ids(rng, cfg, 1), "cand": cand,
              "tcand": tie_cand()}
    for i in range(2):
        inputs.update({f"dense{i}": dense(B), f"sparse{i}": ids(rng, cfg, B),
                       f"label{i}": rng.integers(0, 2, B).astype(np.int32)})
    np.savez(path, **flatten(tree), **{f"__{k}": v for k, v in inputs.items()})
    return str(path)


# -- repro's side -------------------------------------------------------------

REPRO = """
    import dataclasses as dc
    import types
    from repro import shardmap
    from repro.configs import get_arch
    from repro.configs.base import RecsysShape
    from repro.launch import cells
    from repro.launch.mesh import sharding_tree
    from repro.models import lm as lm_lib
    from repro.models import recsys as rec
    from repro.optim import AdamWConfig, adamw_init

    base = get_arch("dcn-v2").config.smoke()
    cfg = dc.replace(base, vocab_sizes=VOCAB + base.vocab_sizes[2:],
                     mlp_dims=MLP)
    cells.get_arch = lambda arch: types.SimpleNamespace(config=cfg)
    tree, data = read_case(PATH)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    out = {}
    for name, shape in MESHES.items():
        mesh = shardmap.make_mesh(tuple(shape), ("data", "model"))
        res = {}
        with shardmap.mesh_scope(mesh):
            put = lambda x, s: jax.device_put(x, sharding_tree(mesh, s))
            serve = cells.recsys_cell("dcn-v2", RecsysShape("s", "serve", B))
            args = put((params, data["dense"], data["sparse"]),
                       serve.in_specs)
            res["x0"] = jax.jit(lambda p, d, s: rec._features(p, d, s, cfg))(
                *args)
            res["logits"] = jax.jit(serve.fn)(*args)
            ret = cells.recsys_cell("dcn-v2", RecsysShape(
                "r", "retrieval", 1, n_candidates=N_CAND))
            res["scores"], res["pos"] = jax.jit(ret.fn)(*put(
                (params, data["qdense"], data["qsparse"], data["cand"]),
                ret.in_specs))
            res["tscores"], res["tpos"] = jax.jit(ret.fn)(*put(
                (params, data["qdense"], data["qsparse"], data["tcand"]),
                ret.in_specs))
            train = cells.recsys_cell("dcn-v2", RecsysShape("t", "train", B))
            state_spec, batch_spec = train.in_specs
            state = put(lm_lib.TrainState(
                params=params, opt=adamw_init(params),
                step=jnp.zeros((), jnp.int32)), state_spec)
            batches = [put({"dense": data[f"dense{i}"],
                            "sparse": data[f"sparse{i}"],
                            "label": data[f"label{i}"]}, batch_spec)
                       for i in range(2)]
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: rec.dcn_loss(p, b, cfg)))(state.params,
                                                       batches[0])
            res["loss"], res["grads"] = loss, leaves(grads)
            step = jax.jit(cells._rec_train_step(cfg, AdamWConfig(**OPT)))
            metrics = []
            for b in batches:
                state, m = step(state, b)
                metrics.append([float(m[k]) for k in
                                ("loss", "grad_norm", "lr")])
            res["metrics"] = metrics
            res["params"] = leaves(state.params)
            res["mu"], res["nu"] = leaves(state.opt.mu), leaves(state.opt.nu)
        flat = {k: np.asarray(v) for k, v in res.items()
                if not isinstance(v, list)}
        for key in ("grads", "params", "mu", "nu"):
            flat.update({f"{key}/{i}": v for i, v in enumerate(res[key])})
        flat["metrics"] = np.asarray(metrics)
        np.savez(OUTS[name], **flat)
        out[name] = OUTS[name]
"""


def read_repro(path):
    data = np.load(path)
    out = {k: data[k] for k in data.files if "/" not in k}
    for key in ("grads", "params", "mu", "nu"):
        n = sum(1 for k in data.files if k.startswith(key + "/"))
        out[key] = [data[f"{key}/{i}"] for i in range(n)]
    return out


# -- the ranks' side ------------------------------------------------------------

def _whole(tree, mesh):
    """A tree of this rank's slices by ``param_specs`` -> whole numpy."""
    return [t.detach().numpy() for t in tree_leaves(gather_tree(
        tree, rec_t.param_specs(port_cfg()), mesh))]


def _rank_mesh(shape, path):
    mesh = comm.Mesh(shape, ("data", "model"), "cpu")
    cfg = port_cfg()
    tree, data = read_case(path)
    whole = interop.dcn_params_from_numpy(tree, cfg, "cpu")
    params = tree_map(torch.clone, shard_tree(whole, rec_t.param_specs(cfg),
                                              mesh))
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    rows = lambda x: data_rows(x, mesh)          # noqa: E731
    out = {}
    with torch.no_grad():
        out["x0"] = rec_t._features(params, rows(t["dense"]),
                                    rows(t["sparse"]), cfg, "cuda", mesh)
    out["logits"] = rec_t.dcn_forward(params, rows(t["dense"]),
                                      rows(t["sparse"]), cfg, mesh=mesh)
    cand = shard_tree(t["cand"], P(ALL), mesh)
    out["scores"], out["pos"] = rec_t.retrieval_scores(
        params, t["qdense"], t["qsparse"], cand, cfg, top_k=TOP_K, mesh=mesh)
    out["tscores"], out["tpos"] = rec_t.retrieval_scores(
        params, t["qdense"], t["qsparse"],
        shard_tree(t["tcand"], P(ALL), mesh), cfg, top_k=TOP_K, mesh=mesh)
    batches = [{k: rows(t[f"{k}{i}"]) for k in ("dense", "sparse", "label")}
               for i in range(2)]
    loss, grads, norm = recsys_loss_and_grads(params, batches[0], cfg,
                                              mesh=mesh)
    out["loss"], out["norm"] = float(loss), float(norm)
    out["grads"] = _whole(grads, mesh)
    step = make_recsys_step(cfg, AdamWConfig(**OPT), mesh=mesh)
    carry, metrics = (params, adamw_init(params)), []
    for b in batches:
        carry, m = step(carry, b)
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    out["metrics"] = metrics
    out["params"] = _whole(carry[0], mesh)
    out["mu"], out["nu"] = _whole(carry[1].mu, mesh), _whole(carry[1].nu,
                                                              mesh)
    # The entry point: recsys_cell's serve cell built on this rank.
    cells.get_arch = lambda arch: cfg
    fn, args = cells.recsys_cell("dcn-v2", RecsysShape("s", "serve", B),
                                 mesh=mesh).build(
        torch.device("cpu"), torch.Generator().manual_seed(5))
    out["cell_shapes"] = [tuple(a.shape) for a in tree_leaves(args)]
    out["cell_logits"] = fn(*args)
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _ranks(device, names, path):
    # One thread a rank: the ranks share the host's cores with the other
    # test workers.
    torch.set_num_threads(1)
    return {name: _rank_mesh(MESHES[name], path) for name in names}


# -- the one-process twin -------------------------------------------------------

def twin_run(path):
    cfg = port_cfg()
    tree, data = read_case(path)
    params = interop.dcn_params_from_numpy(tree, cfg, "cpu")
    t = {k: torch.from_numpy(v) for k, v in data.items()}
    with torch.no_grad():
        x0 = rec_t._features(params, t["dense"], t["sparse"], cfg, "cuda")
    logits = rec_t.dcn_forward(params, t["dense"], t["sparse"], cfg)
    scores, pos = rec_t.retrieval_scores(params, t["qdense"], t["qsparse"],
                                         t["cand"], cfg, top_k=TOP_K)
    tscores, tpos = rec_t.retrieval_scores(params, t["qdense"], t["qsparse"],
                                           t["tcand"], cfg, top_k=TOP_K)
    return {"x0": x0.numpy(), "logits": logits.numpy(),
            "scores": scores.numpy(), "pos": pos.numpy(),
            "tscores": tscores.numpy(), "tpos": tpos.numpy()}


# -- fixture ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcn")
    path = write_case(tmp / "case.npz")
    outs = {name: str(tmp / f"repro_{name}.npz") for name in MESHES}
    consts = "".join(f"{n} = {globals()[n]!r}\n" for n in (
        "MESHES", "VOCAB", "MLP", "B", "N_CAND", "OPT")) + \
        f"PATH = {path!r}\nOUTS = {outs!r}\n"
    body = consts + "".join(textwrap.dedent(inspect.getsource(f)) for f in (
        unflatten, read_case)) + textwrap.dedent(REPRO)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_in_subprocess, body)
        ranks = {}
        for world, names in ((4, ["2x2", "1x4"]), (2, ["1x2"])):
            got = run_ranks(_ranks, world, names, path,
                            timeout_s=RANKS_TIMEOUT_S,
                            workdir=tmp_path_factory.mktemp(f"w{world}"))
            for name in names:
                ranks[name] = [o[name] for o in got]
        paths = ref.result()
    ref = {name: read_repro(p) for name, p in paths.items()}
    return ref, ranks, twin_run(path), path


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def rows(name, outs, key):
    """The data ranks' rows of ``key``, in order, after checking that the
    ranks of each ``model`` group agree exactly."""
    data, model = MESHES[name]
    parts = []
    for f in range(data):
        group = [np.asarray(outs[f * model + j][key]) for j in range(model)]
        for g in group[1:]:
            np.testing.assert_array_equal(g, group[0])
        parts.append(group[0])
    return np.concatenate(parts)


def same_on_every_rank(outs, key):
    for o in outs[1:]:
        for a, b in zip(np.atleast_1d(o[key]), np.atleast_1d(outs[0][key])):
            np.testing.assert_array_equal(a, b)
    return outs[0][key]


NAMES = list(MESHES)


@pytest.mark.parametrize("cfg", ["full", "test"])
def test_param_specs_equal_repro(cfg):
    ours = rec_t.param_specs(DCN_V2 if cfg == "full" else port_cfg())
    theirs = rec_j.param_specs(get_arch_j("dcn-v2").config if cfg == "full"
                               else repro_cfg())
    flat_o = tree_leaves(ours, is_leaf=lambda x: isinstance(x, P))
    flat_t = jax.tree_util.tree_leaves(
        theirs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    # JAX writes a one-axis entry ("model",) as "model".
    norm = lambda spec: tuple(  # noqa: E731
        e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    assert [norm(s) for s in flat_o] == [norm(s) for s in flat_t]
    assert ours["tables"]["table_0"] == P(("model",), None)
    split = [k for k, s in ours["tables"].items() if s[0] is not None]
    assert len(split) == (11 if cfg == "full" else 2)


@pytest.mark.parametrize("name", NAMES)
def test_x0_equals_repro_exactly(runs, name):
    ref, ranks, twin, _ = runs
    got = rows(name, ranks[name], "x0")
    np.testing.assert_array_equal(got, ref[name]["x0"])
    np.testing.assert_array_equal(got, twin["x0"])


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_repro(runs, name):
    ref, ranks, twin, _ = runs
    got = rows(name, ranks[name], "logits")
    close(got, ref[name]["logits"])
    close(got, twin["logits"])


@pytest.mark.parametrize("name", NAMES)
def test_retrieval_matches_repro(runs, name):
    """Scores within 1e-5, positions exactly, ties (repeated candidates
    on two ranks) in ``lax.top_k``'s order: the lower position first."""
    ref, ranks, twin, _ = runs
    scores = same_on_every_rank(ranks[name], "scores")
    pos = same_on_every_rank(ranks[name], "pos")
    np.testing.assert_array_equal(pos, ref[name]["pos"])
    np.testing.assert_array_equal(pos, twin["pos"])
    close(scores, ref[name]["scores"])
    want = np.asarray(ref[name]["scores"])[0]
    tied = np.flatnonzero(want[1:] == want[:-1])
    assert len(tied) > 0
    assert all(pos[0, i] < pos[0, i + 1] for i in tied)


@pytest.mark.parametrize("name", NAMES)
def test_retrieval_ties_across_ranks(runs, name):
    """One id in every rank's block, at other local positions there (and
    ids the clip folds together): the top ``TOP_K`` scores are bit-equal
    for equal clipped ids, whichever rank scored them, and positions are
    ``repro``'s and the one-process twin's."""
    ref, ranks, twin, path = runs
    scores = same_on_every_rank(ranks[name], "tscores")[0]
    pos = same_on_every_rank(ranks[name], "tpos")[0]
    np.testing.assert_array_equal(pos, ref[name]["tpos"][0])
    np.testing.assert_array_equal(pos, twin["tpos"][0])
    close(scores, ref[name]["tscores"][0])
    clipped = np.clip(read_case(path)[1]["tcand"], 0, 100_351)[pos]
    owners = {int(p) * MESHES[name][0] * MESHES[name][1] // N_CAND
              for p in pos}
    assert len(owners) > 1
    for i in np.unique(clipped):
        same = scores[clipped == i]
        assert (same.view(np.int32) == same[0].view(np.int32)).all(), i
    assert len(np.unique(clipped)) < len(clipped)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_repro(runs, name):
    """Every leaf's gradient, the tables' split rows included, and the
    norm the clip reads.  A loss gradient sent back through the lookup's
    ``psum`` once per ``model`` rank would make every table's gradient
    ``model`` times ``repro``'s."""
    ref, ranks, _, _ = runs
    outs = ranks[name]
    close(same_on_every_rank(outs, "loss"), ref[name]["loss"])
    grads = ref[name]["grads"]
    assert len(outs[0]["grads"]) == len(grads)
    for o in outs:
        for g, w in zip(o["grads"], grads):
            close(g, w)
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in grads))
    close(same_on_every_rank(outs, "norm"), norm)


@pytest.mark.parametrize("name", NAMES)
def test_two_train_steps_match_repro(runs, name):
    ref, ranks, _, _ = runs
    outs = ranks[name]
    metrics = same_on_every_rank(outs, "metrics")
    np.testing.assert_allclose(metrics, ref[name]["metrics"], rtol=TOL,
                               atol=TOL)
    for key in ("params", "mu", "nu"):
        for o in outs:
            for g, w in zip(o[key], ref[name][key], strict=True):
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", NAMES)
def test_recsys_cell_builds_this_ranks_slices(runs, name):
    """``recsys_cell(..., mesh=)``'s serve cell: each argument of the shape
    ``comm.local_shape`` gives by ``repro``'s in-specs, the content the
    one-process build's (one generator seed), and the logits of its rows
    the one-process cell's."""
    _, ranks, _, _ = runs
    cfg = port_cfg()
    mp = pytest.MonkeyPatch()
    mp.setattr(cells, "get_arch", lambda arch: cfg)
    try:
        fn, args = cells.recsys_cell("dcn-v2", RecsysShape("s", "serve", B)
                                     ).build(torch.device("cpu"),
                                             torch.Generator().manual_seed(5))
    finally:
        mp.undo()
    sizes = dict(zip(("data", "model"), MESHES[name]))
    pspec = rec_t.param_specs(cfg)
    specs = tree_leaves(pspec, is_leaf=lambda x: isinstance(x, P)) + [
        P(("pod", "data"), None)] * 2
    want = [comm.local_shape(a.shape, s, sizes)
            for a, s in zip(tree_leaves(args), specs)]
    for o in ranks[name]:
        assert o["cell_shapes"] == want
    close(rows(name, ranks[name], "cell_logits"), fn(*args).numpy())


def test_reduce_replicated_orders_its_psums_by_the_leaves(monkeypatch):
    """``optim.reduce_replicated`` issues one ``psum`` per (axes, dtype) in
    the order the leaves first need it, the same on every rank (a set of
    dtypes iterates in an order that changes between processes: torch's
    dtypes hash by address), and sums each leaf over the axes its spec
    does not split."""
    from repro_torch import optim

    calls = []

    def fake_psum(x, axes, mesh=None):
        calls.append((tuple(axes), x.dtype, x.numel()))
        return x * 2

    class Grid:
        axis_names = ("data", "model")

    monkeypatch.setattr(comm, "psum", fake_psum)
    tree = {"a": torch.ones(2, dtype=torch.bfloat16),
            "b": torch.ones(3), "c": torch.ones(4),
            "d": torch.ones(5, dtype=torch.bfloat16)}
    specs = {"a": P(None), "b": P("model"), "c": P(None), "d": P(None)}
    out = optim.reduce_replicated(tree, specs, Grid())
    assert calls == [(("data", "model"), torch.bfloat16, 7),
                     (("data",), torch.float32, 3),
                     (("data", "model"), torch.float32, 4)]
    assert all(torch.equal(out[k], tree[k] * 2) for k in tree)
