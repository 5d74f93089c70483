"""The four GNNs on a mesh (``gnn_cell``'s layout: nodes and edges split
over every axis, parameters whole; GAT's node gather an explicit
all-gather in the message-passing dtype) against ``repro``'s GSPMD on the
CPU and against the port's one-process twin.

Ranks are processes over gloo (``run_ranks``): one 4-rank spawn runs the
(data 2, model 2) and (data 1, model 4) meshes, one 2-rank spawn (data 1,
model 2), while ``repro``'s side runs once in
``tests.test_distributed.run_in_subprocess`` with 8 forced host devices:
two steps of ``cells._gnn_train_step``'s body (``jax.value_and_grad`` of
``gnn_loss``, then ``adamw_update``, jitted once with the forward and
the gradients returned), on arguments placed by
``sharding_tree(mesh, in_specs)`` with ``gnn_cell``'s in-specs.

Each case is a family (two layers at its published width), a shape and
a message-passing dtype: one graph of
48 nodes (node-level), or 4 graphs of 12 (``molecule``: graph-level),
with the last 3 nodes and a tenth of the edges masked (padding) and
duplicate edges, in f32 and in bf16.  Edges 0 and E - 1, on the first
and the last rank, are the same real edge into a node that no other edge
reaches, so its messages tie in every max and min (GAT's softmax, PNA's
aggregators) across ranks.  The bf16 graphs cap every in-degree at 4 but
that node's 2, as ``tests/test_torch_gnn.py``'s bf16 test does.

Tolerances (each at ``tests/test_torch_gnn.py``'s where it has one; the
same against ``repro`` and against the twin; measured worst cases in
brackets):

- f32: forward and loss atol = rtol = 1e-5; every gradient leaf within
  1e-4 of its largest magnitude; two AdamW steps (``warmup_steps=1``,
  ``total_steps=2``): loss, ``grad_norm`` and ``lr`` 1e-5, every
  parameter within 1e-4 of its leaf's largest.
- PNA in f32: ``grad_norm`` within 1e-4 [2.8e-5] and its parameters
  1e-3 more [2.6e-4 of a leaf].  The std aggregator ``sqrt(max(E[m^2] -
  E[m]^2, 0) + 1e-5)`` is exactly 0 inside the max for many (node,
  feature) pairs here (one message, or equal ones); there
  ``jnp.maximum``'s tie passes half the gradient, and a variance one ulp
  off 0 passes all of it or none, times 1 / (2 sqrt(1e-5)) = 158.  The
  ranks' partial sums round the variance otherwise than one process's
  sums, while the forward agrees to ulps, so a gradient can change sign
  and AdamW move its element the other way: by up to lr = 3e-4 in the
  first step and 3e-5 (the cosine's floor) in the second, 6.6e-4 apart
  in all, under the 1e-3.
- bf16: forward within 5e-2 x max |output| (``tests/test_torch_gnn.py``)
  [9e-3]; the loss within 5e-2 [6e-4] and ``grad_norm`` 1e-1 [6.6e-3];
  each gradient leaf's error within 2e-1 of its norm [1.7e-1: GIN's 0-d
  ``eps`` against the twin, a sum over every node that cancels]; two
  steps' parameters within 5e-2 of their leaf's largest plus 1e-3 (a
  gradient that is bf16 noise of either sign, as above; the 0-d ``eps``
  of GIN, about 3e-4 after two steps, is held to that alone).  The ranks'
  bf16 partial sums round once more than one process's (each rank's sum,
  then the reduction's), bf16 products carry that through the layers,
  and PNA's std gradient amplifies it as above; ``tests/test_torch_gnn.py``
  holds no bf16 gradient.
- SchNet's loss is f32 in both dtypes (``gnn_loss`` calls its forward on
  the f32 parameters), so its bf16 loss, gradients and steps are held at
  the f32 bounds.
"""

import collections
import concurrent.futures
import contextlib
import dataclasses
import inspect
import textwrap
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_distributed import run_in_subprocess
from tests.test_torch_gnn import graph_fields

from repro.models import gnn as gnn_j

from repro_torch import interop
from repro_torch.configs import GNNShape, get_arch
from repro_torch.distributed import comm
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import cells
from repro_torch.models import gnn as gnn_t
from repro_torch.optim import (AdamWConfig, adamw_init, tree_leaves,
                               tree_unflatten)

RANKS_TIMEOUT_S = 300
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ("gat-cora", "gin-tu", "pna", "schnet")
SHAPES = {"node": 1, "mol": 4}
DTYPES = ("float32", "bfloat16")
OPT = {"warmup_steps": 1, "total_steps": 2}
TIE_NODE = 40                     # real, and no other edge reaches it
# GIN sums over its neighbours and then per graph: at unit features its
# graph-level logits are so far apart that the cross entropy is exactly
# 0 in f32 and so is every gradient (measured at this test's 2 layers).
GIN_X_SCALE = 0.05
CASES = [f"{a}/{s}/{d}" for a in ARCHS for s in SHAPES for d in DTYPES]
# Two layers of each family at its published width (GIN's 5, PNA's 4 and
# SchNet's 3 cut): every layer is the same program, and each layer costs
# ``repro``'s side a second or more of compile on the CPU.
LAYERS = 2
# The meshes each case runs on: every case on (data 1, model 2); the
# layout splits over every axis row-major, so (data 2, model 2) and (data
# 1, model 4) put the same blocks on the same ranks, and each takes half
# of the cases (a compile of ``repro``'s step a case and mesh costs 4 to
# 7 s on the CPU).
RUNS = {name: ["1x2"] + (["2x2"] if name.endswith("node/float32") else [])
        + (["1x4"] if name.endswith("mol/bfloat16") else [])
        for name in CASES}
KEYS = [(name, m) for name in CASES for m in RUNS[name]]
# ``gnn.collective_bytes`` held on (data 1, model 2): the node-level cases
# of the three families it counts, and PNA's edges in two chunks a rank.
BYTES_KEYS = [f"{a}/node/{d}" for a in ("gat-cora", "gin-tu", "pna")
              for d in DTYPES] + ["pna/node/bfloat16/chunked"]


def case_fields(name: str) -> dict:
    arch, shape, dtype = name.split("/")
    fields = graph_fields(get_arch(arch).family, SHAPES[shape], seed=11,
                          capped=dtype == "bfloat16")
    for k in ("edge_src", "edge_dst", "edge_mask"):
        fields[k] = fields[k].copy()
    for e in (0, -1):
        fields["edge_src"][e], fields["edge_dst"][e] = 7, TIE_NODE
        fields["edge_mask"][e] = True
    # The pair is the node's only edges, on the first and the last rank.
    into = np.flatnonzero(fields["edge_dst"] == TIE_NODE)
    assert list(into) == [0, len(fields["edge_dst"]) - 1]
    if arch == "gin-tu":
        fields["x"] = fields["x"] * GIN_X_SCALE
    return fields


def case_cfg(name: str):
    arch, _, dtype = name.split("/")
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, mp_dtype=dtype,
                               n_layers=min(cfg.n_layers, LAYERS))


def case_shape(name: str, fields: dict) -> GNNShape:
    """The ``GNNShape`` whose ``gnn_cell`` (divisor 8) sizes the case's
    arrays as they are."""
    n, e = len(fields["x"]), len(fields["edge_src"])
    g, d = fields["n_graphs"], fields["x"].shape[1]
    if g > 1:
        return GNNShape("mol", "molecule", n // g, e // g, d_feat=d,
                        batch_graphs=g)
    return GNNShape("node", "full_graph", n, e, d_feat=d)


def write_cases(path) -> dict:
    """Every case's fields and parameters (``init_gnn`` of the port,
    seeded), as numpy, in one file; returns their tree shapes' keys."""
    flat = {}
    for i, name in enumerate(CASES):
        fields = case_fields(name)
        params = gnn_t.init_gnn(torch.Generator().manual_seed(i),
                                case_cfg(name), fields["x"].shape[1])
        for k, v in fields.items():
            flat[f"{name}/f/{k}"] = np.asarray(v)
        for j, leaf in enumerate(tree_leaves(params)):
            flat[f"{name}/p/{j}"] = leaf.numpy()
    np.savez(path, **flat)
    return str(path)


def read_case(path, name):
    data = np.load(path)
    fields = {k.split("/")[-1]: data[k] for k in data.files
              if k.startswith(f"{name}/f/")}
    fields["n_graphs"] = int(fields["n_graphs"])
    n = sum(1 for k in data.files if k.startswith(f"{name}/p/"))
    return fields, [data[f"{name}/p/{j}"] for j in range(n)]


# -- repro's side -------------------------------------------------------------

REPRO = """
    import dataclasses as dc
    import types
    from repro import shardmap
    from repro.configs import get_arch
    from repro.configs.base import GNNShape
    from repro.launch import cells
    from repro.launch.mesh import sharding_tree
    from repro.models import gnn
    from repro.models import lm as lm_lib
    from repro.optim import AdamWConfig, adamw_init, adamw_update
    from jax.sharding import PartitionSpec as P

    leaves = lambda t: [np.asarray(x, np.float32)
                        for x in jax.tree_util.tree_leaves(t)]
    out = {}
    flat = {}
    for name in CASES:
        arch, shape_name, dtype = name.split("/")
        fields, plist = read_case(PATH, name)
        cfg = get_arch(arch).config
        cfg = dc.replace(cfg, mp_dtype=dtype,
                         n_layers=min(cfg.n_layers, LAYERS))
        g, d = fields["n_graphs"], fields["x"].shape[1]
        n, e = len(fields["x"]), len(fields["edge_src"])
        shape = (GNNShape("mol", "molecule", n // g, e // g, d_feat=d,
                          batch_graphs=g) if g > 1 else
                 GNNShape("node", "full_graph", n, e, d_feat=d))
        # The batch's specs are the cell's; its state is whole (P()) on
        # every device, as the cell's, at this test's depth.
        batch_spec = cells.gnn_cell(arch, shape, mesh_divisor=8).in_specs[1]
        template = jax.eval_shape(lambda k: gnn.init_gnn(k, cfg, d_in=d),
                                  jax.random.PRNGKey(0))
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(template),
            [jnp.asarray(p) for p in plist])
        batch = gnn.GraphBatch(**{k: (v if k == "n_graphs" else
                                      jnp.asarray(v))
                                  for k, v in fields.items()})
        graph_level = g > 1

        def objective(p, b):
            return gnn.gnn_loss(p, b, cfg), gnn.gnn_forward(p, b, cfg,
                                                            graph_level)

        for mesh_name in RUNS[name]:
            mesh = shardmap.make_mesh(tuple(MESHES[mesh_name]),
                                      ("data", "model"))
            key = f"{name}/{mesh_name}"
            with shardmap.mesh_scope(mesh):
                put = lambda x, s: jax.device_put(x, sharding_tree(mesh, s))
                state = lm_lib.TrainState(params=params,
                                          opt=adamw_init(params),
                                          step=jnp.zeros((), jnp.int32))
                state_spec = cells._tree_specs(state, P())
                state = put(state, state_spec)
                opt_cfg = AdamWConfig(**OPT)

                def step(state, b):
                    # _gnn_train_step's body (jax.value_and_grad of
                    # gnn_loss, then adamw_update), returning the forward
                    # and the gradients too: one program, run twice.
                    (loss, fwd), grads = jax.value_and_grad(
                        objective, has_aux=True)(state.params, b)
                    p, o, m = adamw_update(opt_cfg, grads, state.opt,
                                           state.params)
                    return (lm_lib.TrainState(params=p, opt=o,
                                              step=state.step + 1),
                            jnp.stack([loss, m["grad_norm"], m["lr"]]),
                            fwd, grads)

                step = jax.jit(step)
                b = put(batch, batch_spec)
                state, m1, fwd, grads = step(state, b)
                state, m2, _, _ = step(put(state, state_spec), b)
                flat[f"{key}/forward"] = np.asarray(fwd, np.float32)
                flat[f"{key}/loss"] = np.asarray(m1[0], np.float32)
                flat[f"{key}/metrics"] = np.asarray(jnp.stack([m1, m2]),
                                                    np.float32)
                for part, tree in (("grads", grads),
                                   ("params", state.params)):
                    for j, x in enumerate(leaves(tree)):
                        flat[f"{key}/{part}/{j}"] = x
    np.savez(OUT, **flat)
    out = {"path": OUT}
"""


def repro_case(data, key: str) -> dict:
    out = {k: data[f"{key}/{k}"] for k in ("forward", "loss", "metrics")}
    for part in ("grads", "params"):
        n = sum(1 for k in data.files if k.startswith(f"{key}/{part}/"))
        out[part] = [data[f"{key}/{part}/{j}"] for j in range(n)]
    return out


# -- the ranks' side and the twin -------------------------------------------------

def _state(name, fields, plist, mesh):
    """A case's parameters and its batch (this rank's block on
    ``mesh``)."""
    template = gnn_t.init_gnn(torch.Generator().manual_seed(0),
                              case_cfg(name), fields["x"].shape[1])
    params = tree_unflatten(template, [torch.from_numpy(p.copy())
                                       for p in plist])
    if mesh is not None:
        specs = cells.gnn_batch_specs(len(fields["labels"]),
                                      fields["n_graphs"])
        fields = dict(fields, **{
            f.name: cells._local(torch.from_numpy(fields[f.name]),
                                 getattr(specs, f.name), mesh).numpy()
            for f in dataclasses.fields(specs) if f.name != "n_graphs"})
    return params, interop.graph_batch_from_numpy(fields, "cpu")


def _run(name, fields, plist, mesh):
    """(forward, loss, gradients, two steps' metrics and parameters) of a
    case on ``mesh`` (this rank's block of the batch) or in one
    process."""
    cfg = case_cfg(name)
    params, batch = _state(name, fields, plist, mesh)
    with torch.no_grad():
        fwd = gnn_t.gnn_forward(params, batch, cfg, fields["n_graphs"] > 1,
                                mesh)
    out = {"forward": fwd.numpy()}
    opt, metrics = adamw_init(params), []
    for _ in range(2):
        params, opt, m = gnn_t.gnn_train_step(params, opt, batch, cfg,
                                              AdamWConfig(**OPT), mesh)
        metrics.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        if "loss" not in out:        # the first step's: ``gnn_loss``'s own
            out["loss"] = float(m["loss"])
            out["grads"] = [g.numpy() for g in m["grads"]]
    out["metrics"] = metrics
    out["params"] = [p.numpy() for p in tree_leaves(params)]
    return out


def _ranks(device, mesh_names, path):
    # One thread a rank: the graphs are tiny, and the ranks share the
    # host's cores with the other test workers.
    torch.set_num_threads(1)
    out = {}
    for mesh_name in mesh_names:
        mesh = comm.Mesh(MESHES[mesh_name], ("data", "model"), "cpu")
        for name in CASES:
            if mesh_name in RUNS[name]:
                out[f"{name}/{mesh_name}"] = _run(name, *read_case(path,
                                                                   name), mesh)
        out[f"extremum/{mesh_name}"] = _extremum(mesh)
        if mesh_name == "1x2":
            for key in BYTES_KEYS:
                name = key.removesuffix("/chunked")
                out[f"bytes/{key}"] = _bytes(name, *read_case(path, name),
                                             mesh, key.endswith("chunked"))
    return out


@contextlib.contextmanager
def _tally():
    """{(collective): bytes} of the tables passed to ``comm``'s
    collectives inside the block, each at its whole size (an all-gather's
    output, a reduce-scatter's input)."""
    got = collections.Counter()

    def counted(kind, fn, whole):
        def wrapped(x, mesh, *args):
            got[kind] += x.numel() * x.element_size() * whole(mesh, *args)
            return fn(x, mesh, *args)
        return wrapped

    one = lambda mesh, *args: 1  # noqa: E731
    with mock.patch.object(comm, "_all_reduce", counted(
            "all_reduce", comm._all_reduce, one)), \
            mock.patch.object(comm, "_reduce_scatter", counted(
                "reduce_scatter", comm._reduce_scatter, one)), \
            mock.patch.object(comm, "_gather_parts", counted(
                "all_gather", comm._gather_parts,
                lambda mesh, axes: mesh.axis_size(axes))):
        yield got


def _bytes(name, fields, plist, mesh, chunked):
    """The bytes this rank passes to the collectives in ``gnn_loss``'s
    forward (taped, as a step's) and in one ``gnn_train_step`` of a case,
    with PNA's edge chunk at half the rank's edges where ``chunked``."""
    cfg = case_cfg(name)
    params, batch = _state(name, fields, plist, mesh)
    e = batch.edge_src.shape[0]
    chunk = -(-e // 2) if chunked else gnn_t.PNA_CHUNK_EDGES
    leaves = tree_leaves(params)
    with mock.patch.object(gnn_t._pna_aggregate, "__defaults__",
                           (chunk, None)):
        for p in leaves:
            p.requires_grad_(True)
        with _tally() as fwd:
            gnn_t.gnn_loss(params, batch, cfg, mesh)
        for p in leaves:
            p.requires_grad_(False)
        with _tally() as step:
            gnn_t.gnn_train_step(params, adamw_init(params), batch, cfg,
                                 AdamWConfig(**OPT), mesh)
    return {"forward": dict(fwd), "step": dict(step), "e": e,
            "chunk": chunk}


# -- the global segment max and min -------------------------------------------

def extremum_inputs():
    """Small integers (many ties) on 32 edges into 6 nodes (node 5 gets
    none), and a cotangent per node."""
    rng = np.random.default_rng(17)
    vals = rng.integers(0, 3, (32, 3)).astype(np.float32)
    seg = rng.integers(0, 5, 32)
    cot = rng.normal(size=(2, 6, 3)).astype(np.float32)
    return vals, seg, cot


def _extremum(mesh):
    """The rank's block of the edges through ``_seg_max`` / ``_seg_min``
    on ``mesh``: the tables, and the gradient of ``sum(cot * table)`` on
    the rank's edges."""
    vals, seg, cot = extremum_inputs()
    w = comm.world_size()
    part = slice(comm.rank() * 32 // w, (comm.rank() + 1) * 32 // w)
    v = torch.from_numpy(vals[part]).requires_grad_(True)
    s = torch.from_numpy(seg[part])
    mx, mn = gnn_t._seg_max(v, s, 6, mesh), gnn_t._seg_min(v, s, 6, mesh)
    # Every rank holds the whole tables: the objective is their mean.
    obj = (torch.sum(torch.from_numpy(cot[0]) * mx.clamp(-9, 9))
           + torch.sum(torch.from_numpy(cot[1]) * mn.clamp(-9, 9))) / w
    (g,) = torch.autograd.grad(obj, v)
    return {"max": mx.detach().numpy(), "min": mn.detach().numpy(),
            "grad": g.numpy()}


# -- fixture ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gnn")
    path = write_cases(tmp / "cases.npz")
    consts = "".join(f"{n} = {globals()[n]!r}\n" for n in (
        "CASES", "MESHES", "RUNS", "OPT", "LAYERS")) + \
        f"PATH = {path!r}\nOUT = {str(tmp / 'repro.npz')!r}\n"
    body = consts + textwrap.dedent(inspect.getsource(read_case)) + \
        textwrap.dedent(REPRO)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_in_subprocess, body)
        ranks = {}
        for world, names in ((4, ["2x2", "1x4"]), (2, ["1x2"])):
            got = run_ranks(_ranks, world, names, path,
                            timeout_s=RANKS_TIMEOUT_S,
                            workdir=tmp_path_factory.mktemp(f"w{world}"))
            for key in got[0]:
                ranks[key] = [o[key] for o in got]
        data = np.load(ref.result()["path"])
    twin = {name: _run(name, *read_case(path, name), None) for name in CASES}
    return data, ranks, twin


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def leaf_close(got, want, tol, slack=0.0, what=""):
    """Within ``tol`` of the reference leaf's largest magnitude (plus
    ``slack``)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=slack + tol * max(
        float(np.abs(want).max()), 1e-30), err_msg=what)


def bounds(name: str) -> dict:
    """The case's tolerances (module docstring): ``grads`` of each leaf's
    largest magnitude, or with ``grads_norm`` of its norm; ``slack``
    added to the parameters' bound."""
    arch, _, dtype = name.split("/")
    if dtype == "float32" or arch == "schnet":
        pna = arch == "pna"
        return {"forward": 1e-5 if dtype == "float32" else 5e-2,
                "loss": 1e-5, "grad_norm": 1e-4 if pna else 1e-5,
                "grads": 1e-4, "grads_norm": False, "params": 1e-4,
                "slack": 1e-3 if pna else 0.0}
    return {"forward": 5e-2, "loss": 5e-2, "grad_norm": 1e-1,
            "grads": 2e-1, "grads_norm": True, "params": 5e-2,
            "slack": 1e-3}


def forward_whole(name: str, outs: list) -> np.ndarray:
    """The ranks' forward outputs as one: per-node blocks in rank order,
    or the per-graph output every rank holds alike."""
    arch, shape, _ = name.split("/")
    per_graph = arch == "schnet" or (arch == "gin-tu" and shape == "mol")
    if per_graph:
        for o in outs[1:]:
            np.testing.assert_array_equal(o["forward"], outs[0]["forward"])
        return outs[0]["forward"]
    return np.concatenate([o["forward"] for o in outs])


def held(got: dict, want: dict, tol: dict, what: str) -> None:
    leaf_close(got["forward"], want["forward"], tol["forward"],
               what=f"{what}: forward")
    close(got["loss"], want["loss"], tol["loss"], f"{what}: loss")
    assert len(got["grads"]) == len(want["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        if tol["grads_norm"]:
            err = np.linalg.norm(np.asarray(g, np.float64) - w)
            assert err <= tol["grads"] * np.linalg.norm(w), \
                f"{what}: gradient {i}: |g - w| {err} > {tol['grads']} |w|"
        else:
            leaf_close(g, w, tol["grads"], what=f"{what}: gradient {i}")
    got_m, want_m = np.asarray(got["metrics"]), np.asarray(want["metrics"])
    close(got_m[:, 2], want_m[:, 2], 1e-6, f"{what}: lr")
    close(got_m[:, 0], want_m[:, 0], tol["loss"], f"{what}: loss of a step")
    close(got_m[:, 1], want_m[:, 1], tol["grad_norm"],
          f"{what}: grad_norm of a step")
    for i, (g, w) in enumerate(zip(got["params"], want["params"],
                                   strict=True)):
        leaf_close(g, w, tol["params"], tol["slack"],
                   f"{what}: parameter {i} after two steps")


def whole_run(name, outs):
    """Rank 0's run with the forward of every rank; every rank's loss,
    gradients and parameters equal."""
    for o in outs[1:]:
        assert o["loss"] == outs[0]["loss"]
        for a, b in zip(o["params"], outs[0]["params"]):
            np.testing.assert_array_equal(a, b)
    return dict(outs[0], forward=forward_whole(name, outs))


@pytest.mark.parametrize("name,mesh_name", KEYS)
def test_gnn_on_a_mesh_matches_repro(runs, name, mesh_name):
    """Forward, loss, every gradient and two AdamW steps against
    ``repro``'s ``gnn_cell`` step on the same mesh and against the
    port's one-process twin."""
    data, ranks, twin = runs
    key = f"{name}/{mesh_name}"
    got = whole_run(name, ranks[key])
    tol = bounds(name)
    held(got, repro_case(data, key), tol, "repro")
    held(got, twin[name], tol, "one-process twin")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_extremum_splits_ties_across_ranks(runs, mesh_name):
    """``_seg_max`` / ``_seg_min`` on a mesh: every rank's tables equal
    JAX's ``segment_max`` / ``segment_min``, and the gradient of the
    edges of every rank together JAX's: a tie's share is the cotangent
    over the number of tied messages on every rank."""
    _, ranks, _ = runs
    vals, seg, cot = extremum_inputs()
    outs = ranks[f"extremum/{mesh_name}"]

    def objective(v):
        mx = jax.ops.segment_max(v, jnp.asarray(seg), num_segments=6)
        mn = jax.ops.segment_min(v, jnp.asarray(seg), num_segments=6)
        return (jnp.sum(cot[0] * jnp.clip(mx, -9, 9))
                + jnp.sum(cot[1] * jnp.clip(mn, -9, 9))), (mx, mn)

    (_, (mx, mn)), grad = jax.value_and_grad(objective, has_aux=True)(
        jnp.asarray(vals))
    for o in outs:
        np.testing.assert_array_equal(o["max"], np.asarray(mx))
        np.testing.assert_array_equal(o["min"], np.asarray(mn))
    got = np.concatenate([o["grad"] for o in outs])
    np.testing.assert_allclose(got, np.asarray(grad), rtol=1e-6, atol=1e-6)
    # Ties straddle ranks: some node's max is shared by edges of two.
    w = len(outs)
    owner = np.arange(32) * w // 32
    assert any(len(set(owner[(seg == v) & (vals[:, 0] == np.asarray(mx)[v, 0])]
                       )) > 1 for v in range(5))


@pytest.mark.parametrize("key", BYTES_KEYS)
def test_collective_bytes_counts_what_a_step_passes(runs, key):
    """``gnn.collective_bytes`` (``chip_smoke.py``'s bytes at
    ogb_products) equals, collective by collective, what each rank passes
    to ``comm``'s collectives in ``gnn_loss``'s forward and in the rest
    of one ``gnn_train_step``: tie counts, PNA's chunks and their
    recomputation, and the gradients' ``psum`` included."""
    _, ranks, _ = runs
    name = key.removesuffix("/chunked")
    x = case_fields(name)["x"]
    for out in ranks[f"bytes/{key}"]:
        assert gnn_t.pna_chunks(out["e"], out["chunk"]) == (
            2 if key.endswith("chunked") else 1)
        want = gnn_t.collective_bytes(case_cfg(name), x.shape[0], out["e"],
                                      x.shape[1], out["chunk"])
        for kind in ("all_gather", "reduce_scatter", "all_reduce"):
            fwd = out["forward"].get(kind, 0)
            assert fwd == want[("forward", kind)], kind
            assert out["step"].get(kind, 0) - fwd == \
                want[("backward", kind)], kind


def test_gnn_cell_on_a_mesh_builds_this_ranks_block():
    """``gnn_cell(..., mesh=)``'s batch specs are ``repro``'s and each
    argument's local shape is ``comm.local_shape``'s."""
    from repro.configs.base import GNNShape as GNNShapeJ
    from repro.launch import cells as cells_j

    shape = GNNShape("mol", "molecule", 12, 40, d_feat=12, batch_graphs=4)
    ours = cells.gnn_batch_specs(4, 4)
    theirs = cells_j.gnn_cell("gin-tu", GNNShapeJ(**dataclasses.asdict(
        shape)), mesh_divisor=8).in_specs[1]
    norm = lambda spec: tuple(  # noqa: E731
        e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    for f in dataclasses.fields(ours):
        if f.name != "n_graphs":
            assert norm(getattr(ours, f.name)) == norm(getattr(theirs,
                                                               f.name))
    sizes = {"data": 2, "model": 2}
    assert comm.local_shape((48, 12), ours.x, sizes) == (12, 12)
    assert comm.local_shape((4,), ours.labels, sizes) == (4,)
