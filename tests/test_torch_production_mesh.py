"""The catalog on ``repro``'s production meshes, against ``repro``, on the
CPU: ``pipeline.stage_layer_specs``, the GPipe step on (pod, data, model)
meshes, the counting mesh's collective bytes, the roofline's collective
term and the cells' per-rank arguments.

- ``stage_layer_specs`` equals ``repro``'s entry for entry.
- Four gloo ranks run the smoke pipeline (ChatGLM3's smoke config at 4
  layers, built at ``tp=2`` and cut by ``stage_layer_specs``) on a
  (2, 1, 2) mesh (Megatron splits over ``model``) and on a (2, 2, 1) mesh
  (FSDP gathers and the batch over ``data``) against ``repro``'s
  ``make_pp_train_step`` under 8 forced host devices (each mesh on the
  first 4), run as ``tests/test_pipeline.py`` runs it.  In f32 the hidden
  states are held within 1e-5 of the largest magnitude, two steps' loss
  and ``grad_norm`` within 1e-5 relative and every rank's slice of the
  parameters within 1e-4 of each leaf's largest magnitude.  In the same
  spawn each rank runs its first step under a ``count.Counter``: its
  collective bytes equal, kind by kind, a tally of the bytes the rank
  passed to ``comm`` and the counting mesh's count of the same step on
  ``meta``, and it counts op for op what the counting mesh counts (no
  ``torch.distributed`` op is taken for device-memory traffic).
- A GNN step counted on a counting (1, 2) mesh equals
  ``gnn.collective_bytes``; the port's wire bytes equal ``repro``'s
  ``HLOSummary.total_collective_bytes`` on the same bytes.
- Each rank's cell arguments on both meshes equal ``repro``'s cell's
  arguments cut by its in-specs (no compile on either side).
"""

import collections
import concurrent.futures
import contextlib
import dataclasses as dc
import json
import textwrap
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.launch.cells as jc
from repro.analysis.hlo import HLOSummary
from repro.configs import get_arch as repro_get_arch
from repro.models import pipeline as jpp
from repro.models import transformer as jtfm
from tests.test_distributed import run_in_subprocess
from tests.test_torch_accounting import port_specs

from repro_torch import interop
from repro_torch.analysis import count_call
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.count import Counter, CountSummary
from repro_torch.configs import LM_SHAPES, GNNShape, get_arch
from repro_torch.distributed import comm
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_production_mesh, shard_lm
from repro_torch.models import gnn as gnn_t
from repro_torch.models import lm as lm_lib
from repro_torch.models import pipeline as pp
from repro_torch.models import transformer as tfm
from repro_torch.models.common import DP
from repro_torch.optim import AdamWConfig

META = torch.device("meta")
LMS = ("qwen1.5-4b", "chatglm3-6b", "command-r-plus-104b", "dbrx-132b",
       "granite-moe-3b-a800m")
RANKS_TIMEOUT_S = 300
# (pod, data, model): Megatron over model, then FSDP and rows over data.
PP_SHAPES = ((2, 1, 2), (2, 2, 1))
# The pipelines held, each on its meshes: ChatGLM3 on both, granite's MoE
# stages (``moe_block(..., fsdp=)``) on (2, 1, 2).
PP_ARCH, PP_MOE_ARCH = "chatglm3-6b", "granite-moe-3b-a800m"
PP_RUNS = ((PP_ARCH, PP_SHAPES), (PP_MOE_ARCH, ((2, 1, 2),)))
GATE_TOL = 1e-6             # ROADMAP §3, handled, item 6: f32 exp's ulp
PP_AXES = ("pod", "data", "model")
# repro's own GPipe test's optimizer (lr 3e-3, its default warm-up).
PP_OPT = dict(lr=3e-3)


def _flat(tree, prefix=""):
    """{path: spec} of a spec tree (port or repro), an entry of one axis
    as its name (jax's ``PartitionSpec`` stores ``("model",)`` so)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                               else e for e in tree)}


def _pp_config(tp_cfg=get_arch, arch=PP_ARCH):
    cfg = tp_cfg(arch).smoke()
    return dc.replace(cfg, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      vocab=128, param_dtype="float32")


@pytest.mark.parametrize("arch,tp", [(a, 16) for a in LMS]
                         + [("chatglm3-6b/smoke", 2)])
def test_stage_layer_specs_match_repros(arch, tp):
    if arch.endswith("/smoke"):
        ours = tfm.build(_pp_config(), tp)
        theirs = jtfm.build(_pp_config(
            lambda a: repro_get_arch(a).config), tp)
    else:
        ours = tfm.build(get_arch(arch), tp)
        theirs = jtfm.build(repro_get_arch(arch).config, tp)
    assert _flat(pp.stage_layer_specs(ours)) == _flat(
        jpp.stage_layer_specs(theirs))


# -- the GPipe step on (pod 2, data 1, model 2) and (pod 2, data 2, model 1) --

REPRO_PP = """
    import dataclasses as dc
    from repro.configs import get_arch
    from repro.models import lm as lm_lib
    from repro.models import pipeline as pp
    from repro.models import transformer as tfm
    from repro.optim import AdamWConfig
    from repro.shardmap import make_mesh, mesh_scope
    cfg = get_arch(ARCH).config.smoke()
    cfg = dc.replace(cfg, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                     vocab=128, param_dtype="float32")
    b = tfm.build(cfg, tp=2)
    tolist = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a).tolist(), t)
    z = np.load(PARAMS0)
    params = {"layers": {}}
    for k in z.files:
        if k.startswith("layers/"):
            node = params["layers"]
            *path, name = k[len("layers/"):].split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[name] = jnp.asarray(z[k])
        elif k != "tokens":
            params[k] = jnp.asarray(z[k])
    toks = jnp.asarray(z["tokens"])
    with mesh_scope(make_mesh(SHAPE, ("pod", "data", "model"))):
        state = lm_lib.init_train_state(jax.random.PRNGKey(0), b)
        state = lm_lib.TrainState(params=params, opt=state.opt,
                                  step=state.step)
        hidden = jax.jit(lambda p, t: pp.pp_hidden_forward(
            p, t, b, n_stages=2, n_micro=4, attn_impl="naive"))(
            state.params, toks)
        step = jax.jit(pp.make_pp_train_step(
            b, AdamWConfig(**PP_OPT), n_stages=2, n_micro=4,
            attn_impl="naive"))
        batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    out = {"hidden": np.asarray(hidden).tolist(), "metrics": metrics,
           "params": tolist(state.params)}
"""


@contextlib.contextmanager
def _tally():
    """{kind: bytes} passed to ``comm``'s collectives inside the block, by
    ``repro``'s convention (an all-gather's result, every other kind's
    operand), counted per call whatever the rank's part in it."""
    got = collections.Counter()

    def counted(kind, fn, parts):
        def wrapped(x, mesh, *args):
            got[kind] += x.numel() * x.element_size() * parts(mesh, *args)
            return fn(x, mesh, *args)
        return wrapped

    one = lambda mesh, *args: 1  # noqa: E731
    patches = {"_all_reduce": one, "_reduce_scatter": one,
               "_all_to_all": one, "_ppermute": one,
               "_gather_parts": lambda mesh, axes: mesh.axis_size(axes)}
    with contextlib.ExitStack() as stack:
        for name, parts in patches.items():
            kind = name.strip("_").replace("gather_parts", "all_gather")
            stack.enter_context(mock.patch.object(comm, name, counted(
                kind, getattr(comm, name), parts)))
        yield got


def _stage_model(arch, params_np, mesh):
    b = tfm.build(_pp_config(arch=arch), 2)
    whole = interop.lm_params_from_numpy(params_np, b, device="cpu")
    model = shard_lm(whole, mesh, pp.stage_layer_specs(b))
    return pp.keep_stage_layers(model, mesh.axis_index("pod"), 2)


def _rows(tokens, n_data: int, i: int):
    """Data rank ``i``'s rows of the batch: ``lm_pp_cell``'s
    ``P(("data",), None)``."""
    n = len(tokens) // n_data
    return tokens[i * n:(i + 1) * n]


def _count_of(c: Counter) -> dict:
    """What a counter saw: collective bytes by kind, eager bytes, and
    {op: (calls, bytes, FLOPs)}."""
    s = c.summary()
    return {"collective_bytes": s.collective_bytes,
            "eager_bytes": s.eager_bytes,
            "ops": {k: (v.calls, v.nbytes, v.flops)
                    for k, v in c.ops.items()}}


def _routed(fn):
    """``fn()`` and every call of the MoE router inside it: the router,
    its input, the gates, the ids and the aux's dropped fraction."""
    from repro_torch.models import moe as moe_lib

    calls = []
    route, aux = moe_lib._route, moe_lib._aux

    def spy_route(router, x, spec, n_real, e_pad):
        out = route(router, x, spec, n_real, e_pad)
        calls.append({"router": router.detach().numpy().copy(),
                      "x": x.detach().float().numpy().copy(),
                      "gate": out[0].detach().numpy().copy(),
                      "ids": out[1].numpy().copy(), "n_real": n_real,
                      "e_pad": e_pad})
        return out

    def spy_aux(*args, **kwargs):
        out = aux(*args, **kwargs)
        calls[-1]["dropped"] = float(out["dropped_frac"])
        return out

    with mock.patch.object(moe_lib, "_route", spy_route), \
            mock.patch.object(moe_lib, "_aux", spy_aux):
        return fn(), calls


def _pp_rank(arch, mesh, params_np, tokens):
    model = _stage_model(arch, params_np, mesh)
    toks = torch.from_numpy(_rows(tokens, mesh.axis_size("data"),
                                  mesh.axis_index("data")))
    with torch.no_grad():
        hidden, routed = _routed(lambda: pp.pp_hidden_forward(
            model, toks, n_stages=2, n_micro=4, attn_impl="naive",
            mesh=mesh))
    state = lm_lib.init_train_state(model)
    step = pp.make_pp_train_step(AdamWConfig(**PP_OPT), n_stages=2,
                                 n_micro=4, attn_impl="naive", mesh=mesh)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    with _tally() as tally, Counter() as c:
        state, m = step(state, batch)
    metrics = [[float(m["loss"]), float(m["grad_norm"])]]
    state, m = step(state, batch)
    metrics.append([float(m["loss"]), float(m["grad_norm"])])
    params = {k: p.detach().numpy() for k, p in model.named_parameters()}
    return {"hidden": hidden.numpy(), "metrics": metrics, "params": params,
            "coords": mesh.coords, "passed": dict(tally),
            "count": _count_of(c), "routed": routed}


def _pp_ranks(device, inputs):
    """Every pipeline of :data:`PP_RUNS` on this rank, by (arch, mesh)."""
    torch.set_num_threads(1)
    return {(arch, shape): _pp_rank(arch, comm.Mesh(shape, PP_AXES, "cpu"),
                                    *inputs[arch])
            for arch, shapes in PP_RUNS for shape in shapes}


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _params0(arch):
    """The smoke model's weights at ``tp=2`` (the port's ``init_lm``) as
    ``repro``'s param tree of numpy arrays, and the tokens."""
    model = tfm.init_lm(tfm.build(_pp_config(arch=arch), 2),
                        torch.Generator().manual_seed(0))
    named = {k: p.detach().numpy() for k, p in model.named_parameters()}
    tree = {k: v for k, v in named.items() if not k.startswith("layers.")}
    n = len(model.layers)
    tree["layers"] = {k[len("layers.0."):]: np.stack(
        [named[f"layers.{i}.{k[len('layers.0.'):]}"] for i in range(n)])
        for k in named if k.startswith("layers.0.")}
    return tree, np.random.default_rng(1).integers(0, 128, (8, 16))


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """``repro``'s pipeline (a subprocess an (arch, mesh)) and the 4 ranks
    (one spawn for every run), at once."""
    workdir = tmp_path_factory.mktemp("pp3")
    inputs, paths = {}, {}
    for arch, _ in PP_RUNS:
        params0, tokens = inputs[arch] = _params0(arch)
        paths[arch] = workdir / f"{arch}.npz"
        np.savez(paths[arch], tokens=tokens,
                 **{k: v for k, v in params0.items() if k != "layers"},
                 **{f"layers/{k}": v for k, v in params0["layers"].items()})
    runs = [(arch, shape) for arch, shapes in PP_RUNS for shape in shapes]
    with concurrent.futures.ThreadPoolExecutor(len(runs) + 1) as pool:
        refs = {run: pool.submit(
            run_in_subprocess, f"PP_OPT = {PP_OPT!r}\nPARAMS0 = "
            f"{str(paths[run[0]])!r}\nSHAPE = {run[1]!r}\nARCH = "
            f"{run[0]!r}\n" + textwrap.dedent(REPRO_PP)) for run in runs}
        counted = pool.submit(_counted)
        ranks = run_ranks(_pp_ranks, 4, inputs, timeout_s=RANKS_TIMEOUT_S,
                          workdir=workdir)
        ref = {run: r.result() for run, r in refs.items()}
    return ref, ranks, counted.result(), {
        run: _arrays(ref[run]["params"]) for run in runs}


def _counted() -> dict:
    """{(arch, mesh shape, stage): the counting mesh's count
    (:func:`_count_of`) of one step of that stage's first rank}, on
    ``meta``."""
    out = {}
    for arch, shapes in PP_RUNS:
        b = tfm.build(_pp_config(arch=arch), 2)
        for shape in shapes:
            for stage in range(shape[0]):
                rank = int(np.ravel_multi_index((stage, 0, 0), shape))
                mesh = comm.CountingMesh(shape, PP_AXES, rank=rank)
                meta = pp.keep_stage_layers(tfm.LM(
                    b, device=META, mesh=mesh,
                    specs=pp.stage_layer_specs(b)), stage, 2)
                step = pp.make_pp_train_step(
                    AdamWConfig(**PP_OPT), n_stages=2, n_micro=4,
                    attn_impl="naive", mesh=mesh)
                toks = torch.empty((8 // shape[1], 16), dtype=torch.int64,
                                   device=META)
                state = lm_lib.init_train_state(meta)
                with Counter() as c:
                    step(state, {"tokens": toks, "labels": toks})
                out[arch, shape, stage] = _count_of(c)
    return out


def _close(got, want, tol, scale=None):
    """|got - want| within ``tol`` x ``scale`` (default want's largest
    magnitude)."""
    want = np.asarray(want, np.float32)
    if scale is None:
        scale = float(np.abs(want).max())
    assert np.abs(np.asarray(got) - want).max() <= tol * max(scale, 1e-30)


def _cut(a, spec, coords, sizes):
    """A rank's slice of ``a`` by ``spec`` (axes the mesh lacks dropped)."""
    for d, entry in enumerate(comm.filter_spec(comm.PartitionSpec(*spec),
                                               tuple(sizes))):
        if entry is None:
            continue
        axes = comm.entry_axes(entry)
        n, i = 1, 0
        for ax in axes:
            n, i = n * sizes[ax], i * sizes[ax] + coords[ax]
        w = a.shape[d] // n
        a = np.take(a, range(i * w, (i + 1) * w), axis=d)
    return a


def _ranks_on(ranks, arch, shape):
    return [out[arch, shape] for out in ranks]


def _hidden_held(pp_runs, arch):
    ref, ranks, _, _ = pp_runs
    for shape in dict(PP_RUNS)[arch]:
        want = np.asarray(ref[arch, shape]["hidden"], np.float32)
        for out in _ranks_on(ranks, arch, shape):
            _close(out["hidden"], _rows(want, shape[1],
                                        out["coords"]["data"]), 1e-5,
                   float(np.abs(want).max()))


def _steps_held(pp_runs, arch):
    ref, ranks, _, want = pp_runs
    specs = _flat(pp.stage_layer_specs(tfm.build(_pp_config(arch=arch),
                                                 2)))
    for shape in dict(PP_RUNS)[arch]:
        sizes = dict(zip(PP_AXES, shape))
        for out in _ranks_on(ranks, arch, shape):
            np.testing.assert_allclose(out["metrics"],
                                       ref[arch, shape]["metrics"],
                                       rtol=1e-5, err_msg=str(shape))
            for path, spec in specs.items():
                leaf = want[arch, shape]
                for k in path.split("/"):
                    leaf = leaf[k]
                mine = _cut(leaf, spec, out["coords"], sizes)
                scale = float(np.abs(leaf).max())
                if not path.startswith("layers/"):
                    _close(out["params"][path], mine, 1e-4, scale)
                    continue
                key = path[len("layers/"):].replace("/", ".")
                for i in range(mine.shape[0]):
                    _close(out["params"][f"layers.{i}.{key}"], mine[i],
                           1e-4, scale)


def _count_held(pp_runs, arch):
    _, ranks, counted, _ = pp_runs
    for shape in dict(PP_RUNS)[arch]:
        for out in _ranks_on(ranks, arch, shape):
            got = out["count"]
            want = counted[arch, shape, out["coords"]["pod"]]
            assert out["passed"], "the ranks passed nothing to comm"
            assert {comm.KINDS[k]: v for k, v in out["passed"].items()
                    if v} == got["collective_bytes"], shape
            assert got["collective_bytes"] == want["collective_bytes"]
            assert got["collective_bytes"]["collective-permute"] > 0
            assert got["ops"] == want["ops"], shape
            assert got["eager_bytes"] == want["eager_bytes"], shape
        assert counted[arch, shape, 0]["collective_bytes"] == \
            counted[arch, shape, 1]["collective_bytes"]


def test_pp_hidden_states_match_repros(pp_runs):
    _hidden_held(pp_runs, PP_ARCH)


def test_pp_two_steps_match_repros(pp_runs):
    _steps_held(pp_runs, PP_ARCH)


def test_counting_mesh_counts_what_the_ranks_pass(pp_runs):
    """Each rank's counter, over a real gloo group, counts the bytes the
    rank passed to ``comm`` kind by kind, and counts op for op what the
    counting mesh counts of the same step on ``meta``: collectives,
    device-memory traffic and FLOPs (``torch.distributed``'s own ops
    unseen)."""
    _count_held(pp_runs, PP_ARCH)
    counted = pp_runs[2]
    # FSDP over data gathers and reduce-scatters; Megatron all-reduces.
    assert counted[PP_ARCH, (2, 2, 1), 0]["collective_bytes"][
        "all-gather"] > 0
    assert counted[PP_ARCH, (2, 2, 1), 0]["collective_bytes"][
        "reduce-scatter"] > 0


def test_pp_moe_hidden_states_match_repros(pp_runs):
    """granite's smoke config through GPipe on (2, 1, 2): its MoE stages
    (``moe_block(..., fsdp=)`` under ``stage_layer_specs``) against
    ``repro``'s ``pp_hidden_forward``."""
    _hidden_held(pp_runs, PP_MOE_ARCH)


def test_pp_moe_two_steps_match_repros(pp_runs):
    _steps_held(pp_runs, PP_MOE_ARCH)


def test_pp_moe_counting_mesh_counts_what_the_ranks_pass(pp_runs):
    _count_held(pp_runs, PP_MOE_ARCH)


def test_pp_moe_router_matches_repros(pp_runs):
    """Every routed block of the ranks' pipelined forward (each stage's
    layers at every tick): the ids and the dropped fraction equal
    ``repro``'s ``_route`` and ``_aux`` on the same router and input
    exactly, the gates to 1e-6."""
    from repro.models import moe as jm

    _, ranks, _, _ = pp_runs
    spec = repro_get_arch(PP_MOE_ARCH).config.smoke().moe
    n = 0
    for out in _ranks_on(ranks, PP_MOE_ARCH, (2, 1, 2)):
        assert out["routed"], "no routed block"
        for call in out["routed"]:
            gate, ids, probs, logits = jm._route(
                jnp.asarray(call["router"]), jnp.asarray(call["x"]), spec,
                call["n_real"], call["e_pad"])
            np.testing.assert_array_equal(call["ids"], np.asarray(ids))
            np.testing.assert_allclose(call["gate"], np.asarray(gate),
                                       rtol=0, atol=GATE_TOL)
            assert call["dropped"] == float(jm._aux(
                probs, ids, logits, call["e_pad"])["dropped_frac"])
            n += 1
    # 2 stages x 2 layers x 5 ticks on each of the 4 ranks.
    assert n == 4 * 2 * 5


# -- the counting mesh alone -------------------------------------------------

def test_counting_mesh_refuses_a_cpu_tensor():
    mesh = make_production_mesh(counting=True)
    assert comm.get_mesh() is None
    with comm.mesh_scope(mesh):
        assert comm.get_mesh() is mesh
        with pytest.raises(ValueError, match="meta"):
            comm.psum(torch.ones(3), "data")
    with pytest.raises(ValueError, match="meta"):
        comm.all_gather(torch.ones(3), "model", mesh=mesh)
    assert comm.all_gather(torch.empty(3, device=META), "model", dim=0,
                           tiled=True, mesh=mesh).shape == (48,)


@pytest.mark.parametrize("arch", ["gat-cora", "gin-tu", "pna"])
def test_gnn_step_on_a_counting_mesh_equals_the_closed_form(arch):
    """A GNN train cell counted at rank 0 of a counting (1, 2) mesh moves
    ``gnn.collective_bytes`` (held against real ranks in
    ``tests/test_torch_multirank_gnn.py``), kind by kind."""
    mesh = comm.CountingMesh((1, 2), ("data", "model"))
    shape = GNNShape("g", "full_graph", 60, 200, d_feat=12)
    cell = cells.gnn_cell(arch, shape, mesh_divisor=8, mesh=mesh)
    fn, args = cell.build(META)
    _, summary = count_call(fn, args)
    cfg = dc.replace(get_arch(arch), mp_dtype="bfloat16")
    e = args[1].edge_src.shape[0]
    want = gnn_t.collective_bytes(cfg, args[1].x.shape[0] * 2, e, 12)
    for kind in ("all_gather", "reduce_scatter", "all_reduce"):
        assert summary.collective_bytes[kind.replace("_", "-")] == (
            want[("forward", kind)] + want[("backward", kind)]), kind


def test_wire_bytes_are_repros_ring_factors():
    nbytes = {"all-gather": 3.0e9, "reduce-scatter": 2.0e9,
              "all-reduce": 5.0e8, "all-to-all": 7.0e7,
              "collective-permute": 1.1e6}
    theirs = HLOSummary(dot_flops=0.0, traffic_bytes=0.0,
                        collective_bytes=nbytes, collective_counts={},
                        dynamic_loops=0, static_loops=0, n_dots=0)
    ours = CountSummary(
        dot_flops=0.0, flops_by_dtype={}, kernel_flops=0.0,
        kernel_bytes=0.0, kernel_calls={}, eager_bytes=0.0, min_bytes=0.0,
        arg_bytes=0.0, peak_bytes=0.0, n_ops=0.0, top_bytes=[],
        top_flops=[], multiplier=[], collective_bytes=nbytes)
    assert ours.wire_bytes == theirs.total_collective_bytes()


def test_roofline_collective_term_and_chips():
    s = CountSummary(
        dot_flops=1e12, flops_by_dtype={"bfloat16": 1e12}, kernel_flops=0,
        kernel_bytes=0, kernel_calls={}, eager_bytes=1e9, min_bytes=1e9,
        arg_bytes=0, peak_bytes=0, n_ops=1, top_bytes=[], top_flops=[],
        multiplier=[], collective_bytes={"all-reduce": 9e9})
    t = rl.roofline("a", "s", s, model_flops=256e12, mesh_name="pod16x16",
                    chips=256)
    assert t.t_collective == 18e9 / rl.NVLINK_BYTES_PER_S
    assert t.bottleneck == "collective" and t.chips == 256
    assert t.useful_flops_frac == 1.0          # 256e12 / 256 chips = 1e12
    # A dot-free program takes a chip's share of the model FLOPs.
    s.flops_by_dtype = {}
    t = rl.roofline("a", "s", s, model_flops=256e12, chips=256)
    assert t.flops == 1e12
    one = rl.roofline("a", "s", s, model_flops=1e12)
    assert (one.chips, one.mesh) == (1, "card")


# -- the cells' arguments on both meshes ------------------------------------

MESH_CASES = ["chatglm3-6b__train_4k", "chatglm3-6b__long_500k",
              "granite-moe-3b-a800m__prefill_32k", "gin-tu__ogb_products",
              "dcn-v2__retrieval_cand", "dks-sec-rdfabout__superstep_m4_k2",
              "dks-bluk-bnb__superstep_dense_m4_k2"]


def _repro_local(cell, sizes):
    """(shape, dtype) of every leaf of each of ``cell``'s arguments cut by
    its in-specs, as a rank holds it."""
    out = []
    for arg, spec_tree in zip(cell.args, cell.in_specs):
        leaves = []

        def one(spec, sub):
            for leaf in jax.tree_util.tree_leaves(sub):
                leaves.append((comm.local_shape(
                    leaf.shape, comm.PartitionSpec(*spec), sizes),
                    str(leaf.dtype)))
        jax.tree_util.tree_map(one, spec_tree, arg,
                               is_leaf=lambda x: isinstance(x, JP))
        out.append(sorted(leaves))
    return out


@pytest.mark.parametrize("name,multi", [
    (n, m) for n in MESH_CASES for m in (False, True)]
    + [("chatglm3-6b__train_4k_pp2", True)])
def test_cell_on_a_production_mesh_matches_repros(name, multi):
    """Each rank's arguments are ``repro``'s cell's arguments cut by its
    in-specs, at rank 0 and at the last rank (the multi-pod mesh, or the
    single pod's)."""
    mesh0 = make_production_mesh(multi_pod=multi, counting=True)
    arch, shape = name.split("__")
    if name.endswith("_pp2"):
        want = jc.lm_pp_cell(arch, "train_4k")
    elif shape.startswith("superstep_dense"):
        want = jc.dks_cell_dense(arch[4:])
    elif arch.startswith("dks-"):
        want = jc.dks_cell(arch[4:], n_shards=mesh0.size)
    else:
        want = jc.build_cell(arch, shape, tp=16)
    theirs = _repro_local(want, mesh0.shape)
    for rank in (0, mesh0.size - 1):
        mesh = comm.CountingMesh(tuple(mesh0.shape.values()),
                                 mesh0.axis_names, rank)
        if name.endswith("_pp2"):
            got = cells.lm_pp_cell(arch, "train_4k", mesh=mesh)
        elif shape.startswith("superstep_dense"):
            got = cells.dks_cell_dense(arch[4:], mesh=mesh)
        elif arch.startswith("dks-"):
            got = cells.dks_cell(arch[4:], mesh=mesh)
        else:
            got = cells.build_cell(arch, shape, 16, mesh)
        assert got.model_flops == want.model_flops
        _, args = got.build(META)
        assert [sorted(port_specs(a)) for a in args] == theirs


def _dense_bytes(multi: bool) -> dict:
    """The dense cell's collective bytes a rank a superstep in closed form
    (bluk-bnb padded to 16,100,352 nodes, m = 4, K = 2, one lane), by
    ``mesh_superstep``'s phases over ``dp`` data ranks and 16 ``model``
    ranks."""
    v, n, k, tp = 16_100_352, 16, 2, 16
    dp = 32 if multi else 16
    rows, sets = v // dp, n // tp
    return {
        # S's sets and changed over the data ranks; the merged rows' sets
        # over model; the top-K merge's weights (f32) and cells (int64).
        "all-gather": v * sets * k * 4 + v + rows * n * k * 4
        + dp * k * (4 + 8),
        # Each destination's rows to their rank.
        "all-to-all": v * sets * k * 4,
        # The int64 message counts, changed (bool) over model, the
        # frontier and running minima [2, 2^m] (f32), the frontier test
        # (bool), e_min (f32).
        "all-reduce": 2 * 8 + rows + 2 * n * 4 + 1 + 4}


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_dense_dks_cell_bytes_equal_the_closed_form(multi):
    mesh = make_production_mesh(multi_pod=multi, counting=True)
    fn, args = cells.dks_cell_dense("bluk-bnb", mesh=mesh).build(META)
    out, summary = count_call(fn, args)
    assert summary.collective_bytes == _dense_bytes(multi)
    assert out.S.shape == args[1].S.shape == (16_100_352 // (
        32 if multi else 16), 1, 2)


@pytest.mark.parametrize("multi,folded", [(False, 16), (True, 8)],
                         ids=["single", "multi"])
def test_command_r_folds_what_a_rank_holds(multi, folded):
    """``repro``'s rule gives command-r-plus-104b__train_4k 16
    micro-batches on either mesh; a multi-pod rank holds 8 of the 256
    rows and folds them one a micro-batch (kept on purpose, ROADMAP
    §3), the single pod's 16 rows fold as ``repro``'s."""
    arch = "command-r-plus-104b"
    shape = next(s for s in LM_SHAPES if s.name == "train_4k")
    theirs = next(s for s in repro_get_arch(arch).shapes
                  if s.name == "train_4k")
    assert jc._lm_grad_accum(repro_get_arch(arch).config, theirs) == 16
    mesh = make_production_mesh(multi_pod=multi, counting=True)
    note = ("grad_accum=8 folded (repro's rule: 16; a rank holds 8 of the "
            "256 rows)" if multi else "grad_accum=16, folded")
    assert cells._accum(get_arch(arch), shape, DP, mesh) == (folded, note)
    assert cells.build_cell(arch, "train_4k", 16, mesh).notes == note


def test_dryrun_mesh_writes_its_record(tmp_path, capsys):
    assert dryrun.main(["--mesh", "single", "--only", "dcn-v2__serve_p99",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "pod16x16" / "dcn-v2__serve_p99.json")
                     .read_text())
    assert (rec["mesh"], rec["chips"], rec["device"]) == (
        "pod16x16", 256, "meta")
    assert rec["wire_bytes"] > 0 and rec["roofline"]["t_collective"] > 0
    assert rec["fits_one_card"] and "all-reduce" in rec["collective_bytes"]
    assert "counted, not measured" in capsys.readouterr().out
    assert dryrun.main(["--mesh", "single", "--device", "cuda"]) == 2
