"""The port's expert-parallel MoE (``_moe_sharded``, ``_moe_dense_all``,
``moe_ffn``'s dispatch rule, on this rank's block of x) and GPipe pipeline across ranks against
``repro``'s, and against their single-process twins, on the CPU.

Ranks are processes over gloo (``repro_torch.distributed.ranks.run_ranks``:
a rendezvous file under the test's temporary directory, a time limit that
kills the ranks and fails the test).  ``repro``'s side runs through
``tests.test_distributed.run_in_subprocess`` with 8 forced host devices,
in a thread while the ranks run.

Tolerances: MoE routing ids, slots, kept assignments and ``dropped_frac``
exact; y within 1e-5 and gradients within 1e-4 of ``repro`` in f32, each
times the largest magnitude of what is compared (the experts' sums run in
another order).  The pipeline: the forward within 1e-5 of ``repro``'s
plain forward, and two GPipe steps within 1e-4 of each leaf's largest
magnitude of ``repro``'s plain train step, in f32.
"""

import concurrent.futures
import dataclasses as dc
import inspect
import textwrap

import numpy as np
import pytest
import torch

from tests.test_distributed import run_in_subprocess

from repro_torch import interop
from repro_torch.configs import MoESpec, get_arch
from repro_torch.distributed import comm
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch.mesh import shard_tree
from repro_torch.models import lm as lm_lib
from repro_torch.models import moe as moe_t
from repro_torch.models import pipeline as pp
from repro_torch.optim import AdamWConfig

RANKS_TIMEOUT_S = 120


def ranks_beside_repro(body, fn, world, *args, workdir):
    """(``repro``'s JSON from ``body``, ``fn`` on ``world`` ranks), the two
    run at once."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_in_subprocess, body)
        ranks = run_ranks(fn, world, *args, timeout_s=RANKS_TIMEOUT_S,
                          workdir=workdir)
        return ref.result(), ranks


# -- MoE: expert parallelism on (data 2, model 2) ---------------------------

D, E, F_FF, N_REAL = 32, 8, 16, 7
SPEC = dict(n_experts=E, top_k=2, d_ff_expert=F_FF, capacity_factor=0.5)


def moe_inputs():
    rng = np.random.default_rng(11)
    params = {"router": rng.normal(size=(D, E)) / 4,
              "w_gate": rng.normal(size=(E, D, F_FF)) / 6,
              "w_up": rng.normal(size=(E, D, F_FF)) / 6,
              "w_down": rng.normal(size=(E, F_FF, D)) / 4}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(4, 16, D)).astype(np.float32)
    big = rng.normal(size=(2, 2048, D)).astype(np.float32)
    return (params, x, rng.normal(size=x.shape).astype(np.float32),
            rng.normal(size=(64, D)).astype(np.float32), big)


def _local_grads(loss, leaves):
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _moe_ranks(device, params_np, x_np, ct_np, ctd_np, big_np):
    mesh = comm.Mesh((2, 2), ("data", "model"), "cpu")
    spec = MoESpec(**SPEC)
    full = {k: torch.from_numpy(v) for k, v in params_np.items()}
    local = {k: v.requires_grad_(True)
             for k, v in shard_tree(full, moe_t.PARAM_SPECS, mesh).items()}
    f, j = mesh.axis_index("data"), mesh.axis_index("model")
    block = (slice(2 * f, 2 * f + 2), slice(8 * j, 8 * j + 8))
    x_loc = torch.from_numpy(x_np[block]).requires_grad_(True)
    y, aux, route = moe_t._moe_sharded(local, x_loc, spec, N_REAL, mesh)
    # Each rank's share of the objective is its own block's.
    grads = _local_grads((y * torch.from_numpy(ct_np[block])).sum(),
                         [*local.values(), x_loc])
    out = {"y": y.detach().numpy(), "aux": {k: float(v)
                                             for k, v in aux.items()},
           "route": [r.numpy() for r in route], "grads": grads}
    x = torch.from_numpy(x_np.reshape(-1, D)).requires_grad_(True)
    yd, auxd = moe_t._moe_dense_all(local, x, spec, N_REAL, mesh)
    # y is whole on all 4 ranks: each adds a quarter of the objective.
    out["dense"] = {"y": yd.detach().numpy(), "aux": {
        k: float(v) for k, v in auxd.items()}, "grads": _local_grads(
        (yd * torch.from_numpy(ctd_np)).sum() / 4, [*local.values(), x])}
    # moe_ffn takes this rank's block of x: its rows, and with
    # ``seq_parallel`` its positions over "model".
    with torch.no_grad(), comm.mesh_scope(mesh):
        nograd = {k: v.detach() for k, v in local.items()}
        out["ffn_small"] = moe_t.moe_ffn(
            nograd, torch.from_numpy(x_np[2 * f:2 * f + 2]), spec,
            N_REAL)[0].numpy()
        out["ffn_big"] = moe_t.moe_ffn(
            nograd, torch.from_numpy(big_np[f:f + 1, 1024 * j:1024 * (j + 1)]),
            spec, N_REAL, seq_parallel=True)[0].numpy()
    return out


REPRO_MOE = """
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import shardmap
    from repro.configs.base import MoESpec
    from repro.models import moe as M
    spec = MoESpec(**SPEC)
    params, x, ct, ctd, big = moe_inputs()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    x, ct, ctd, big = map(jnp.asarray, (x, ct, ctd, big))
    mesh = shardmap.make_mesh((2, 2), ("data", "model"))
    specs = {"router": P(), "w_gate": P("model", "data", None),
             "w_up": P("model", "data", None),
             "w_down": P("model", None, "data")}
    tolist = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a).tolist(), t)
    with shardmap.mesh_scope(mesh):
        am = shardmap.get_abstract_mesh()
        sh = lambda p, x: M._moe_sharded(p, x, spec, N_REAL, am)
        y, aux = jax.jit(sh)(params, x)
        g = jax.grad(lambda p, x: jnp.sum(sh(p, x)[0] * ct),
                     argnums=(0, 1))(params, x)
        pd = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
              for k, v in params.items()}
        da = lambda p, x: M._moe_dense_all(p, x, spec, N_REAL)
        yd, auxd = jax.jit(da)(pd, x.reshape(-1, x.shape[-1]))
        gd = jax.grad(lambda p, x: jnp.sum(da(p, x)[0] * ctd),
                      argnums=(0, 1))(pd, x.reshape(-1, x.shape[-1]))
        ffn = lambda p, x: M.moe_ffn(p, x, spec, N_REAL)[0]
        small = jax.jit(ffn)(pd, x)
        large = jax.jit(ffn)(pd, big)
    routes = []
    e_pad = params["router"].shape[1]
    for f in range(2):
        for j in range(2):
            xl = x[2 * f:2 * f + 2, 8 * j:8 * j + 8].reshape(-1, x.shape[-1])
            gate, ids, probs, logits = M._route(params["router"], xl, spec,
                                                N_REAL, e_pad)
            _, slot, keep, _ = M._dispatch_local(
                xl, gate, ids, spec, e_pad, M.capacity(xl.shape[0], spec,
                                                       e_pad))
            routes.append(tolist([ids, slot, keep]))
    out = {"y": tolist(y), "aux": {k: float(v) for k, v in aux.items()},
           "grads": tolist([g[0][k] for k in ("router", "w_down", "w_gate",
                                              "w_up")] + [g[1]]),
           "routes": routes,
           "dense": {"y": tolist(yd), "aux": {k: float(v)
                                              for k, v in auxd.items()},
                     "grads": tolist([gd[0][k] for k in (
                         "router", "w_down", "w_gate", "w_up")] + [gd[1]])},
           "small": tolist(small), "large": tolist(large)}
"""


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    params, x, ct, ctd, big = moe_inputs()
    consts = (f"SPEC = {SPEC!r}\nN_REAL = {N_REAL}\n"
              f"D, E, F_FF = {D}, {E}, {F_FF}\n"
              + textwrap.dedent(inspect.getsource(moe_inputs)))
    ref, ranks = ranks_beside_repro(
        consts + textwrap.dedent(REPRO_MOE), _moe_ranks, 4, params, x, ct,
        ctd, big, workdir=tmp_path_factory.mktemp("moe"))
    return ref, ranks, (params, x, ct, ctd, big)


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_moe_sharded_routing_is_exact(moe_runs):
    ref, ranks, _ = moe_runs
    drops = 0
    for r, out in enumerate(ranks):
        ids, slot, keep = ref["routes"][r]
        np.testing.assert_array_equal(out["route"][0], ids)
        np.testing.assert_array_equal(out["route"][1], slot)
        np.testing.assert_array_equal(out["route"][2], keep)
        drops += int((~np.asarray(keep)).sum())
        assert out["aux"]["dropped_frac"] == ref["aux"]["dropped_frac"]
    assert drops > 0


def test_moe_sharded_output_and_grads_match_repro_and_the_twin(moe_runs):
    ref, ranks, (params, x, ct, _, _) = moe_runs
    y = np.zeros_like(x)
    for r, out in enumerate(ranks):
        f, j = divmod(r, 2)
        y[2 * f:2 * f + 2, 8 * j:8 * j + 8] = out["y"]
    close(y, ref["y"], 1e-5)
    for k in ("load_balance", "router_z"):
        close(ranks[0]["aux"][k], ref["aux"][k], 1e-5)
    twin_y, twin_aux, twin_routes = moe_t.moe_sharded_twin(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), MoESpec(**SPEC), N_REAL, 2, 2)
    np.testing.assert_array_equal(y, twin_y.numpy())
    for r, out in enumerate(ranks):
        for a, b in zip(out["route"], twin_routes[r]):
            np.testing.assert_array_equal(a, b.numpy())
    # Gradients: router (replicated) summed over ranks; each expert slice
    # complete on its rank; x per block.
    router = sum(out["grads"][0] for out in ranks)
    close(router, ref["grads"][0], 1e-4)
    names = [k for k in params if k != "router"]
    by = {k: [out["grads"][1 + i] for out in ranks]
          for i, k in enumerate(names)}
    for k, dims in (("w_gate", (1, 0)), ("w_up", (1, 0)),
                    ("w_down", (2, 0))):
        whole = np.concatenate([np.concatenate(
            [by[k][2 * f + j] for f in range(2)], dims[0])
            for j in range(2)], dims[1])
        close(whole, ref["grads"][("router", "w_down", "w_gate",
                                   "w_up").index(k)], 1e-4)
    gx = np.zeros_like(x)
    for r, out in enumerate(ranks):
        f, j = divmod(r, 2)
        gx[2 * f:2 * f + 2, 8 * j:8 * j + 8] = out["grads"][-1]
    close(gx, ref["grads"][-1], 1e-4)


def test_moe_dense_all_matches_repro_and_the_twin(moe_runs):
    ref, ranks, (params, x, _, _, _) = moe_runs
    twin_y, twin_aux = moe_t.moe_dense_all_twin(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x.reshape(-1, D)), MoESpec(**SPEC), N_REAL, 2)
    for out in ranks:
        close(out["dense"]["y"], ref["dense"]["y"], 1e-5)
        close(out["dense"]["y"], twin_y.numpy(), 1e-6)
        for k in ("load_balance", "router_z", "dropped_frac"):
            assert out["dense"]["aux"][k] == ranks[0]["dense"]["aux"][k]
            close(out["dense"]["aux"][k], ref["dense"]["aux"][k], 1e-5)
    grads = [out["dense"]["grads"] for out in ranks]
    close(sum(g[0] for g in grads), ref["dense"]["grads"][0], 1e-4)
    close(sum(g[-1] for g in grads), ref["dense"]["grads"][-1], 1e-4)
    names = [k for k in params if k != "router"]
    for i, k in enumerate(names):
        dim = 2 if k == "w_down" else 1
        whole = np.concatenate([np.concatenate(
            [grads[2 * f + j][1 + i] for f in range(2)], dim)
            for j in range(2)], 0)
        close(whole, ref["dense"]["grads"][("router", "w_down", "w_gate",
                                            "w_up").index(k)], 1e-4)


class FakeMesh:
    """A (data 2, model 2) mesh's shape, without a process group."""

    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}

    def axis_size(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))


def test_moe_ffn_dispatch_rule(moe_runs, monkeypatch):
    ref, ranks, (params, x, _, _, big) = moe_runs
    mesh = FakeMesh()
    assert moe_t.dispatch_kind(*x.shape[:2], mesh) == "dense_all"
    assert moe_t.dispatch_kind(*big.shape[:2], mesh) == "sharded"
    assert moe_t.dispatch_kind(3, 2048, mesh) == "dense_all"
    assert moe_t.dispatch_kind(2, 2049, mesh) == "dense_all"
    assert moe_t.dispatch_kind(*big.shape[:2], None) == "local"
    small, large = np.asarray(ref["small"]), np.asarray(ref["large"])
    for r, out in enumerate(ranks):
        f, j = divmod(r, 2)
        close(out["ffn_small"], small[2 * f:2 * f + 2], 1e-5)
        close(out["ffn_big"], large[f:f + 1, 1024 * j:1024 * (j + 1)], 1e-5)
    # Under a mesh the whole expert stack is refused: a rank takes its
    # slice.
    monkeypatch.setattr(comm, "get_mesh", lambda: mesh)
    with pytest.raises(ValueError, match="PARAM_SPECS"):
        moe_t.moe_ffn({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x), MoESpec(**SPEC), N_REAL)


# -- the GPipe pipeline over 2 stages --------------------------------------

# ``repro``'s own GPipe test's optimizer (lr 3e-3, its default warm-up).
# With a warm-up of one step, an element whose first gradient is noise
# (-1.6e-8 where its leaf's largest is 4.4e-2) takes a full Adam step, and
# the port's plain train step lands 9e-4 from ``repro`` there as the GPipe
# step does: Adam's normalisation, not the pipeline.
PP_OPT = dict(lr=3e-3)


def pp_config():
    cfg = get_arch("chatglm3-6b").smoke()
    return dc.replace(cfg, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      vocab=128, param_dtype="float32")


def _pp_ranks(device, params_np, tokens):
    mesh = comm.Mesh((2,), ("pod",), "cpu")
    stage = mesh.axis_index("pod")
    model = interop.lm_params_from_numpy(params_np, pp_config(),
                                         device="cpu")
    pp.keep_stage_layers(model, stage, 2)
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        hidden = pp.pp_hidden_forward(model, toks, n_stages=2, n_micro=4,
                                      attn_impl="naive", mesh=mesh)
    state = lm_lib.init_train_state(model)
    step = pp.make_pp_train_step(AdamWConfig(**PP_OPT), n_stages=2,
                                 n_micro=4, attn_impl="naive", mesh=mesh)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    params = {k: p.detach().numpy() for k, p in model.named_parameters()}
    return {"hidden": hidden.numpy(), "metrics": metrics, "params": params}


REPRO_PP = """
    import dataclasses as dc
    from repro.configs import get_arch
    from repro.models import lm as lm_lib
    from repro.models import transformer as tfm
    from repro.optim import AdamWConfig
    cfg = get_arch("chatglm3-6b").config.smoke()
    cfg = dc.replace(cfg, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                     vocab=128, param_dtype="float32")
    b = tfm.build(cfg, tp=1)
    state = lm_lib.init_train_state(jax.random.PRNGKey(0), b)
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, 128)
    tolist = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a).tolist(), t)
    params0 = tolist(state.params)
    hidden, _, _ = tfm.forward(state.params, toks, b, attn_impl="naive")
    step = jax.jit(lm_lib.make_train_step(b, AdamWConfig(**PP_OPT),
                                          attn_impl="naive"))
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, 1)}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    out = {"params0": params0, "tokens": np.asarray(toks).tolist(),
           "hidden": np.asarray(hidden).tolist(), "metrics": metrics,
           "params": tolist(state.params)}
"""


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    ref = run_in_subprocess(f"PP_OPT = {PP_OPT!r}\n"
                            + textwrap.dedent(REPRO_PP))

    def arrays(tree):
        if isinstance(tree, dict):
            return {k: arrays(v) for k, v in tree.items()}
        return np.asarray(tree, np.float32)

    params0 = arrays(ref["params0"])
    tokens = np.asarray(ref["tokens"], np.int64)
    ranks = run_ranks(_pp_ranks, 2, params0, tokens,
                      timeout_s=RANKS_TIMEOUT_S,
                      workdir=tmp_path_factory.mktemp("pp"))
    return ref, ranks, arrays(ref["params"])


def test_pp_forward_matches_repro_plain_forward(pp_runs):
    ref, ranks, _ = pp_runs
    for out in ranks:
        close(out["hidden"], ref["hidden"], 1e-5)
    np.testing.assert_array_equal(ranks[0]["hidden"], ranks[1]["hidden"])


def test_gpipe_two_steps_match_repro_train_step(pp_runs):
    ref, ranks, want = pp_runs
    for out in ranks:
        np.testing.assert_allclose(out["metrics"], ref["metrics"],
                                   rtol=1e-4)
    for name in ("embed", "final_norm", "head"):
        for out in ranks:
            close(out["params"][name], want[name], 1e-4)
    for key, stacked in want["layers"].items():
        for i in range(4):
            stage, local = divmod(i, 2)
            close(ranks[stage]["params"][f"layers.{local}.{key}"],
                  stacked[i], 1e-4)
