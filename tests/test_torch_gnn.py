"""The port's GNN path (``repro_torch.models.gnn``, the sampler, the
partitioner, the configs and the train step) against ``repro``'s on the CPU.

Inputs are made with numpy from fixed seeds and parameters come across
through ``repro_torch.interop``, so both packages compute from the same
weights.  Graphs of 48 nodes hold nodes with no in-edges, masked (padding)
edges and nodes, and duplicate edges.  Tolerances:

- f32 forward and loss: atol = rtol = 1e-5 (the two frameworks add in
  another order); every gradient leaf within 1e-4 of its largest
  magnitude.
- bf16 (``mp_dtype="bfloat16"``): dtypes equal op for op at the points
  checked; values within 5e-2 x max |logit| at in-degree 4 or less (bf16
  sums round once per add, in another order in each framework).
- PNA's chunked aggregate: maxima and minima exactly, sums within 1e-6,
  and the gradients' tie splits (1/k among k equal maxima) equal JAX's.
- Two train steps at AdamW's default eps, each from the same state:
  loss, grad_norm and lr within 1e-5; parameters within 1e-6 of each
  leaf's largest magnitude, except where the reference gradient lies
  within (a)'s 1e-4 of zero and differs from the port's (there AdamW's
  step follows the gradient's last bits; see the test); first moments
  within 1e-4 and second within 2e-4: they hold the gradients, which
  agree to (a)'s 1e-4 (PNA's differ by up to 1.3e-5 of their largest
  there), and a square doubles that.  AdamW on equal gradients, on the
  GNN trees, at its default eps: within 1e-6, as
  ``tests/test_torch_train.py`` holds it.
- The sampler and the partitioner: equal, array for array.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as get_arch_j
from repro.configs.base import GNN_SHAPES as GNN_SHAPES_J
from repro.graph import generators as gen_j
from repro.graph import partition as part_j
from repro.graph import sampler as samp_j
from repro.graph import structure as struct_j
from repro.launch import cells as cells_j
from repro.launch import train as train_j
from repro.models import gnn as gnn_j
from repro.models import lm as lm_j
from repro.optim import optimizers as opt_j

from repro_torch import interop
from repro_torch.configs import GNN_SHAPES, GNNConfig, get_arch
from repro_torch.graph import generators as gen_t
from repro_torch.graph import partition as part_t
from repro_torch.graph import sampler as samp_t
from repro_torch.graph.structure import build_graph
from repro_torch.models import gnn as gnn_t
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               tree_leaves, tree_map)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gat-cora", "gin-tu", "pna", "schnet"]
D_FEAT, N_NODES, N_EDGES, N_SINK = 12, 48, 160, 40


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def leaf_close(got, want, tol):
    """Within ``tol`` of the reference leaf's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * scale, rtol=0)


def graph_fields(family: str, n_graphs: int = 1, seed: int = 0,
                 capped: bool = False) -> dict:
    """A batch's fields as numpy arrays: nodes N_SINK.. receive no edge,
    the last 3 nodes and a tenth of the edges are masked, 8 edges are
    duplicated.  ``capped``: every in-degree at most 4."""
    rng = np.random.default_rng(seed)
    n = N_NODES
    if capped:
        dst = np.repeat(np.arange(N_SINK), 3)
        dup = np.arange(8) * 3            # 8 edges into 8 distinct nodes
    else:
        dst = rng.integers(0, N_SINK, N_EDGES)
        dup = np.arange(8)
    src = rng.integers(0, n, len(dst))
    src, dst = np.concatenate([src, src[dup]]), np.concatenate([dst, dst[dup]])
    perm = rng.permutation(len(src))
    src, dst = src[perm], dst[perm]
    e = len(src)
    node_mask = np.ones(n, bool)
    node_mask[-3:] = False
    gid = np.arange(n) * n_graphs // n
    if family == "schnet":
        x = rng.integers(1, 10, (n, 1)).astype(np.float32)
        labels = rng.normal(size=n_graphs).astype(np.float32)
    else:
        x = rng.normal(size=(n, D_FEAT)).astype(np.float32)
        labels = rng.integers(0, 7, n_graphs if n_graphs > 1 else n)
        labels = labels.astype(np.int32)
    return {"x": x, "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32), "node_mask": node_mask,
            "edge_mask": rng.random(e) > 0.1, "labels": labels,
            "graph_ids": gid.astype(np.int32),
            "positions": (rng.normal(size=(n, 3)) * 2).astype(np.float32),
            "n_graphs": n_graphs}


def batch_j(fields: dict) -> gnn_j.GraphBatch:
    return gnn_j.GraphBatch(**{k: (v if k == "n_graphs" else jnp.asarray(v))
                               for k, v in fields.items()})


def models(arch: str, fields: dict, mp_dtype: str = "float32", seed: int = 0):
    """Both configs, ``repro``'s parameters and the port's copy of them."""
    cfg_j = dataclasses.replace(get_arch_j(arch).config, mp_dtype=mp_dtype)
    cfg = dataclasses.replace(get_arch(arch), mp_dtype=mp_dtype)
    params_j = gnn_j.init_gnn(jax.random.PRNGKey(seed), cfg_j,
                              d_in=fields["x"].shape[1])
    params = interop.gnn_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), cfg, device="cpu")
    return cfg_j, cfg, params_j, params


# --------------------------------------------------------------------------
# configs and the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_configs_equal_jax(arch):
    got, want = get_arch(arch), get_arch_j(arch).config
    assert isinstance(got, GNNConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())


def test_gnn_shapes_equal_jax():
    assert ([dataclasses.asdict(s) for s in GNN_SHAPES]
            == [dataclasses.asdict(s) for s in GNN_SHAPES_J])


def test_train_cli_refuses_gnn_as_repro_does(monkeypatch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gat-cora"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 1
    assert out.stderr.strip() == ("use examples/gnn_train_torch.py for GNN "
                                  "archs")
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "gat-cora"])
    with pytest.raises(SystemExit, match="use examples/gnn_train.py for GNN"):
        train_j.main()


# --------------------------------------------------------------------------
# (a) f32: forward, loss and every gradient
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_graphs", [1, 4], ids=["node", "graph"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, n_graphs):
    fields = graph_fields(get_arch(arch).family, n_graphs, seed=1)
    cfg_j, cfg, params_j, params = models(arch, fields)
    bj = batch_j(fields)
    graph_level = n_graphs > 1

    def loss_and_out(p):
        return (gnn_j.gnn_loss(p, bj, cfg_j),
                gnn_j.gnn_forward(p, bj, cfg_j, graph_level))

    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(
        loss_and_out, has_aux=True))(params_j)
    bt = interop.graph_batch_from_numpy(fields, "cpu")
    with torch.no_grad():
        out = gnn_t.gnn_forward(params, bt, cfg, graph_level)
    loss, grads = gnn_t.gnn_loss_and_grads(params, bt, cfg)
    assert out.shape == out_j.shape and out.dtype == torch.float32
    close(t2n(out), out_j, 1e-5)
    close(t2n(loss), loss_j, 1e-5)
    want = jax.tree_util.tree_leaves(grads_j)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert tuple(g.shape) == w.shape
        leaf_close(t2n(g), w, 1e-4)


# --------------------------------------------------------------------------
# (b) bf16 message passing: dtypes, values, SchNet's f32 loss, sums
# --------------------------------------------------------------------------


FORWARDS = {"gat": "gat_forward", "gin": "gin_forward", "pna": "pna_forward",
            "schnet": "schnet_forward"}


class _RecordConcat:
    """``jnp`` with ``concatenate`` recording its result's dtype."""

    def __init__(self, seen: list):
        self.seen = seen

    def __getattr__(self, name):
        return getattr(jnp, name)

    def concatenate(self, *a, **kw):
        out = jnp.concatenate(*a, **kw)
        self.seen.append(str(out.dtype))
        return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_dtypes_and_values_match_jax(arch, monkeypatch):
    """Each family's forward on bf16 parameters and features: its output
    dtype equal to ``repro``'s, PNA's ``h`` and ``z`` per layer too, and
    the f32 logits within 5e-2 x max |logit| at in-degree <= 4."""
    family = get_arch(arch).family
    fields = graph_fields(family, seed=2, capped=True)
    cfg_j, cfg, params_j, params = models(arch, fields, "bfloat16")
    bj = batch_j(fields)
    bt = interop.graph_batch_from_numpy(fields, "cpu")
    seen_j = {"h": [], "z": []}
    seen_t = {"h": [], "z": []}
    if family == "pna":
        agg_j, agg_t, feat_t = (gnn_j._pna_aggregate, gnn_t._pna_aggregate,
                                gnn_t._pna_features)

        def rec(fn, seen, key):
            """``fn`` recording h (its first argument) or z (its result)."""
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                seen[key].append(str((a[0] if key == "h" else out).dtype))
                return out
            return wrapped

        monkeypatch.setattr(gnn_j, "_pna_aggregate", rec(agg_j, seen_j, "h"))
        monkeypatch.setattr(gnn_j, "jnp", _RecordConcat(seen_j["z"]))
        monkeypatch.setattr(gnn_t, "_pna_aggregate", rec(agg_t, seen_t, "h"))
        monkeypatch.setattr(gnn_t, "_pna_features", rec(feat_t, seen_t, "z"))
    cast_j = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params_j)
    cast_t = tree_map(lambda p: p.to(torch.bfloat16), params)
    bj16 = dataclasses.replace(bj, x=bj.x.astype(jnp.bfloat16))
    bt16 = dataclasses.replace(bt, x=bt.x.to(torch.bfloat16))
    raw_j = jax.jit(lambda p, b: getattr(gnn_j, FORWARDS[family])(
        p, b, cfg_j))(cast_j, bj16)
    with torch.no_grad():
        raw_t = getattr(gnn_t, FORWARDS[family])(cast_t, bt16, cfg)
    assert str(raw_t.dtype).split(".")[-1] == str(raw_j.dtype)
    if family == "pna":
        # Layer 1's messages are bf16, its z f32 (bf16 / f32 degrees), so
        # every later layer passes messages in f32.
        assert seen_j["h"] == ["bfloat16"] + ["float32"] * 3
        assert seen_j["z"] == ["float32"] * 4
        assert seen_t["h"] == ["torch.bfloat16"] + ["torch.float32"] * 3
        assert seen_t["z"] == ["torch.float32"] * 4
    out_j = jax.jit(lambda p, b: gnn_j.gnn_forward(p, b, cfg_j))(params_j, bj)
    with torch.no_grad():
        out_t = gnn_t.gnn_forward(params, bt, cfg)
    bound = 5e-2 * float(np.abs(np.asarray(out_j)).max())
    np.testing.assert_allclose(t2n(out_t), np.asarray(out_j), atol=bound,
                               rtol=0)


def test_schnet_loss_stays_f32_under_bf16():
    fields = graph_fields("schnet", n_graphs=4, seed=3)
    cfg_j, cfg, params_j, params = models("schnet", fields, "bfloat16")
    bt = interop.graph_batch_from_numpy(fields, "cpu")
    with torch.no_grad():
        got = gnn_t.gnn_loss(params, bt, cfg)
        f32 = gnn_t.gnn_loss(params, bt, dataclasses.replace(
            cfg, mp_dtype="float32"))
    assert got.dtype == torch.float32 and torch.equal(got, f32)
    close(t2n(got), gnn_j.gnn_loss(params_j, batch_j(fields), cfg_j), 1e-5)


def test_bf16_sum_at_in_degree_300():
    """Hazard of bf16 sums: 300 messages into one node.  ``repro`` on the
    CPU adds in bf16, one rounding per add; the port's ``index_add`` on the
    CPU rounds far less.  Only the port's error is held: within one bf16
    ulp of the exact sum (the card's atomics round per add, as XLA does,
    and are not held here)."""
    rng = np.random.default_rng(4)
    vals = rng.normal(1.0, 0.5, size=(300, 16)).astype(np.float32)
    vals = np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    seg = np.zeros(300, np.int32)
    seg[::7] = 1                                       # a second segment
    exact = np.zeros((2, 16))
    np.add.at(exact, seg, vals.astype(np.float64))
    got_j = np.asarray(gnn_j._seg_sum(jnp.asarray(vals, jnp.bfloat16),
                                      jnp.asarray(seg), 2), np.float64)
    got_t = gnn_t._seg_sum(torch.tensor(vals).to(torch.bfloat16),
                           torch.from_numpy(seg).long(), 2)
    assert got_t.dtype == torch.bfloat16
    err_j = float(np.abs(got_j - exact).max())
    err_t = float(np.abs(got_t.double().numpy() - exact).max())
    print(f"bf16 sum of 300 messages, |exact| <= {np.abs(exact).max():.1f}: "
          f"repro err {err_j:.4f}, port err {err_t:.4f}")
    ulp = 2.0 ** (np.floor(np.log2(np.abs(exact))) - 7)
    assert np.all(np.abs(got_t.double().numpy() - exact) <= ulp)


# --------------------------------------------------------------------------
# (c) PNA's chunked, checkpointed aggregate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_edges,nc", [(42, 4), (50, 1)],
                         ids=["chunked", "unchunked"])
def test_pna_aggregate_matches_jax(chunk_edges, nc):
    """168 edges at chunk 42: 4 chunks of 42.  166 edges at chunk 50: 4
    chunks, but 166 % 4 != 0, so ``repro``'s rule takes the unchunked
    path."""
    fields = graph_fields("pna", seed=5)
    if nc == 1:
        fields = {k: (v[:166] if k in ("edge_src", "edge_dst", "edge_mask")
                      else v) for k, v in fields.items()}
    e = len(fields["edge_src"])
    assert gnn_t.pna_chunks(e, chunk_edges) == nc
    rng = np.random.default_rng(6)
    # Small integers through a ReLU: many exact zeros, many ties.
    h = np.maximum(rng.integers(-2, 3, (N_NODES, 5)), 0).astype(np.float32)
    w = rng.normal(size=(4, N_NODES, 5)).astype(np.float32)
    deg = np.zeros(N_NODES)
    np.add.at(deg, fields["edge_dst"], fields["edge_mask"])
    has = (deg > 0)[:, None]
    bj, bt = batch_j(fields), interop.graph_batch_from_numpy(fields, "cpu")

    def objective_j(hh):
        s, sq, mx, mn = gnn_j._pna_aggregate(hh, bj, N_NODES, chunk_edges)
        return (jnp.sum(w[0] * s) + jnp.sum(w[1] * sq)
                + jnp.sum(jnp.where(has, w[2] * mx, 0.0))
                + jnp.sum(jnp.where(has, w[3] * mn, 0.0))), (s, sq, mx, mn)

    (_, aggs_j), grad_j = jax.jit(jax.value_and_grad(
        objective_j, has_aux=True))(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    aggs_t = gnn_t._pna_aggregate(ht, bt, N_NODES, chunk_edges)
    wt, hast = torch.from_numpy(w), torch.from_numpy(has)
    obj = (torch.sum(wt[0] * aggs_t[0]) + torch.sum(wt[1] * aggs_t[1])
           + torch.sum(torch.where(hast, wt[2] * aggs_t[2], 0.0))
           + torch.sum(torch.where(hast, wt[3] * aggs_t[3], 0.0)))
    (grad_t,) = torch.autograd.grad(obj, ht)
    for i, (got, want) in enumerate(zip(aggs_t, aggs_j)):
        if i < 2:
            close(t2n(got), want, 1e-6)
        else:
            np.testing.assert_array_equal(t2n(got), np.asarray(want))
    # Ties occur: some node's maximum is shared by several of its messages.
    src, dst, mask = fields["edge_src"], fields["edge_dst"], fields["edge_mask"]
    mx = np.asarray(aggs_j[2])
    ties = [(mask & (dst == v) & (h[src, 0] == mx[v, 0])).sum()
            for v in range(N_SINK)]
    assert max(ties) >= 2
    close(t2n(grad_t), grad_j, 1e-6)


# --------------------------------------------------------------------------
# (d) two train steps against launch/cells.py's _gnn_train_step
# --------------------------------------------------------------------------


def state_to_port(state, cfg):
    """``repro``'s ``TrainState`` as the port's (params, OptState)."""
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return interop.gnn_state_from_numpy(
        as_np(state.params), {"mu": as_np(state.opt.mu),
                              "nu": as_np(state.opt.nu),
                              "count": np.asarray(state.opt.count)},
        cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_over_two_steps(arch):
    """``gnn_train_step`` against ``cells.py``'s ``_gnn_train_step``, two
    steps at AdamW's default eps (1e-8), each from the same state: the
    port's second starts from ``repro``'s state after the first, so that
    an element left out of the first does not move every gradient of the
    second.

    AdamW's first step moves an element by lr * g / (|g| + eps): lr *
    sign(g) wherever |g| >> eps, whatever g's rounding, but a fraction of
    lr that follows g's last bits where |g| is within some hundreds of eps,
    or g's sign where it is rounding noise.  Such gradients come from sums
    whose terms cancel: here PNA's, at 1e-7..3e-5 of their leaf's largest
    magnitude (2e-9..3e-6), differ by up to 20 % between the frameworks,
    and move their elements up to 1.1e-3 of the leaf's largest parameter
    apart (printed under ``-s``).  So the parameters are held within 1e-6
    of each leaf's largest magnitude everywhere except where the
    reference gradient lies within (a)'s gradient tolerance of zero (1e-4
    of its leaf's largest) and differs from the port's.  The moments are linear
    in the gradients and are held everywhere, to (a)'s 1e-4 (the second,
    a square, to 2e-4)."""
    family = get_arch(arch).family
    n_graphs = 4 if family in ("gin", "schnet") else 1
    fields = graph_fields(family, n_graphs, seed=7)
    cfg_j, cfg, params_j, _ = models(arch, fields, seed=3)
    oc_j = opt_j.AdamWConfig(warmup_steps=1, total_steps=2)
    oc_t = AdamWConfig(warmup_steps=1, total_steps=2)
    step_j = jax.jit(cells_j._gnn_train_step(cfg_j, oc_j))
    grad_j = jax.jit(jax.grad(lambda p, b: gnn_j.gnn_loss(p, b, cfg_j)))
    state = lm_j.TrainState(params=params_j, opt=opt_j.adamw_init(params_j),
                            step=jnp.zeros((), jnp.int32))
    bj, bt = batch_j(fields), interop.graph_batch_from_numpy(fields, "cpu")
    left_out = beyond = 0
    worst = g_far = 0.0
    for _ in range(2):
        params, opt = state_to_port(state, cfg)
        g_ref = [np.asarray(g) for g in
                 jax.tree_util.tree_leaves(grad_j(state.params, bj))]
        state, mj = step_j(state, bj)
        params, opt, mt = gnn_t.gnn_train_step(params, opt, bt, cfg, oc_t)
        for name in ("loss", "grad_norm", "lr"):
            close(t2n(mt[name]), mj[name], 1e-5)
        p_np, o_np = interop.gnn_state_to_numpy(params, opt)
        assert int(o_np["count"]) == int(state.opt.count)
        for got, want, g, gp in zip(tree_leaves(p_np),
                                    jax.tree_util.tree_leaves(state.params),
                                    g_ref, mt["grads"], strict=True):
            noise = ((np.abs(g) <= 1e-4 * np.abs(g).max())
                     & (g != t2n(gp)))
            want = np.asarray(want, np.float32)
            far = noise & (np.abs(got - want) > 1e-6 * np.abs(want).max())
            left_out += int(noise.sum())
            if far.any():
                beyond += int(far.sum())
                worst = max(worst, float(np.abs(got - want)[far].max()
                                         / np.abs(want).max()))
                g_far = max(g_far, float(np.abs(g[far]).max()
                                         / np.abs(g).max()))
            leaf_close(got, np.where(noise, got, want), 1e-6)
        for got, want, tol in ((o_np["mu"], state.opt.mu, 1e-4),
                               (o_np["nu"], state.opt.nu, 2e-4)):
            got_l, want_l = tree_leaves(got), jax.tree_util.tree_leaves(want)
            assert len(got_l) == len(want_l)
            for g, w in zip(got_l, want_l):
                leaf_close(g, w, tol)
    assert int(state.opt.count) == 2
    n = sum(x.size for x in jax.tree_util.tree_leaves(params_j))
    print(f"{arch}: {left_out} of 2 x {n} parameter elements left out, "
          f"{beyond} of them beyond 1e-6 (up to {worst:.3g} of the leaf's "
          f"largest parameter), whose reference gradients reach {g_far:.3g} "
          f"of the leaf's largest")


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_on_gnn_trees_matches_jax(arch):
    """``repro``'s own gradients through both AdamWs, twice: every leaf of
    the tree (0-d ``eps`` and ``delta`` included, which are decayed too)
    within 1e-6 of its largest magnitude, as ``tests/test_torch_train.py``
    holds AdamW."""
    fields = graph_fields(get_arch(arch).family, seed=8)
    cfg_j, cfg, params_j, params = models(arch, fields, seed=4)
    bj = batch_j(fields)
    grads_j = jax.jit(jax.grad(lambda p: gnn_j.gnn_loss(p, bj, cfg_j)))(
        params_j)
    oc_j = opt_j.AdamWConfig(warmup_steps=1, total_steps=3)
    update_j = jax.jit(lambda g, o, p: opt_j.adamw_update(oc_j, g, o, p))
    opt_jx, opt = opt_j.adamw_init(params_j), adamw_init(params)
    grads = interop.gnn_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, grads_j), cfg, device="cpu")
    for k in (1.0, -0.5):
        g_j = jax.tree_util.tree_map(lambda g: g * k, grads_j)
        params_j, opt_jx, _ = update_j(g_j, opt_jx, params_j)
        _, opt, _ = adamw_update(AdamWConfig(warmup_steps=1, total_steps=3),
                                 tree_map(lambda g: g * k, grads), opt,
                                 params)
    for got, want in ((params, params_j), (opt.mu, opt_jx.mu),
                      (opt.nu, opt_jx.nu)):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(t2n(g), w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()))


# --------------------------------------------------------------------------
# interop
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_params_round_trip_and_shape_checks(arch):
    fields = graph_fields(get_arch(arch).family)
    _, cfg, params_j, params = models(arch, fields)
    back = interop.gnn_params_to_numpy(params)
    for g, w in zip(tree_leaves(back), jax.tree_util.tree_leaves(params_j)):
        np.testing.assert_array_equal(g, np.asarray(w))
    bad = jax.tree_util.tree_map(np.asarray, params_j)
    if arch == "schnet":
        bad["out2"] = bad["out2"][:, :0]
        with pytest.raises(ValueError, match="shape"):
            interop.gnn_params_from_numpy(bad, cfg, device="cpu")
    else:
        bad["layers"] = bad["layers"][:-1]
        with pytest.raises(ValueError, match="nesting"):
            interop.gnn_params_from_numpy(bad, cfg, device="cpu")


def test_graph_batch_from_numpy_dtypes():
    bt = interop.graph_batch_from_numpy(graph_fields("gin", 4), "cpu")
    assert bt.edge_src.dtype == bt.graph_ids.dtype == torch.int64
    assert bt.x.dtype == torch.float32 and bt.labels.dtype == torch.int32
    assert bt.n_graphs == 4
    with pytest.raises(ValueError, match="GraphBatch fields"):
        interop.graph_batch_from_numpy({"x": np.zeros((2, 2))}, "cpu")


# --------------------------------------------------------------------------
# (e) the sampler and the partitioner
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fanout,seed", [([3, 2], 0), ([15, 10], 5),
                                         ([4], 9)])
def test_sampler_equals_jax(fanout, seed):
    gj = gen_j.random_weighted_graph(500, 2000, seed=1)
    gt = gen_t.random_weighted_graph(500, 2000, seed=1)
    np.testing.assert_array_equal(gt.indptr, gj.indptr)
    np.testing.assert_array_equal(gt.indices, gj.indices)
    seeds = np.arange(16, dtype=np.int32) * 7
    assert samp_t.plan_sizes(16, fanout) == samp_j.plan_sizes(16, fanout)
    got = samp_t.sample_subgraph(gt, seeds, fanout, seed=seed)
    want = samp_j.sample_subgraph(gj, seeds, fanout, seed=seed)
    for f in ("node_ids", "node_valid", "edge_src", "edge_dst", "edge_valid"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.seed_count == want.seed_count and got.n_sub == want.n_sub


def test_sampler_pads_a_node_with_no_neighbours():
    """A seed with no edges leaves its slots invalid, in both packages."""
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 40, 120), rng.integers(0, 40, 120)
    gj = struct_j.build_graph(src, dst, 50, w=np.ones(120, np.float32))
    gt = build_graph(src, dst, 50, w=np.ones(120, np.float32))
    seeds = np.array([45, 47, 0, 1], np.int32)       # 40.. have no edges
    got = samp_t.sample_subgraph(gt, seeds, [3, 2], seed=1)
    want = samp_j.sample_subgraph(gj, seeds, [3, 2], seed=1)
    assert not got.node_valid[4:10].any()
    for f in ("node_ids", "node_valid", "edge_src", "edge_dst", "edge_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("n,shards,seed", [(100, 4, 0), (101, 3, 7)])
def test_partition_equals_jax(n, shards, seed):
    gj = gen_j.random_weighted_graph(n, 3 * n, seed=seed)
    gt = gen_t.random_weighted_graph(n, 3 * n, seed=seed)
    pj, pt = (part_j.hash_partition(n, shards, seed=seed),
              part_t.hash_partition(n, shards, seed=seed))
    for f in ("perm", "inv_perm", "shard_of"):
        a, b = getattr(pt, f), getattr(pj, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert pt.n_shards == pj.n_shards
    np.testing.assert_array_equal(pt.relabel(np.arange(5)),
                                  pj.relabel(np.arange(5)))
    assert part_t.edge_cut(gt, pt) == part_j.edge_cut(gj, pj)
    at, aj = part_t.apply_partition(gt, pt), part_j.apply_partition(gj, pj)
    for f in ("src", "dst", "w", "indptr", "indices", "ew"):
        np.testing.assert_array_equal(getattr(at, f), getattr(aj, f))
    assert at.n_nodes == aj.n_nodes and at.labels == aj.labels


def test_partition_carries_labels():
    gj = gen_j.random_weighted_graph(30, 60, seed=3)
    gt = gen_t.random_weighted_graph(30, 60, seed=3)
    labels = [f"n{i}" for i in range(30)]
    gj = dataclasses.replace(gj, labels=labels)
    gt = dataclasses.replace(gt, labels=list(labels))
    pj, pt = part_j.hash_partition(30, 2), part_t.hash_partition(30, 2)
    assert (part_t.apply_partition(gt, pt).labels
            == part_j.apply_partition(gj, pj).labels)
