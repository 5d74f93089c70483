"""The port's training path (``repro_torch.optim``, the training half of
``repro_torch.models.lm``, ``flash_jax``, ``dcn_loss``,
``repro_torch.launch.train``) against ``repro`` on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
LM weights and train states come across through ``interop``.  Tolerances,
each with its reason: AdamW 1e-6 relative to each leaf's largest
magnitude (the same f32 arithmetic; only the two frameworks' ``pow`` and
the global norm's sum order differ, by an ulp, and a moment summed from
gradients of opposite signs carries that ulp into a smaller value);
``chunked_ce`` and ``dcn_loss`` 1e-5 (f32 products summed in another
order); the smoke LMs' loss and gradients in f32 1e-4
(``test_torch_lm.py``'s bound for the whole model); ``flash_jax`` 1e-5
with f32 scores and 2e-2 with bf16 ones (a bf16 score rounds the other way
when the f32 sums before it differ in their last bit); router ids and
drops exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as get_arch_j
from repro.data import lm_synthetic_stream as lm_stream_j
from repro.models import attention as attn_j
from repro.models import lm as lm_j
from repro.models import moe as moe_j
from repro.models import recsys as rec_j
from repro.models import transformer as tfm_j
from repro.optim import optimizers as opt_j

from repro_torch import interop
from repro_torch.configs import DCN_V2, get_arch
from repro_torch.data import lm_synthetic_stream, recsys_synthetic_stream
from repro_torch.distributed.fault import StepGuard, UnreplayableStepError
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.launch import train
from repro_torch.models import attention as attn_t
from repro_torch.models import lm as lm_t
from repro_torch.models import moe as moe_t
from repro_torch.models import recsys as rec_t
from repro_torch.models import transformer as tfm_t
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, tree_leaves)

LM_ARCHS = ["chatglm3-6b", "granite-moe-3b-a800m"]


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def random_tree(seed):
    """A tree of f32 and bf16 leaves (numpy f32 values exact in bf16 where
    the leaf is bf16), with gradients for 3 steps."""
    rng = np.random.default_rng(seed)
    shapes = {"a": ((7, 5), "float32"), "b": ((33,), "bfloat16"),
              "c": ((4, 3, 2), "float32"), "d": ((16, 8), "bfloat16")}
    bf = lambda x: np.asarray(torch.from_numpy(x).bfloat16().float())
    params, grads = {}, [{} for _ in range(3)]
    for name, (shape, dtype) in shapes.items():
        p = rng.normal(size=shape).astype(np.float32)
        params[name] = (bf(p) if dtype == "bfloat16" else p, dtype)
        for g in grads:
            x = (rng.normal(size=shape) * 3).astype(np.float32)
            g[name] = bf(x) if dtype == "bfloat16" else x
    return params, grads


@pytest.mark.parametrize("cfg_kw", [
    {},                                                   # clips (norm > 1)
    {"max_grad_norm": 1e3, "warmup_steps": 2, "total_steps": 3},
])
def test_adamw_update_matches_jax(cfg_kw):
    params, grads = random_tree(0)
    dj = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    pj = {k: jnp.asarray(v, dj[d]) for k, (v, d) in params.items()}
    pt = {k: torch.from_numpy(v).to(dt[d]) for k, (v, d) in params.items()}
    cj, ct = opt_j.AdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    oj, ot = opt_j.adamw_init(pj), adamw_init(pt)
    assert all(m.dtype == torch.float32 for m in tree_leaves(ot.mu))
    for g in grads:
        gj = {k: jnp.asarray(v, pj[k].dtype) for k, v in g.items()}
        gt = {k: torch.from_numpy(v).to(pt[k].dtype) for k, v in g.items()}
        pj, oj, mj = opt_j.adamw_update(cj, gj, oj, pj)
        pt, ot, mt = adamw_update(ct, gt, ot, pt)
        assert int(ot.count) == int(oj.count) and ot.count.dtype == torch.int32
        for name in ("grad_norm", "lr"):
            assert mt[name].dtype == torch.float32
            np.testing.assert_allclose(t2n(mt[name]), np.asarray(mj[name]),
                                       rtol=1e-6)
        for k in pt:
            assert pt[k].dtype == dt[params[k][1]]
            for got, want in ((pt[k], pj[k]), (ot.mu[k], oj.mu[k]),
                              (ot.nu[k], oj.nu[k])):
                want = np.asarray(want, np.float32)
                np.testing.assert_allclose(
                    t2n(got), want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_cosine_schedule_matches_jax(step):
    """Warm-up (steps 1..9), the cosine (10..100) and past its end."""
    cj = opt_j.AdamWConfig(warmup_steps=10, total_steps=100)
    ct = AdamWConfig(warmup_steps=10, total_steps=100)
    got = cosine_schedule(ct, torch.tensor(step, dtype=torch.int32))
    want = opt_j.cosine_schedule(cj, jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------------------------
# the LM loss and train step
# --------------------------------------------------------------------------


def models(arch, seed=0):
    """``repro``'s f32 smoke LM (built at tp=1) and the port's LM with the
    same weights."""
    cfg_j = get_arch_j(arch).config.smoke().scaled(param_dtype="float32")
    jb = tfm_j.build(cfg_j, tp=1)
    params_np = jax.tree_util.tree_map(
        np.asarray, tfm_j.init_params(jax.random.PRNGKey(seed), jb))
    cfg = get_arch(arch).smoke().scaled(param_dtype="float32")
    return jb, params_np, cfg


def lm_batch(cfg, bsz=4, seq=16, seed=3):
    b = next(lm_synthetic_stream(cfg.vocab, bsz, seq, seed=seed))
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def test_chunked_ce_matches_jax():
    jb, params_np, cfg = models("chatglm3-6b")
    model = interop.lm_params_from_numpy(params_np, cfg, device="cpu")
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    for chunk in (16, 512):   # 16 does not divide 24: halved to 8
        want = jax.jit(lambda p, h, l: lm_j.chunked_ce(p, h, l, jb, chunk))(
            params, jnp.asarray(hidden), jnp.asarray(labels))
        got = lm_t.chunked_ce(model, torch.from_numpy(hidden),
                              torch.from_numpy(labels), chunk=chunk)
        close(t2n(got), want, 1e-5)
    assert lm_t.tfm_vocab_p(model) == lm_j.tfm_vocab_p(jb) == cfg.vocab


def repro_grads(jb, params_np, batch_j, attn_impl="naive"):
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: lm_j.lm_loss(p, batch_j, jb, attn_impl), has_aux=True))(params)
    return loss, aux, jax.tree_util.tree_leaves(grads)


def port_grad_leaves(model, grads: dict) -> list:
    """The port's {name: gradient} in ``repro``'s param-tree leaf order."""
    tree = lm_t._repro_tree(grads, model.cfg.n_layers)
    return [np.stack([t2n(p) for p in leaf.parts]) if hasattr(leaf, "parts")
            else t2n(leaf) for leaf in tree_leaves(tree)]


def repro_layer_routes(jb, params_np, tokens):
    """Each MoE layer's router ids and ``dropped_frac`` in ``repro``,
    layer by layer through ``_layer``."""
    cfg = jb.cfg
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    x = jnp.take(params["embed"], tokens, axis=0)
    bsz, s = tokens.shape
    pos = jnp.broadcast_to(jnp.arange(s)[None], (bsz, s))

    @jax.jit
    def layer(x, lw):
        h = tfm_j.rms_norm(x, lw["attn_norm"], cfg.norm_eps)
        attn, _ = tfm_j._attn_block(h, lw, jb, pos, attn_impl="naive")
        h2 = tfm_j.rms_norm(x + attn, lw["ffn_norm"], cfg.norm_eps)
        _, ids, _, _ = moe_j._route(lw["moe"]["router"],
                                    h2.reshape(bsz * s, -1), cfg.moe,
                                    cfg.moe.n_experts, jb.e_pad)
        x, _, aux = tfm_j._layer(x, lw, jb, pos, attn_impl="naive")
        return x, ids, aux["dropped_frac"]

    out = []
    for i in range(cfg.n_layers):
        x, ids, drop = layer(x, jax.tree_util.tree_map(lambda a: a[i],
                                                       params["layers"]))
        out.append((np.asarray(ids), float(drop)))
    return out


def port_layer_routes(model, tokens):
    cfg = model.cfg
    x = torch.nn.functional.embedding(tokens, model.embed)
    bsz, s = tokens.shape
    pos = torch.arange(s).expand(bsz, s)
    out = []
    with torch.no_grad():
        for layer in model.layers:
            h = tfm_t.rms_norm(x, layer.attn_norm, cfg.norm_eps)
            attn, _ = layer._attn(h, pos, None, 0, "naive")
            h2 = tfm_t.rms_norm(x + attn, layer.ffn_norm, cfg.norm_eps)
            _, ids, _, _ = moe_t._route(layer.moe.router,
                                        h2.reshape(bsz * s, -1), cfg.moe,
                                        cfg.moe.n_experts, cfg.moe.n_experts)
            x, _, aux = layer(x, pos, attn_impl="naive")
            out.append((ids.numpy(), float(aux["dropped_frac"])))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_loss_and_every_gradient_match_jax(arch):
    jb, params_np, cfg = models(arch)
    model = lm_t.init_train_state(
        interop.lm_params_from_numpy(params_np, cfg, device="cpu")).model
    batch_j, batch_t = lm_batch(cfg)
    loss_j, aux_j, grads_j = repro_grads(jb, params_np, batch_j)
    loss_t, grads_t, drops = lm_t.loss_and_grads(model, batch_t, "naive")
    close(t2n(loss_t), loss_j, 1e-4)
    with torch.no_grad():
        _, aux_t = lm_t.lm_loss(model, batch_t, "naive")
    for name in ("ce", "load_balance", "router_z"):
        close(t2n(aux_t[name]), aux_j[name], 1e-4)
    got = port_grad_leaves(model, grads_t)
    assert len(got) == len(grads_j)
    for g, w in zip(got, grads_j):
        assert g.shape == w.shape
        close(g, w, 1e-4)
    assert all(p.grad is None for p in model.parameters())
    if cfg.moe is None:
        assert drops is None
        return
    routes_j = repro_layer_routes(jb, params_np, batch_j["tokens"])
    routes_t = port_layer_routes(model, batch_t["tokens"])
    for (ids_t, drop_t), (ids_j, drop_j) in zip(routes_t, routes_j):
        np.testing.assert_array_equal(ids_t, ids_j)
        assert drop_t == drop_j
    assert drops.tolist() == [d for _, d in routes_j]


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax_over_two_steps(arch, grad_accum):
    jb, params_np, cfg = models(arch, seed=1)
    cj, ct = (opt_j.AdamWConfig(warmup_steps=1, total_steps=4),
              AdamWConfig(warmup_steps=1, total_steps=4))
    state_j = lm_j.init_train_state(jax.random.PRNGKey(1), jb)
    state = interop.train_state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(state_j)], cfg,
        device="cpu")
    step_j = jax.jit(lm_j.make_train_step(jb, cj, attn_impl="naive",
                                          grad_accum=grad_accum))
    step_t = lm_t.make_train_step(ct, attn_impl="naive",
                                  grad_accum=grad_accum)
    for seed in (5, 6):
        batch_j, batch_t = lm_batch(cfg, seed=seed)
        state_j, mj = step_j(state_j, batch_j)
        state, mt = step_t(state, batch_t)
        for name in ("loss", "grad_norm", "lr"):
            close(t2n(mt[name]), mj[name], 1e-4)
        assert mt["grad_s"] >= 0 and mt["update_s"] >= 0
        assert ("dropped_frac" in mt) == (cfg.moe is not None)
    assert state.step == int(state_j.step) == 2
    got = interop.train_state_to_numpy(state)
    want = [np.asarray(x, np.float32)
            for x in jax.tree_util.tree_leaves(state_j)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g, w, 1e-4)


def test_train_step_is_retry_safe():
    """A fault inside the backward of the first attempt: ``StepGuard``
    replays the step from the same state, and the result equals an
    undisturbed step's, bit for bit."""
    jb, params_np, cfg = models("granite-moe-3b-a800m", seed=2)
    states = [lm_t.init_train_state(
        interop.lm_params_from_numpy(params_np, cfg, device="cpu"))
        for _ in range(2)]
    _, batch = lm_batch(cfg, seed=9)
    step = lm_t.make_train_step(AdamWConfig(warmup_steps=1))
    faults = []

    def raise_once(grad):
        if not faults:
            faults.append(1)
            raise RuntimeError("simulated fault in the backward")
        return grad

    def arm(mod, args, out):
        if out[0].requires_grad:
            out[0].register_hook(raise_once)

    hook = states[0].model.layers[-1].register_forward_hook(arm)
    guard = StepGuard(max_retries=2)
    got, _, info = guard.run(step, states[0], batch)
    hook.remove()
    want, _ = step(states[1], batch)
    assert info["retries"] == 1 and faults == [1]
    assert guard.events[0][0] == "retry"
    assert got.step == want.step == 1
    for a, b in zip(interop.train_state_to_numpy(got),
                    interop.train_state_to_numpy(want)):
        np.testing.assert_array_equal(a, b)


def test_fault_inside_the_update_is_not_replayed():
    """Once ``adamw_update`` has written a leaf, a fault raises
    ``UnreplayableStepError`` and ``StepGuard`` raises it without a retry:
    a replay would update the written leaves a second time."""
    params = {"a": torch.ones(3), "b": torch.ones(4)}
    opt = adamw_init(params)
    opt.nu["b"] = torch.zeros(4, dtype=torch.int64)   # its update raises
    grads = {"a": torch.full((3,), 0.5), "b": torch.full((4,), 0.5)}
    guard = StepGuard(max_retries=2)
    with pytest.raises(UnreplayableStepError):
        guard.run(lambda st, g: adamw_update(AdamWConfig(), g, st,
                                             params)[1:], opt, grads)
    assert guard.events == []
    assert not torch.equal(params["a"], torch.ones(3))   # "a" was written
    assert torch.equal(params["b"], torch.ones(4))


# --------------------------------------------------------------------------
# flash_jax: the online softmax with a hand-written backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,sq,skv,hq,hkv,q_offset", [
    (2, 32, 32, 4, 4, 0),      # MHA
    (2, 32, 32, 4, 2, 0),      # GQA g=2
    (1, 40, 40, 6, 2, 0),      # GQA g=3, 40 keys: a ragged last block
    (2, 8, 40, 4, 2, 30),      # q_offset: 8 rows at positions 30..37
])
@pytest.mark.parametrize("score", ["float32", "bfloat16"])
def test_flash_jax_forward_and_backward_match_jax(b, sq, skv, hq, hkv,
                                                  q_offset, score):
    dh, block = 16, 16
    rng = np.random.default_rng(sq + skv + hq)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in (
        (b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh),
        (b, sq, hq, dh)))
    sj, st = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[score]
    fn = attn_j.make_flash_jax(True, q_offset, block, sj)
    out_j, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out_t = attn_t.flash_jax(qt, kt, vt, q_offset, block, st)
    dq_t, dk_t, dv_t = torch.autograd.grad(out_t, (qt, kt, vt),
                                           torch.from_numpy(do))
    tol = 1e-5 if score == "float32" else 2e-2
    for got, want in ((out_t, out_j), (dq_t, dq_j), (dk_t, dk_j),
                      (dv_t, dv_j)):
        close(t2n(got), want, tol)
    # Through the dispatch, and against naive attention's autodiff.
    out_d = attn_t.attention(qt, kt, vt, impl="flash_jax", q_offset=q_offset,
                             block=block)
    close(t2n(out_d), out_j, 2e-2)


def test_cuda_attention_under_grad_raises():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="flash_jax.*chunked"):
        attn_t.attention(q, k, k, impl="cuda")
    with torch.no_grad():
        assert attn_t.attention(q, k, k, impl="cuda").shape == q.shape


# --------------------------------------------------------------------------
# DCN-v2
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_dcn_loss_and_gradients_match_jax(impl):
    """``impl="cuda"`` on the CPU is the grouped lookup's plain version
    under :class:`GroupedLookup`'s backward; ``"torch"`` autograd through
    the per-field bags.  Ids past a table are clipped, as ``repro`` does."""
    cfg_j, cfg = get_arch_j("dcn-v2").config.smoke(), DCN_V2.smoke()
    params_j = rec_j.init_dcn(jax.random.PRNGKey(0), cfg_j)
    params_np = jax.tree_util.tree_map(np.asarray, params_j)
    params = interop.dcn_params_from_numpy(params_np, cfg, device="cpu")
    b = next(recsys_synthetic_stream(cfg, 64, seed=4))
    b["sparse"][:3, 0] = [-5, 10 ** 6, 99]          # clipped into the table
    batch_j = {k: jnp.asarray(v) for k, v in b.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in b.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: rec_j.dcn_loss(p, batch_j, cfg_j)))(params_j)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    launched = eb_ops.launches
    loss_t = rec_t.dcn_loss(params, batch_t, cfg, impl)
    grads_t = torch.autograd.grad(loss_t, leaves, allow_unused=True,
                                  materialize_grads=True)
    assert eb_ops.launches == launched          # the CPU runs no kernel
    close(t2n(loss_t), loss_j, 1e-5)
    want = jax.tree_util.tree_leaves(grads_j)
    assert len(want) == len(grads_t)
    for g, w in zip(grads_t, want):
        assert tuple(g.shape) == w.shape
        close(t2n(g), w, 1e-5)


def test_grouped_lookup_builds_a_graph_only_under_grad():
    """Serving (no table needs a gradient) calls the kernel alone; under
    grad the same x0 comes through ``GroupedLookup`` with its backward."""
    rng = np.random.default_rng(12)
    tables = [torch.from_numpy(rng.normal(size=(rows, 8)).astype(np.float32))
              for rows in (5, 9, 3)]
    ids = torch.from_numpy(np.stack([rng.integers(-2, r + 2, 16)
                                     for r in (5, 9, 3)], 1).astype(np.int32))
    dense = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    served = rec_t.grouped_lookup(tables, ids, prefix=dense)
    assert served.grad_fn is None
    for t in tables:
        t.requires_grad_(True)
    with torch.no_grad():
        assert rec_t.grouped_lookup(tables, ids, prefix=dense).grad_fn is None
    trained = rec_t.grouped_lookup(tables, ids, prefix=dense)
    assert type(trained.grad_fn).__name__ == "GroupedLookupBackward"
    assert torch.equal(trained.detach(), served)


def test_recsys_train_step_matches_jax_over_two_steps():
    cfg_j, cfg = get_arch_j("dcn-v2").config.smoke(), DCN_V2.smoke()
    params_j = rec_j.init_dcn(jax.random.PRNGKey(3), cfg_j)
    opt_jx = opt_j.adamw_init(params_j)
    params, opt = interop.dcn_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j),
        {"mu": jax.tree_util.tree_map(np.asarray, opt_jx.mu),
         "nu": jax.tree_util.tree_map(np.asarray, opt_jx.nu),
         "count": np.asarray(opt_jx.count)}, cfg, device="cpu")
    cj, ct = (opt_j.AdamWConfig(warmup_steps=1, total_steps=2),
              AdamWConfig(warmup_steps=1, total_steps=2))

    @jax.jit
    def step_j(carry, batch):
        p, o = carry
        loss, g = jax.value_and_grad(
            lambda q: rec_j.dcn_loss(q, batch, cfg_j))(p)
        p, o, m = opt_j.adamw_update(cj, g, o, p)
        return (p, o), {"loss": loss, **m}

    step_t = train.make_recsys_step(cfg, ct)
    carry_j, carry_t = (params_j, opt_jx), (params, opt)
    stream = recsys_synthetic_stream(cfg, 128, seed=8)
    for _ in range(2):
        b = next(stream)
        carry_j, mj = step_j(carry_j, {k: jnp.asarray(v) for k, v in b.items()})
        carry_t, mt = step_t(carry_t, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        for name in ("loss", "grad_norm", "lr"):
            close(t2n(mt[name]), mj[name], 1e-5)
    p_np, o_np = interop.dcn_state_to_numpy(*carry_t)
    assert int(o_np["count"]) == int(carry_j[1].count) == 2
    for got, want in ((p_np, carry_j[0]), (o_np["mu"], carry_j[1].mu),
                      (o_np["nu"], carry_j[1].nu)):
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            close(g, w, 1e-5)


# --------------------------------------------------------------------------
# launch/train.py, the training CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,batch", [("granite-moe-3b-a800m", 8),
                                        ("dcn-v2", 256)])
def test_train_cli_smoke_improves_on_cpu(capsys, arch, batch):
    rc = train.main(["--arch", arch, "--smoke", "--steps", "12", "--batch",
                     str(batch), "--device", "cpu", "--log-every", "4"])
    out = capsys.readouterr().out
    assert rc == 0 and "TRAINING IMPROVED" in out


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--arch", "chatglm3-6b", "--smoke", "--steps", "4", "--device",
            "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    train.main(args)
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_2", "step_4"]
    capsys.readouterr()
    train.main(args[:4] + ["6"] + args[5:])
    assert "resumed from step 4" in capsys.readouterr().out


def test_train_cli_refuses_gnn_archs():
    with pytest.raises(SystemExit, match="gnn_train"):
        train.main(["--arch", "gat-cora", "--smoke", "--device", "cpu"])


def test_train_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "dcn-v2", "--smoke", "--steps", "1"])


def test_lm_stream_equals_jax():
    for kw in ({}, {"skip": 3}, {"shard_id": 1, "n_shards": 2}):
        for a, b in zip(lm_stream_j(300, 3, 10, seed=2, **kw),
                        lm_synthetic_stream(300, 3, 10, seed=2, **kw)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
            break
