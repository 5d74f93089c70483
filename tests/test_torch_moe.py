"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE LMs against
``repro`` on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
expert weights come from ``repro``'s ``init_moe`` / ``init_params`` through
``interop``.  Tolerances: routing ids, capacity slots, the kept mask, the
dispatch buffers and ``dropped_frac`` exactly; the gates within 1e-6 (the
two frameworks' f32 ``exp`` differ by an ulp on the same logits, so the
softmax does); ``moe_ffn`` in f32 within 1e-5 (its products sum in another
order), in bf16 within 5e-2; the smoke models in f32 at
``test_torch_lm.py``'s 1e-4, with greedy tokens equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as get_arch_j
from repro.configs.base import MoESpec as MoESpecJ
from repro.models import lm as lm_j
from repro.models import moe as moe_j
from repro.models import transformer as tfm_j

from repro_torch import interop
from repro_torch.configs import MoESpec, get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import lm as lm_t
from repro_torch.models import moe as moe_t
from repro_torch.models import transformer as tfm_t

from test_torch_lm import close, jax_and_port_models

MOE_ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]


def specs(e, k, cf=1.25, f=16):
    return (MoESpecJ(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf),
            MoESpec(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf))


def router_inputs(seed, t, d, e):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32)
    return x, router


@pytest.mark.parametrize("n_tokens", [1, 4, 48, 1000, 8192])
@pytest.mark.parametrize("e,k", [(40, 8), (16, 4), (8, 2)])
def test_capacity_matches_jax(n_tokens, e, k):
    sj, st = specs(e, k)
    assert moe_t.capacity(n_tokens, st, e) == moe_j.capacity(n_tokens, sj, e)


# (experts, top-k, real experts, capacity factor): granite's and dbrx's
# routing, padded experts masked, and a factor of 0.25 that drops most
# assignments.
ROUTES = [(40, 8, 40, 1.25), (16, 4, 16, 1.25), (8, 2, 8, 1.25),
          (16, 4, 12, 1.25), (8, 2, 8, 0.25), (40, 8, 40, 0.25)]


@pytest.mark.parametrize("e,k,n_real,cf", ROUTES)
@pytest.mark.parametrize("seed", [0, 1])
def test_route_and_dispatch_match_jax(e, k, n_real, cf, seed):
    t, d = 96, 32
    x, router = router_inputs(seed, t, d, e)
    sj, st = specs(e, k, cf)
    gj, ij, pj, lj = moe_j._route(jnp.asarray(router), jnp.asarray(x), sj,
                                  n_real, e)
    gt, it, pt, lt = moe_t._route(torch.from_numpy(router),
                                  torch.from_numpy(x), st, n_real, e)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert int(it.max()) < n_real
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6,
                               rtol=1e-6)
    close(pt, pj, 1e-6)
    c = moe_j.capacity(t, sj, e)
    bj, slot_j, keep_j, tok_j = moe_j._dispatch_local(
        jnp.asarray(x), gj, ij, sj, e, c)
    bt, slot_t, keep_t, tok_t = moe_t._dispatch_local(
        torch.from_numpy(x), gt, it, st, e, c)
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    aj = moe_j._aux(pj, ij, lj, e, keep_j)
    at = moe_t._aux(pt, it, lt, e, keep_t)
    assert float(at["dropped_frac"]) == float(aj["dropped_frac"])
    if cf < 1:
        assert float(at["dropped_frac"]) > 0.5
    for name in ("load_balance", "router_z"):
        close(at[name], aj[name], 1e-5)


def moe_params(seed, d, spec_j, e, dtype):
    """``repro``'s ``init_moe`` weights as numpy and as the port's dict."""
    dj = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    pj = moe_j.init_moe(jax.random.PRNGKey(seed), d, spec_j, e, dj)
    pn = jax.tree_util.tree_map(np.asarray, pj)
    return pj, {name: interop._tensor(a) for name, a in pn.items()}


@pytest.mark.parametrize("e,k,cf", [(40, 8, 1.25), (16, 4, 1.25),
                                    (8, 2, 0.25)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
def test_moe_ffn_matches_jax(e, k, cf, dtype, tol):
    """The whole local path, [B, S, D] in and out, and its aux."""
    d = 32
    sj, st = specs(e, k, cf)
    pj, pt = moe_params(e + k, d, sj, e, dtype)
    assert pt["router"].dtype == torch.float32
    x = np.random.default_rng(e).normal(size=(3, 20, d)).astype(np.float32)
    dj, dt = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    yj, aj = moe_j.moe_ffn(pj, jnp.asarray(x, dj), sj, e)
    yt, at = moe_t.moe_ffn(pt, torch.from_numpy(x).to(dt), st, e)
    assert yt.dtype == dt and yt.shape == (3, 20, d)
    close(yt, yj, tol)
    assert float(at["dropped_frac"]) == float(aj["dropped_frac"])
    for name in ("load_balance", "router_z"):
        close(at[name], aj[name], 1e-5)


def test_init_moe_draws_repro_distribution():
    spec = MoESpec(n_experts=8, top_k=2, d_ff_expert=256)
    w = moe_t.init_moe(torch.Generator("cpu").manual_seed(0), 512, spec, 8,
                       torch.bfloat16)
    assert w["router"].dtype == torch.float32
    assert w["w_gate"].dtype == torch.bfloat16
    assert abs(w["router"].std().item() - 512 ** -0.5) < 2e-3
    assert abs(w["w_up"].float().std().item() - 512 ** -0.5) < 1e-3
    assert abs(w["w_down"].float().std().item() - 256 ** -0.5) < 1e-3
    assert {n: tuple(a.shape) for n, a in w.items()} == {
        "router": (512, 8), "w_gate": (8, 512, 256), "w_up": (8, 512, 256),
        "w_down": (8, 256, 512)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_lm_allocates_experts_not_a_dense_ffn(arch):
    cfg = get_arch(arch).smoke()
    model = tfm_t.init_lm(cfg, torch.Generator("cpu").manual_seed(0))
    names = {n.split(".", 2)[-1] for n, _ in model.named_parameters()
             if n.startswith("layers.")}
    assert {"moe.router", "moe.w_gate", "moe.w_up", "moe.w_down"} <= names
    assert not names & {"w_gate", "w_up", "w_down"}
    assert model.layers[0].moe.router.dtype == torch.float32
    assert model.layers[0].moe.w_up.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count_analytic()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_greedy_decode_match_jax(arch):
    """f32 smoke model: prefill through the flash path (``repro``'s Pallas
    kernel in interpret mode; the port's plain version), the forward's aux,
    then 8 greedy decode steps against the grown cache."""
    cfg, jb, params, model = jax_and_port_models(arch, "float32")
    assert model.layers[0].moe.router.dtype == torch.float32
    assert jb.e_pad == cfg.moe.n_experts
    prompt_len, steps, vocab = 24, 8, cfg.vocab
    tokens = np.random.default_rng(4).integers(0, vocab, (2, prompt_len))
    _, _, aux_j = tfm_j.forward(params, jnp.asarray(tokens, jnp.int32), jb,
                                attn_impl="naive")
    with torch.no_grad():
        _, _, aux_t = model(torch.from_numpy(tokens), attn_impl="naive")
    for name in ("load_balance", "router_z"):
        close(aux_t[name], aux_j[name], 1e-5)
    lj, cj = jax.jit(lm_j.make_prefill_step(jb, attn_impl="pallas"))(
        params, jnp.asarray(tokens, jnp.int32))
    launched = fa_ops.launches
    lt, ct = lm_t.make_prefill_step("cuda")(model, torch.from_numpy(tokens))
    assert fa_ops.launches == launched
    close(lt, lj, 1e-4)
    close(ct["k"], cj["k"], 1e-4)

    max_seq = prompt_len + steps
    pad = ((0, 0), (0, 0), (0, max_seq - prompt_len), (0, 0), (0, 0))
    cj = {"k": jnp.pad(cj["k"], pad), "v": jnp.pad(cj["v"], pad),
          "pos": cj["pos"]}
    ct = lm_t.grow_cache(model.cfg, ct, max_seq)
    dec_j = jax.jit(lm_j.make_decode_step(jb))
    dec_t = lm_t.make_decode_step()
    tok_j = jnp.argmax(lj[:, :vocab], axis=-1)[:, None].astype(jnp.int32)
    tok_t = lt[:, :vocab].argmax(dim=-1)[:, None]
    for step in range(steps):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j),
                                      err_msg=f"step {step}")
        tok_j, cj = dec_j(params, cj, tok_j)
        tok_t, ct = dec_t(model, ct, tok_t)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    close(ct["v"], cj["v"], 1e-4)


def test_dense_forward_aux_is_zero():
    cfg = get_arch("chatglm3-6b").smoke()
    model = tfm_t.init_lm(cfg, torch.Generator("cpu").manual_seed(0))
    with torch.no_grad():
        _, cache, aux = model(torch.zeros((1, 5), dtype=torch.long))
    assert cache is None
    assert float(aux["load_balance"]) == 0.0 == float(aux["router_z"])


def test_serve_moe_smoke_on_cpu(capsys):
    assert serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "12", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "granite-moe-3b-a800m on cpu" in out
    assert "generated 3 tokens per prompt" in out


@pytest.mark.parametrize("arch", ["dbrx-132b", "command-r-plus-104b"])
def test_serve_refuses_a_model_larger_than_the_card(monkeypatch, arch):
    """Full depth does not fit one card: the CLI says so before it
    allocates anything, and does not cut the model or fall back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (79 * 2**30, 80 * 2**30))
    with pytest.raises(RuntimeError, match="do not fit"):
        serve.main(["--arch", arch])
