"""The port's LM serving path (``repro_torch.models``, the flash-attention
wrapper, ``repro_torch.launch.serve``) against ``repro`` on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
weights come across with ``interop.lm_params_from_numpy``.  On the CPU the
flash wrapper runs its plain version; ``repro``'s Pallas kernel runs in
interpret mode.  Tolerances: f32 1e-4 for the whole model (sums in another
order through two layers and the head), 2e-5 / 2e-2 for the flash kernel
(``tests/test_kernels.py``'s), 5e-2 for bf16 (element-wise, as
``tests/test_kernel_integration.py`` holds bf16 hidden states).
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as get_arch_j
from repro.kernels.flash_attention import flash_attention as flash_j
from repro.kernels.flash_attention.ref import attention_ref as attention_ref_j
from repro.launch import serve as serve_j
from repro.models import attention as attn_j
from repro.models import lm as lm_j
from repro.models import transformer as tfm_j

from repro_torch import interop
from repro_torch.configs import GNNConfig, get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import attention as attn_t
from repro_torch.models import lm as lm_t
from repro_torch.models import transformer as tfm_t

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(arr, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of one dtype."""
    dj, dt = DTYPES[dtype]
    return (jnp.asarray(arr, dj),
            torch.from_numpy(np.asarray(arr, np.float32)).to(dt))


def close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("pct", [1.0, 0.5])
def test_rotary_matches_jax(pct):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.normal(size=(2, 12, 3, 16)))
    pos = np.arange(12)[None] + np.array([[0], [500]])
    close(attn_t.rotary(xt, torch.from_numpy(pos), pct),
          attn_j.rotary(xj, jnp.asarray(pos), pct), 1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_rms_norm_matches_jax(dtype, tol):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.normal(size=(2, 5, 64)), dtype)
    wj, wt = both(1 + 0.1 * rng.normal(size=64), dtype)
    got = tfm_t.rms_norm(xt, wt, 1e-5)
    assert got.dtype == xt.dtype
    close(got, tfm_j.rms_norm(xj, wj, 1e-5), tol)


@pytest.mark.parametrize("impl,tol", [("naive", 1e-5), ("chunked_f32", 1e-5),
                                      ("chunked", 2e-2)])
@pytest.mark.parametrize("sq,skv,q_offset", [(40, 40, 0), (3, 40, 30)])
def test_attention_impls_match_jax(impl, tol, sq, skv, q_offset):
    """GQA g=2, KV blocks of 16 (40 is not a multiple: the padding path)."""
    rng = np.random.default_rng(sq)
    qj, qt = both(rng.normal(size=(2, sq, 4, 16)))
    kj, kt = both(rng.normal(size=(2, skv, 2, 16)))
    vj, vt = both(rng.normal(size=(2, skv, 2, 16)))
    got = attn_t.attention(qt, kt, vt, impl=impl, q_offset=q_offset, block=16)
    want = attn_j.attention(qj, kj, vj, impl=impl, q_offset=q_offset,
                            block=16)
    close(got, want, tol)


def test_attention_rejects_unknown_impl():
    """``"pallas"`` is ``repro``'s name; the port's kernel is ``"cuda"``."""
    q = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError, match="not one of .*flash_jax"):
        attn_t.attention(q, q, q, impl="pallas")


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh", [
    (1, 128, 128, 4, 4, 64),
    (2, 256, 256, 4, 2, 64),      # GQA g=2
    (1, 128, 384, 8, 1, 128),     # MQA, longer kv
    (2, 100, 100, 4, 4, 64),      # non-multiple lengths
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_and_ref(b, sq, skv, hq, hkv, dh,
                                                dtype):
    rng = np.random.default_rng(b * sq)
    qj, qt = both(rng.normal(size=(b, sq, hq, dh)), dtype)
    kj, kt = both(rng.normal(size=(b, skv, hkv, dh)), dtype)
    vj, vt = both(rng.normal(size=(b, skv, hkv, dh)), dtype)
    launched = fa_ops.launches
    got = fa_ops.flash_attention(qt, kt, vt)
    assert fa_ops.launches == launched      # the CPU runs no kernel
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    close(got, flash_j(qj, kj, vj, causal=True, interpret=True), tol)
    close(got, attention_ref_j(qj, kj, vj, causal=True), tol)


def test_flash_attention_decode_offset():
    """q_offset masking: decoding position 37 of a 64-long cache."""
    rng = np.random.default_rng(5)
    qj, qt = both(rng.normal(size=(2, 8, 4, 64)))
    kj, kt = both(rng.normal(size=(2, 64, 4, 64)))
    vj, vt = both(rng.normal(size=(2, 64, 4, 64)))
    got = fa_ops.flash_attention(qt, kt, vt, q_offset=37)
    close(got, flash_j(qj, kj, vj, causal=True, q_offset=37, interpret=True),
          2e-5)
    close(got, attention_ref_j(qj, kj, vj, causal=True, q_offset=37), 2e-5)


@pytest.mark.parametrize("q_shape,kv_shape,dtypes,match", [
    ((1, 8, 4, 48), (1, 8, 2, 48), ("float32",) * 3, "head dims"),
    ((1, 8, 4, 16), (1, 8, 3, 16), ("float32",) * 3, "multiple of Hkv"),
    ((1, 8, 4, 16), (1, 8, 2, 16), ("float32", "bfloat16", "float32"),
     "all float32 or all"),
    ((1, 8, 4, 16), (1, 0, 2, 16), ("float32",) * 3, "Skv >= 1"),
])
def test_flash_attention_rejects_what_the_kernel_does_not_take(
        q_shape, kv_shape, dtypes, match):
    q = torch.zeros(q_shape, dtype=DTYPES[dtypes[0]][1])
    k = torch.zeros(kv_shape, dtype=DTYPES[dtypes[1]][1])
    v = torch.zeros(kv_shape, dtype=DTYPES[dtypes[2]][1])
    with pytest.raises(ValueError, match=match):
        fa_ops.flash_attention(q, k, v)


def jax_and_port_models(arch, dtype):
    """``repro``'s smoke LM with random norms and biases (so both are
    exercised), and the port's LM holding the same weights."""
    cfg_j = get_arch_j(arch).config.smoke().scaled(param_dtype=dtype)
    jb = tfm_j.build(cfg_j, tp=1)
    params_np = jax.tree_util.tree_map(
        np.asarray, tfm_j.init_params(jax.random.PRNGKey(0), jb))
    rng = np.random.default_rng(7)
    lay = params_np["layers"]
    for name in ("attn_norm", "ffn_norm", "bq", "bk", "bv"):
        if name in lay:
            base = 1.0 if name.endswith("norm") else 0.0
            lay[name] = (base + 0.1 * rng.normal(size=lay[name].shape)
                         ).astype(lay[name].dtype)
    params = jax.tree_util.tree_map(jnp.asarray, params_np)
    cfg = get_arch(arch).smoke().scaled(param_dtype=dtype)
    return cfg_j, jb, params, interop.lm_params_from_numpy(params_np, cfg,
                                                           device="cpu")


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen1.5-4b"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_prefill_and_greedy_decode_match_jax(arch, dtype, tol):
    """Prefill through the flash path (``repro``'s Pallas kernel in
    interpret mode; the port's plain version), then 8 greedy decode steps
    against the grown cache: logits, caches and tokens agree."""
    cfg, jb, params, model = jax_and_port_models(arch, dtype)
    # ``repro`` at tp=1 pads nothing, so the port's dims are the config's.
    assert (jb.n_heads_p, jb.n_kv_heads_p, jb.vocab_p) == (
        model.cfg.n_heads, model.cfg.n_kv_heads, model.cfg.vocab)
    prompt_len, steps, vocab = 24, 8, cfg.vocab
    tokens = np.random.default_rng(3).integers(0, vocab, (2, prompt_len))
    lj, cj = jax.jit(lm_j.make_prefill_step(jb, attn_impl="pallas"))(
        params, jnp.asarray(tokens, jnp.int32))
    launched = fa_ops.launches
    lt, ct = lm_t.make_prefill_step("cuda")(model, torch.from_numpy(tokens))
    assert fa_ops.launches == launched
    close(lt, lj, tol)
    close(ct["k"], cj["k"], tol)
    close(ct["v"], cj["v"], tol)
    assert ct["pos"] == int(cj["pos"]) == prompt_len

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
    assert ct["pos"] == int(cj["pos"]) == max_seq
    close(ct["k"], cj["k"], tol)
    close(ct["v"], cj["v"], tol)
    back = interop.cache_from_numpy(interop.cache_to_numpy(ct), device="cpu")
    assert torch.equal(back["k"], ct["k"].float()) and back["pos"] == max_seq


def test_lm_params_from_numpy_checks_the_tree():
    cfg, jb, params, _ = jax_and_port_models("chatglm3-6b", "float32")
    params_np = jax.tree_util.tree_map(np.asarray, params)
    params_np["layers"]["wq"] = params_np["layers"]["wq"][:1]
    with pytest.raises(ValueError, match="layers/wq has 1 layers"):
        interop.lm_params_from_numpy(params_np, get_arch("chatglm3-6b").smoke(),
                                     device="cpu")


@pytest.mark.parametrize("arch", ["gat-cora", "nope"])
def test_get_arch_raises_outside_the_ported_lms(arch):
    """A name outside the port raises ``KeyError`` naming what it has; a
    GNN arch is a ``GNNConfig`` now, and LM serving refuses it."""
    if arch == "nope":
        with pytest.raises(KeyError, match="gat-cora"):
            get_arch(arch)
        return
    assert isinstance(get_arch(arch), GNNConfig)
    with pytest.raises(SystemExit, match="LM archs"):
        serve.main(["--arch", arch, "--device", "cpu"])


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen1.5-4b",
                                  "command-r-plus-104b", "dbrx-132b",
                                  "granite-moe-3b-a800m"])
def test_configs_equal_jax(arch):
    got, want = get_arch(arch), get_arch_j(arch).config
    for g, w in ((got, want), (got.smoke(), want.smoke())):
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "qkv_bias", "rotary_pct", "rope_theta",
                  "norm_eps", "tie_embeddings", "param_dtype", "remat"):
            assert getattr(g, f) == getattr(w, f), f
        assert (g.moe is None) == (w.moe is None)
        if w.moe is not None:
            for f in ("n_experts", "top_k", "d_ff_expert", "capacity_factor",
                      "aux_loss_weight", "router_z_weight"):
                assert getattr(g.moe, f) == getattr(w.moe, f), f
        assert g.param_count_analytic() == w.param_count_analytic()


def test_init_lm_draws_repro_distribution():
    cfg = get_arch("chatglm3-6b").smoke().scaled(
        param_dtype="float32", d_model=256, d_ff=512)
    model = tfm_t.init_lm(cfg, torch.Generator("cpu").manual_seed(0))
    assert abs(model.embed.std().item() - 0.02) < 2e-3
    assert abs(model.layers[0].wq.std().item() - 256 ** -0.5) < 5e-3
    assert abs(model.layers[1].w_down.std().item() - 512 ** -0.5) < 5e-3
    assert torch.equal(model.layers[0].attn_norm, torch.ones(256))
    assert not any(p.requires_grad for p in model.parameters())


def test_serve_smoke_on_cpu(capsys):
    assert serve.main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen",
                       "4"]) == 0
    out = capsys.readouterr().out
    assert "prefill" in out and "decode" in out and "tokens/s" in out


def sample_row_lengths(out: str) -> list[int]:
    """Token counts of the sample rows a serve CLI prints (numpy or list
    rows, at most 16 tokens each)."""
    rows = out.split("sample generations (token ids):")[1].strip()
    return [len(line.strip(" []").replace(",", " ").split())
            for line in rows.splitlines()]


@pytest.mark.parametrize("n", [1, 3])
def test_serve_gen_n_returns_n_tokens_per_prompt(capsys, monkeypatch, n):
    """``--gen N`` gives N tokens per prompt (the prefill's, then N - 1
    decode steps), as ``repro``'s CLI does."""
    assert serve.main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen",
                       str(n)]) == 0
    out = capsys.readouterr().out
    assert f"generated {n} tokens per prompt" in out
    assert f"over {n - 1} steps" in out
    assert sample_row_lengths(out) == [n, n]
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "chatglm3-6b", "--smoke", "--batch", "2",
        "--prompt-len", "8", "--gen", str(n)])
    assert serve_j.main() == 0
    assert sample_row_lengths(capsys.readouterr().out) == [n, n]


def test_serve_without_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "chatglm3-6b", "--smoke"])
