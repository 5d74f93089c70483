"""The port's tensor parallelism for the transformer (``build(cfg, tp)``'s
padding, ``param_specs``, the Megatron splits with sequence-parallel
norms, the vocabulary split over ``model``, the decode cache split on the
sequence, FSDP over ``data``) against ``repro``'s GSPMD on the CPU.

Ranks are processes over gloo (``run_ranks``), one 4-rank spawn for the
(data 1, model 4) and (data 2, model 2) meshes and one 2-rank spawn for
(data 1, model 2), run while ``repro``'s side runs once in
``tests.test_distributed.run_in_subprocess`` with 8 forced host devices,
its params placed by ``sharding_tree(mesh, param_specs(b))`` under the
same mesh.  Weights are drawn with numpy at the config's width and
zero-padded to the build's, written to one file both sides read.  The f32
smoke variants pad: 6 q heads over 2 KV heads at ``tp=4`` become 8 over 2
replicated (the group 3 -> 4), the vocabulary 250 -> 252, 6 experts -> 8;
qwen carries its QKV bias.

Tolerances (each times the largest magnitude of what is compared): prefill
logits (at a prompt that splits over ``model`` and one that does not) and
the real KV heads of the prefill cache 1e-5; 4 greedy decode steps'
tokens equal and logits 1e-5; the int8 cache: the quantization of a cache
split on the sequence equal, code for code and scale for scale, to that of
the whole cache by ``repro``'s ``quantize_kv``, the decode's logits within
5e-2 of ``repro``'s (bf16 dequantization, as
``tests/test_torch_kvcache.py``), the codes it writes exactly ``repro``'s
and its scales within 1e-6 (``repro``'s side runs with XLA's excess
precision off, so that its bf16 casts round where its program puts
them, as the port's do); two train
steps' losses 1e-5 and every parameter 1e-4 of its leaf.  The ranks are
also held against the port's one-process padded twin at the same
tolerances (a MoE twin with its capacity raised so that nothing drops: on
a mesh these token counts take ``_moe_dense_all``, which drops nothing).
"""

import concurrent.futures
import dataclasses as dc
import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_distributed import run_in_subprocess

from repro.configs import get_arch as get_arch_j
from repro.models import kvcache as kv_j
from repro.models import lm as lm_j
from repro.models import transformer as tfm_j

from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.distributed import comm
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import data_rows, default_tp, gather_lm, \
    shard_lm
from repro_torch.models import kvcache as kv_t
from repro_torch.models import lm as lm_t
from repro_torch.models import transformer as tfm_t
from repro_torch.optim import AdamWConfig

RANKS_TIMEOUT_S = 150
B, S, S_ODD, GEN = 4, 8, 7, 4           # batch, prompts, greedy decode steps
MQ, CHUNK, QGEN = 16, 4, 3              # the int8 cache and its steps
SP_SHAPE = (2, 2048)                    # the sharded MoE's prefill
# ``repro``'s own GPipe test's optimizer: its default warm-up keeps Adam's
# first steps small, where an element whose gradient is rounding noise
# would take a whole step (``tests/test_torch_multirank_models.py``).
OPT = {"lr": 3e-3}
ARCHS = ("chatglm3-6b", "qwen1.5-4b", "command-r-plus-104b", "dbrx-132b",
         "granite-moe-3b-a800m")

GLM = ("chatglm3-6b", {"n_heads": 6, "n_kv_heads": 2, "vocab": 250}, None)
QWEN = ("qwen1.5-4b", {"vocab": 250}, None)
MOE = ("granite-moe-3b-a800m", {"vocab": 250}, {"n_experts": 6})
# name: (arch, config overrides, MoE overrides, tp, mesh (data, model))
CASES = {"glm_1x4": (*GLM, 4, (1, 4)), "glm_2x2": (*GLM, 2, (2, 2)),
         "qwen_1x2": (*QWEN, 2, (1, 2)), "moe_1x4": (*MOE, 4, (1, 4)),
         "moe_2x2": (*MOE, 2, (2, 2))}
SP_CASE = (*MOE, 2, (1, 2))             # prefill only, at SP_SHAPE


def port_cfg(case, no_drop=False):
    arch, over, moe_over, _, _ = case
    cfg = get_arch(arch).smoke().scaled(param_dtype="float32", **over)
    if moe_over:
        moe = dc.replace(cfg.moe, **moe_over)
        if no_drop:
            moe = dc.replace(moe, capacity_factor=moe.n_experts / moe.top_k)
        cfg = cfg.scaled(moe=moe)
    return cfg


def lm_tree(b, seed):
    """A ``repro`` param tree at the build's padded shapes, numpy f32: each
    leaf drawn at the config's width, then zero-padded (norms around 1,
    biases and the router drawn too)."""
    cfg = b.cfg
    rng = np.random.default_rng(seed)
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.head_dim

    def leaf(real, padded, scale):
        out = np.zeros(padded, np.float32)
        out[tuple(slice(0, n) for n in real)] = rng.normal(size=real) * scale
        return out

    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    hq_p, hkv_p = b.n_heads_p * dh, b.n_kv_heads_p * dh
    layers = {"attn_norm": 1 + leaf((L, d), (L, d), 0.1),
              "ffn_norm": 1 + leaf((L, d), (L, d), 0.1),
              "wq": leaf((L, d, hq), (L, d, hq_p), d ** -0.5),
              "wk": leaf((L, d, hkv), (L, d, hkv_p), d ** -0.5),
              "wv": leaf((L, d, hkv), (L, d, hkv_p), d ** -0.5),
              "wo": leaf((L, hq, d), (L, hq_p, d), hq ** -0.5)}
    if cfg.qkv_bias:
        layers.update(bq=leaf((L, hq), (L, hq_p), 0.1),
                      bk=leaf((L, hkv), (L, hkv_p), 0.1),
                      bv=leaf((L, hkv), (L, hkv_p), 0.1))
    if cfg.moe is not None:
        e, f, ep = cfg.moe.n_experts, cfg.moe.d_ff_expert, b.e_pad
        layers["moe"] = {
            "router": leaf((L, d, e), (L, d, ep), 0.5),
            "w_gate": leaf((L, e, d, f), (L, ep, d, f), d ** -0.5),
            "w_up": leaf((L, e, d, f), (L, ep, d, f), d ** -0.5),
            "w_down": leaf((L, e, f, d), (L, ep, f, d), f ** -0.5)}
    else:
        layers.update(w_gate=leaf((L, d, cfg.d_ff), (L, d, cfg.d_ff),
                                  d ** -0.5),
                      w_up=leaf((L, d, cfg.d_ff), (L, d, cfg.d_ff), d ** -0.5),
                      w_down=leaf((L, cfg.d_ff, d), (L, cfg.d_ff, d),
                                  cfg.d_ff ** -0.5))
    tree = {"embed": leaf((cfg.vocab, d), (b.vocab_p, d), 0.5),
            "final_norm": 1 + leaf((d,), (d,), 0.1), "layers": layers}
    if not cfg.tie_embeddings:
        tree["head"] = leaf((d, cfg.vocab), (d, b.vocab_p), d ** -0.5)
    return tree


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def write_case(path, case, seed, shape=(B, S)):
    """The case's weights and prompts, written for both sides."""
    b = tfm_t.build(port_cfg(case), case[3])
    rng = np.random.default_rng(seed + 100)
    toks = {"tokens": rng.integers(0, b.cfg.vocab, shape),
            "tokens_odd": rng.integers(0, b.cfg.vocab, (shape[0], S_ODD))}
    np.savez(path, **flatten(lm_tree(b, seed)),
             **{f"__{k}": v for k, v in toks.items()})
    return str(path)


def read_case(path):
    data = np.load(path)
    tree = unflatten({k: data[k] for k in data.files
                      if not k.startswith("__")})
    return tree, {k[2:]: data[k] for k in data.files if k.startswith("__")}


# -- repro's side -----------------------------------------------------------

REPRO = """
    # XLA's CPU backend may keep a fused bf16 product in f32 ("excess
    # precision"); off, every cast rounds where ``repro``'s program puts
    # it, as the port's do.  Read when the first backend starts, below.
    os.environ["XLA_FLAGS"] += " --xla_allow_excess_precision=false"
    from repro import shardmap
    from repro.configs import get_arch
    from repro.launch.mesh import sharding_tree
    from repro.models import kvcache as kv
    from repro.models import lm as lm_lib
    from repro.models import transformer as tfm
    from repro.optim import AdamWConfig, OptState, adamw_init
    from jax.sharding import PartitionSpec as P
    import dataclasses as dc

    f32 = lambda a: np.asarray(a, np.float32).tolist()

    def cfg_of(case):
        arch, over, moe_over, _, _ = case
        cfg = dc.replace(get_arch(arch).config.smoke(),
                         param_dtype="float32", **over)
        if moe_over:
            cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, **moe_over))
        return cfg

    def run(case, path, full):
        b = tfm.build(cfg_of(case), case[3])
        tree, toks = read_case(path)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        tokens = jnp.asarray(toks["tokens"], jnp.int32)
        vocab = b.cfg.vocab
        mesh = shardmap.make_mesh(tuple(case[4]), ("data", "model"))
        out = {}
        with shardmap.mesh_scope(mesh):
            specs = tfm.param_specs(b)
            pp = jax.device_put(params, sharding_tree(mesh, specs))
            prefill = jax.jit(lm_lib.make_prefill_step(b, attn_impl="naive"))
            logits, cache = prefill(pp, tokens)
            out["prefill"] = f32(logits)
            if not full:
                return out
            out["prefill_odd"] = f32(prefill(
                pp, jnp.asarray(toks["tokens_odd"], jnp.int32))[0])
            out["cache"] = [f32(cache["k"]), f32(cache["v"])]
            # Padded on the host: the prefill's output sharding need not
            # divide the grown shape.
            pad = ((0, 0), (0, 0), (0, GEN), (0, 0), (0, 0))
            c = {n: jnp.asarray(np.pad(np.asarray(cache[n]), pad))
                 for n in ("k", "v")}
            c["pos"] = cache["pos"]
            dec = jax.jit(lambda p, c, t: tfm.decode_step(p, c, t, b))
            tok = jnp.argmax(logits[:, :vocab], -1)[:, None].astype(jnp.int32)
            logs, fed = [], []
            for _ in range(GEN):
                lg, c = dec(pp, c, tok)
                logs.append(lg[:, -1])
                tok = jnp.argmax(lg[:, -1, :vocab], -1)[:, None].astype(
                    jnp.int32)
                fed.append(tok)
            out["decode"] = [f32(jnp.stack(logs)),
                             np.asarray(jnp.concatenate(fed, 1)).tolist()]
            cq = kv.init_cache_quant(b, tokens.shape[0], MQ)
            stepq = jax.jit(lambda p, c, t: tfm.decode_step_quant(
                p, c, t, b, chunk=CHUNK))
            for t in range(tokens.shape[1]):
                _, cq = stepq(pp, cq, tokens[:, t:t + 1])
            tok = fed[0]
            logs = []
            for _ in range(QGEN):
                lg, cq = stepq(pp, cq, tok)
                logs.append(lg[:, -1])
                tok = jnp.argmax(lg[:, -1, :vocab], -1)[:, None].astype(
                    jnp.int32)
            out["quant"] = [f32(jnp.stack(logs)),
                            {n: f32(cq[n]) for n in ("k_q", "k_s", "v_q",
                                                     "v_s")}]
            state = lm_lib.TrainState(params=pp, opt=adamw_init(pp),
                                      step=jnp.zeros((), jnp.int32))
            st_spec = lm_lib.TrainState(
                params=specs, opt=OptState(mu=specs, nu=specs, count=P()),
                step=P())
            state = jax.device_put(state, sharding_tree(mesh, st_spec))
            step = jax.jit(lm_lib.make_train_step(
                b, AdamWConfig(**OPT), attn_impl="naive"))
            batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, 1)}
            losses = []
            for _ in range(2):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            out["train"] = [losses, jax.tree_util.tree_map(f32, state.params)]
        return out

    out = {name: run(CASES[name], path, name != "sp")
           for name, path in PATHS.items()}
"""


# -- the ranks' side ----------------------------------------------------------

def _whole_heads(t, b, mesh):
    """A prefill cache [L, B, S, H, Dh] of this rank's KV heads -> every
    KV head."""
    if t.shape[3] < b.n_kv_heads_p:
        t = comm.all_gather(t, "model", dim=3, tiled=True, mesh=mesh)
    return t


def _rank_case(case, path, full):
    mesh = comm.Mesh(case[4], ("data", "model"), "cpu")
    b = tfm_t.build(port_cfg(case), case[3])
    tree, toks = read_case(path)
    model = shard_lm(interop.lm_params_from_numpy(tree, b, device="cpu"),
                     mesh)
    tokens = data_rows(torch.from_numpy(toks["tokens"]), mesh)
    prefill = lm_t.make_prefill_step("naive")
    logits, cache = prefill(model, tokens)
    out = {"prefill": logits.numpy()}
    if not full:
        return out
    out["prefill_odd"] = prefill(model, data_rows(torch.from_numpy(
        toks["tokens_odd"]), mesh))[0].numpy()
    with torch.no_grad():
        out["cache"] = [_whole_heads(cache[n], b, mesh).numpy()
                        for n in ("k", "v")]
        # The int8 cache of this prefill, this rank's positions, gathered.
        cq = lm_t.quantize_cache(b, cache, MQ, mesh)
        out["quantized"] = {n: comm.all_gather(cq[n], "model", dim=2,
                                               tiled=True, mesh=mesh).numpy()
                            for n in ("k_q", "k_s", "v_q", "v_s")}
        c = lm_t.grow_cache(b, cache, S + GEN, mesh)
        tok = logits[:, :b.cfg.vocab].argmax(-1)[:, None]
        logs, fed = [], []
        for _ in range(GEN):
            lg, c = model.decode_step(c, tok)
            logs.append(lm_t.gather_vocab(model, lg[:, -1]))
            tok = lm_t.greedy_token(model, lg[:, -1])[:, None]
            fed.append(tok)
        out["decode"] = [torch.stack(logs).numpy(), torch.cat(fed, 1).numpy()]
        cq = kv_t.init_cache_quant(b, B, MQ, device="cpu", mesh=mesh)
        for t in range(tokens.shape[1]):
            _, cq = model.decode_step_quant(cq, tokens[:, t:t + 1],
                                            chunk=CHUNK)
        tok, logs = fed[0], []
        for _ in range(QGEN):
            lg, cq = model.decode_step_quant(cq, tok, chunk=CHUNK)
            logs.append(lm_t.gather_vocab(model, lg[:, -1]))
            tok = lm_t.greedy_token(model, lg[:, -1])[:, None]
        out["quant"] = [torch.stack(logs).numpy(), {
            n: comm.all_gather(cq[n], "model", dim=2, tiled=True,
                               mesh=mesh).numpy()
            for n in ("k_q", "k_s", "v_q", "v_s")}]
    state = lm_t.init_train_state(model)
    step = lm_t.make_train_step(AdamWConfig(**OPT), attn_impl="naive")
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out["train"] = [losses, {k: v.numpy()
                             for k, v in gather_lm(model).items()}]
    out["issued"] = dict(comm.issued)
    return out


def _tp_ranks(device, paths):
    return {name: _rank_case(CASES.get(name, SP_CASE), path, name != "sp")
            for name, path in paths.items()}


# -- the one-process padded twin ---------------------------------------------

def twin_run(case, path):
    """The case on the port's one-process padded twin (no mesh)."""
    b = tfm_t.build(port_cfg(case, no_drop=True), case[3])
    tree, toks = read_case(path)
    model = interop.lm_params_from_numpy(tree, b, device="cpu")
    tokens = torch.from_numpy(toks["tokens"])
    logits, cache = lm_t.make_prefill_step("naive")(model, tokens)
    c = lm_t.grow_cache(b, cache, S + GEN)
    dec = lm_t.make_decode_step()
    tok = logits[:, :b.cfg.vocab].argmax(-1)[:, None]
    logs, fed = [], []
    with torch.no_grad():
        for _ in range(GEN):
            lg, c = model.decode_step(c, tok)
            logs.append(lg[:, -1])
            tok = lm_t.greedy_token(model, lg[:, -1])[:, None]
            fed.append(tok)
    # make_decode_step's greedy pick from a fresh cache: the same tokens.
    c = lm_t.grow_cache(b, lm_t.make_prefill_step("naive")(model, tokens)[1],
                        S + GEN)
    tok, again = logits[:, :b.cfg.vocab].argmax(-1)[:, None], []
    for _ in range(GEN):
        tok, c = dec(model, c, tok)
        again.append(tok)
    state = lm_t.init_train_state(model)
    step = lm_t.make_train_step(AdamWConfig(**OPT), attn_impl="naive")
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return {"prefill": logits.numpy(),
            "decode": [torch.stack(logs).numpy(), torch.cat(fed, 1).numpy(),
                       torch.cat(again, 1).numpy()],
            "train": [losses, {k: p.detach().numpy()
                               for k, p in model.named_parameters()}]}


# -- fixture -----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    paths = {name: write_case(tmp / f"{name}.npz", case, seed)
             for seed, (name, case) in enumerate(CASES.items())}
    paths["sp"] = write_case(tmp / "sp.npz", SP_CASE, 9, SP_SHAPE)
    consts = "".join(f"{n} = {globals()[n]!r}\n" for n in (
        "GEN", "MQ", "CHUNK", "QGEN", "OPT")) + \
        f"CASES = {({**CASES, 'sp': SP_CASE})!r}\nPATHS = {paths!r}\n"
    body = consts + "".join(textwrap.dedent(inspect.getsource(f)) for f in (
        flatten, unflatten, read_case)) + textwrap.dedent(REPRO)
    four = [n for n, c in CASES.items() if c[4][0] * c[4][1] == 4]
    two = [n for n in paths if n not in four]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_in_subprocess, body)
        ranks = {}
        for world, names in ((4, four), (2, two)):
            outs = run_ranks(_tp_ranks, world, {n: paths[n] for n in names},
                             timeout_s=RANKS_TIMEOUT_S,
                             workdir=tmp_path_factory.mktemp(f"w{world}"))
            for name in names:
                ranks[name] = [o[name] for o in outs]
        ref = ref.result()
    return ref, ranks, paths


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def rows(case, outs, get, axis=0):
    """The data ranks' rows of ``get(out)``, in order, after checking that
    the ranks of each ``model`` group agree exactly."""
    data, model = case[4]
    parts = []
    for f in range(data):
        group = [get(outs[f * model + j]) for j in range(model)]
        for g in group[1:]:
            np.testing.assert_array_equal(g, group[0])
        parts.append(group[0])
    return np.concatenate(parts, axis)


NAMES = list(CASES)


@pytest.mark.parametrize("name", NAMES)
def test_tp_prefill_logits_match_repro(runs, name):
    ref, ranks, _ = runs
    case = CASES[name]
    for key in ("prefill", "prefill_odd"):
        close(rows(case, ranks[name], lambda o: o[key]), ref[name][key],
              1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_tp_prefill_cache_real_heads_match_repro(runs, name):
    ref, ranks, _ = runs
    case = CASES[name]
    n_kv = port_cfg(case).n_kv_heads
    for i in range(2):
        got = rows(case, ranks[name], lambda o: o["cache"][i], axis=1)
        close(got[..., :n_kv, :], np.asarray(ref[name]["cache"][i])
              [..., :n_kv, :], 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_tp_greedy_decode_matches_repro(runs, name):
    ref, ranks, _ = runs
    case = CASES[name]
    logits = rows(case, ranks[name], lambda o: o["decode"][0], axis=1)
    tokens = rows(case, ranks[name], lambda o: o["decode"][1])
    np.testing.assert_array_equal(tokens, ref[name]["decode"][1])
    close(logits, ref[name]["decode"][0], 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_tp_int8_decode_matches_repro(runs, name):
    """The prompt warmed into an int8 cache split on the sequence, one
    token a step, then greedy steps: logits within 5e-2 of ``repro``'s;
    every layer's codes exactly ``repro``'s and its scales within 1e-6 of
    the largest.  Each rank's online softmax starts from the ranks before
    it's largest score, so every chunk's P rounds to bf16 as ``repro``'s
    one loop rounds it; what is left is f32 summation order (the K/V
    projections and the merge), which moves a scale by an ulp."""
    ref, ranks, _ = runs
    case = CASES[name]
    close(rows(case, ranks[name], lambda o: o["quant"][0], axis=1),
          ref[name]["quant"][0], 5e-2)
    for n in ("k_q", "v_q"):
        got = rows(case, ranks[name], lambda o: o["quant"][1][n], axis=1)
        np.testing.assert_array_equal(got, np.asarray(ref[name]["quant"][1]
                                                      [n]), n)
    for n in ("k_s", "v_s"):
        got = rows(case, ranks[name], lambda o: o["quant"][1][n], axis=1)
        close(got, ref[name]["quant"][1][n], 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_tp_int8_quantization_is_exact_across_ranks(runs, name):
    """Quantization is per position: a prefill cache split on the sequence
    over ``model`` quantizes to exactly the codes and scales that
    ``repro``'s ``quantize_kv`` gives the whole cache, and positions past
    the prompt stay zero."""
    _, ranks, _ = runs
    case = CASES[name]
    for src in ("k", "v"):
        whole = rows(case, ranks[name], lambda o: o["cache"]["kv".index(src)],
                     axis=1)
        codes, scales = (np.asarray(a) for a in
                         kv_j.quantize_kv(jnp.asarray(whole)))
        got_q = rows(case, ranks[name], lambda o: o["quantized"][f"{src}_q"],
                     axis=1)
        got_s = rows(case, ranks[name], lambda o: o["quantized"][f"{src}_s"],
                     axis=1)
        np.testing.assert_array_equal(got_q[:, :, :S], codes)
        np.testing.assert_array_equal(got_s[:, :, :S], scales)
        assert not got_q[:, :, S:].any() and not got_s[:, :, S:].any()


def _leaves(name, params):
    """``repro``'s stacked tree against the port's named parameters."""
    out = []
    for key, want in flatten(params).items():
        key = key.replace("/", ".")
        if key.startswith("layers."):
            sub = key[len("layers."):]
            out.append((key, np.stack([name[f"layers.{i}.{sub}"]
                                       for i in range(len(want))]), want))
        else:
            out.append((key, name[key], want))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_tp_two_train_steps_match_repro(runs, name):
    ref, ranks, _ = runs
    losses, params = ref[name]["train"]
    for out in ranks[name]:
        np.testing.assert_allclose(out["train"][0], losses, rtol=1e-5)
    got = ranks[name][0]["train"][1]
    for out in ranks[name][1:]:
        for k in got:
            np.testing.assert_array_equal(out["train"][1][k], got[k])
    for key, g, w in _leaves(got, params):
        close(g, w, 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_tp_ranks_match_the_one_process_padded_twin(runs, name):
    _, ranks, paths = runs
    case = CASES[name]
    twin = twin_run(case, paths[name])
    close(rows(case, ranks[name], lambda o: o["prefill"]), twin["prefill"],
          1e-5)
    close(rows(case, ranks[name], lambda o: o["decode"][0], axis=1),
          twin["decode"][0], 1e-5)
    tokens = rows(case, ranks[name], lambda o: o["decode"][1])
    np.testing.assert_array_equal(tokens, twin["decode"][1])
    np.testing.assert_array_equal(twin["decode"][2], twin["decode"][1])
    np.testing.assert_allclose(ranks[name][0]["train"][0],
                               twin["train"][0], rtol=1e-5)
    for k, w in twin["train"][1].items():
        close(ranks[name][0]["train"][1][k], w, 1e-4)
    # Sequence parallelism moved the residual through reduce-scatters and
    # the FSDP weights through all-gathers.
    issued = ranks[name][0]["issued"]
    assert issued.get("reduce_scatter", 0) > 0 and issued["all_gather"] > 0


def test_tp_sharded_moe_prefill_matches_repro(runs):
    """granite's variant at (data 1, model 2) on 2 x 2048 tokens: the
    residual split on the sequence feeds ``_moe_sharded`` its block
    directly (experts over ``model``, the all_to_all both ways)."""
    ref, ranks, _ = runs
    close(rows(SP_CASE, ranks["sp"], lambda o: o["prefill"]),
          ref["sp"]["prefill"], 1e-5)


# -- in one process: the padding rule and its consequences -------------------

@pytest.mark.parametrize("tp", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_pads_as_repro(arch, tp):
    got = tfm_t.build(get_arch(arch), tp)
    want = tfm_j.build(get_arch_j(arch).config, tp)
    for f in ("tp", "n_heads_p", "n_kv_heads_p", "vocab_p", "e_pad"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.kv_sharded == want.kv_sharded


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_repro(arch, tp):
    got = tfm_t.param_specs(tfm_t.build(get_arch(arch), tp))
    want = tfm_j.param_specs(tfm_j.build(get_arch_j(arch).config, tp))
    # JAX writes a one-axis entry ("model",) as "model".
    one = lambda e: e[0] if isinstance(e, tuple) and len(e) == 1 else e
    flat_w = {k: tuple(map(one, v)) for k, v in flatten(
        jax.tree_util.tree_map(tuple, want, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))).items()}
    flat_g = {k: tuple(map(one, v)) for k, v in flatten(got).items()}
    assert flat_g == flat_w


@pytest.mark.parametrize("arch,tp", [("chatglm3-6b", 4),
                                     ("granite-moe-3b-a800m", 16),
                                     ("qwen1.5-4b", 16)])
def test_init_lm_real_part_equals_the_tp1_draw(arch, tp):
    cfg = get_arch(arch).smoke().scaled(n_heads=6, vocab=250) \
        if arch != "granite-moe-3b-a800m" else \
        get_arch(arch).smoke().scaled(vocab=250)
    one = tfm_t.init_lm(cfg, torch.Generator().manual_seed(3))
    b = tfm_t.build(cfg, tp)
    padded = tfm_t.init_lm(b, torch.Generator().manual_seed(3))
    assert b.n_heads_p > cfg.n_heads or b.vocab_p > cfg.vocab
    one_p = dict(one.named_parameters())
    for name, p in padded.named_parameters():
        real = one_p[name]
        part = p[tuple(slice(0, n) for n in real.shape)]
        assert torch.equal(part, real), name
        rest = p.clone()
        rest[tuple(slice(0, n) for n in real.shape)] = 0
        assert not rest.any(), name


def granite_tp16():
    """granite's smoke config (4 q heads over 2 KV heads) at ``tp=16``:
    16 q heads over 2 replicated KV heads, the group 2 -> 8; weights drawn
    by ``repro`` at that build."""
    cfg_j = dc.replace(get_arch_j("granite-moe-3b-a800m").config.smoke(),
                       param_dtype="float32")
    b_j = tfm_j.build(cfg_j, 16)
    params = tfm_j.init_params(jax.random.PRNGKey(0), b_j)
    cfg = get_arch("granite-moe-3b-a800m").smoke().scaled(
        param_dtype="float32")
    b = tfm_t.build(cfg, 16)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return b_j, params, b, tree


def test_granite_tp16_padding_regroups_and_matches_repro():
    """The port's one-process forward at ``tp=16`` equals ``repro``'s
    ``build(cfg, 16)`` forward on the same weights, and differs from the
    ``tp=1`` model on their real part: in a group of 8, real q heads 2
    and 3 read KV head 0 where at ``tp=1`` they read KV head 1."""
    b_j, params, b, tree = granite_tp16()
    assert (b.n_heads_p, b.n_kv_heads_p, b.vocab_p, b.e_pad) == (16, 2, 256,
                                                                 16)
    assert b.n_heads_p // b.n_kv_heads_p == 8 and not b.kv_sharded
    toks = np.random.default_rng(4).integers(0, 256, (2, 12))
    want, _, _ = tfm_j.forward(params, jnp.asarray(toks, jnp.int32), b_j,
                               attn_impl="naive")
    model = interop.lm_params_from_numpy(tree, b, device="cpu")
    with torch.no_grad():
        got, _, _ = model(torch.from_numpy(toks), attn_impl="naive")
    close(got.numpy(), want, 1e-5)
    # The tp=1 model on the real part of the same weights.
    cfg = b.cfg
    one = tfm_t.LM(cfg, device="cpu", dtype=torch.float32)
    real = {}
    for k, p in model.named_parameters():
        shape = dict(one.named_parameters())[k].shape
        real[k] = p.detach()[tuple(slice(0, n) for n in shape)]
    one.load_state_dict(real)
    with torch.no_grad():
        tp1, _, _ = one(torch.from_numpy(toks), attn_impl="naive")
    assert np.abs(tp1.numpy() - got.numpy()).max() > 1e-2


def test_serve_tp_flag_generates_as_repro_at_that_build():
    """``launch/serve.py``'s path at ``--tp 16`` (the one-process padded
    model, the greedy pick over the real vocabulary) on ``repro``'s
    weights gives ``repro``'s CLI's tokens at ``tp=16``; the CLI takes
    ``--tp`` with ``repro``'s default (1 under ``--smoke``, else 16)."""
    b_j, params, b, tree = granite_tp16()
    toks = np.random.default_rng(5).integers(0, 256, (2, 8))
    prefill = jax.jit(lm_j.make_prefill_step(b_j, attn_impl="naive"))
    decode = jax.jit(lm_j.make_decode_step(b_j, attn_impl="naive"))
    logits, cache = prefill(params, jnp.asarray(toks, jnp.int32))
    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    cache = {"k": jnp.pad(cache["k"], pad), "v": jnp.pad(cache["v"], pad),
             "pos": cache["pos"]}
    tok = jnp.argmax(logits[:, :b.cfg.vocab], -1)[:, None].astype(jnp.int32)
    want = [tok]
    for _ in range(4):
        tok, cache = decode(params, cache, tok)
        want.append(tok)
    model = interop.lm_params_from_numpy(tree, b, device="cpu")
    res = serve.generate(model, torch.from_numpy(toks), 4, attn_impl="naive")
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.concatenate([np.asarray(w) for w in want],
                                                 1))
    for cli in (serve, train):
        assert default_tp(cli.parser().parse_args(["--arch", "x",
                                                   "--smoke"])) == 1
        assert default_tp(cli.parser().parse_args(["--arch", "x"])) == 16
        assert default_tp(cli.parser().parse_args(["--arch", "x", "--tp",
                                                   "4"])) == 4


def test_serve_and_train_clis_at_tp(capsys):
    assert serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                       "--device", "cpu", "--tp", "16", "--batch", "2",
                       "--prompt-len", "8", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "tp=16" in out and "generated 3 tokens per prompt" in out
    out = train.train_lm(train.parser().parse_args([
        "--arch", "chatglm3-6b", "--smoke", "--device", "cpu", "--tp", "4",
        "--steps", "3", "--batch", "4", "--seq", "16"]))
    assert all(np.isfinite(r["loss"]) for r in out["steps"])
    assert "tp=4 (4 q / 2 kv heads, vocab 256)" in capsys.readouterr().out


def test_padded_caches_cross_from_repro():
    """A bf16-layout and an int8 cache that ``repro`` filled at a build
    with padded KV heads (6 q / 3 KV heads at ``tp=2``: 8 q over 4 KV,
    one KV head of zeros) come across with ``interop`` and decode on the
    port's one-process padded twin as on ``repro``: tokens equal, logits
    within 1e-5 (the int8 step 5e-2, bf16 dequantization)."""
    cfg_j = dc.replace(get_arch_j("chatglm3-6b").config.smoke(),
                       param_dtype="float32", n_heads=6, n_kv_heads=3)
    b_j = tfm_j.build(cfg_j, 2)
    assert (b_j.n_heads_p, b_j.n_kv_heads_p) == (8, 4)
    params = tfm_j.init_params(jax.random.PRNGKey(1), b_j)
    b = tfm_t.build(get_arch("chatglm3-6b").smoke().scaled(
        param_dtype="float32", n_heads=6, n_kv_heads=3), 2)
    model = interop.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), b, device="cpu")
    toks = np.random.default_rng(6).integers(0, 256, (2, 6))
    _, cj = jax.jit(lm_j.make_prefill_step(b_j, attn_impl="naive"))(
        params, jnp.asarray(toks, jnp.int32))
    pad = ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0))
    cj = {"k": jnp.pad(cj["k"], pad), "v": jnp.pad(cj["v"], pad),
          "pos": cj["pos"]}
    ct = interop.cache_from_numpy(jax.tree_util.tree_map(np.asarray, cj),
                                  device="cpu")
    assert ct["k"].shape[3] == 4 and not ct["k"][:, :, :, 3].any()
    dec_j = jax.jit(lambda p, c, t: tfm_j.decode_step(p, c, t, b_j))
    tok = toks[:, -1:]
    for _ in range(3):
        lj, cj = dec_j(params, cj, jnp.asarray(tok, jnp.int32))
        with torch.no_grad():
            lt, ct = model.decode_step(ct, torch.from_numpy(tok))
        close(lt.numpy(), lj, 1e-5)
        tok = lt[:, -1, :b.cfg.vocab].argmax(-1)[:, None].numpy()
        np.testing.assert_array_equal(
            tok[:, 0], np.asarray(jnp.argmax(lj[:, -1, :b.cfg.vocab], -1)))
    from repro.models import kvcache as kv_j

    qj = kv_j.init_cache_quant(b_j, 2, 8)
    step_j = jax.jit(lambda p, c, t: tfm_j.decode_step_quant(p, c, t, b_j,
                                                             chunk=8))
    for t in range(3):
        _, qj = step_j(params, qj, jnp.asarray(toks[:, t:t + 1], jnp.int32))
    qt = interop.cache_quant_from_numpy(
        jax.tree_util.tree_map(np.asarray, qj), device="cpu")
    assert qt["k_q"].shape[3] == 4 and qt["pos"] == 3
    lj, _ = step_j(params, qj, jnp.asarray(toks[:, 3:4], jnp.int32))
    with torch.no_grad():
        lt, _ = model.decode_step_quant(qt, torch.from_numpy(toks[:, 3:4]),
                                        chunk=8)
    close(lt.numpy(), lj, 5e-2)
