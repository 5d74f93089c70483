"""Decoder-only transformer, dense and MoE, for serving and training
(``repro.models.transformer`` without sharding and the tp padding).

Serves and trains the LMs of :mod:`repro_torch.configs`: chatglm3-6b (GQA
kv=2, 2d/partial RoPE), qwen1.5-4b (QKV bias, MHA), command-r-plus-104b
(GQA kv=8), dbrx-132b (MoE 16e top-4) and granite-moe-3b-a800m (MoE 40e
top-8, head dim 64).  Weights keep ``repro``'s ``x @ W`` orientation and
names, one :class:`Block` per layer (a MoE layer's experts under
``moe.*``), so :func:`repro_torch.interop.lm_params_from_numpy` carries a
``repro`` param tree built at ``tp=1`` across unchanged.  The dimensions
are the config's: one card has no tensor parallelism, so no head,
vocabulary entry or expert is padded.  The parameters are created with
``requires_grad=False``, so serving builds no graph;
:func:`repro_torch.models.lm.init_train_state` turns grad on.  Under grad,
with ``cfg.remat``, each layer runs under ``torch.utils.checkpoint``
(``repro``'s ``jax.checkpoint`` of the scan body): its activations are
recomputed in the backward pass.  Decode runs against a bf16 cache
(:meth:`LM.decode_step`) or an int8 one (:meth:`LM.decode_step_quant`,
:mod:`repro_torch.models.kvcache`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import LMConfig, MoESpec
from repro_torch.device import resolve_device
from repro_torch.models import kvcache
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import attention, rotary
from repro_torch.models.common import dense_init, split_keys

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MoE(nn.Module):
    """A layer's experts and router (``repro``'s ``layers/moe/*`` keys); the
    router is f32 whatever the model's dtype."""

    def __init__(self, d_model: int, spec: MoESpec, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.spec = spec
        shapes = moe_lib.param_shapes(d_model, spec, spec.n_experts)
        for name, shape in shapes.items():
            setattr(self, name, _param(
                shape, torch.float32 if name == "router" else dtype, device))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """x [B, S, D] -> (y [B, S, D], aux)."""
        params = {name: getattr(self, name) for name in moe_lib.PARAMS}
        return moe_lib.moe_ffn(params, x, self.spec, self.spec.n_experts)


class Block(nn.Module):
    """One layer: RMSNorm -> GQA attention -> residual -> RMSNorm ->
    SwiGLU FFN (dense, or :class:`MoE`) -> residual.  Parameter names are
    ``repro``'s layer keys."""

    def __init__(self, cfg: LMConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        d, dh = cfg.d_model, cfg.head_dim
        q_w, kv_w = cfg.n_heads * dh, cfg.n_kv_heads * dh
        self.attn_norm = _param((d,), dtype, device)
        self.ffn_norm = _param((d,), dtype, device)
        self.wq = _param((d, q_w), dtype, device)
        self.wk = _param((d, kv_w), dtype, device)
        self.wv = _param((d, kv_w), dtype, device)
        self.wo = _param((q_w, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((q_w,), dtype, device)
            self.bk = _param((kv_w,), dtype, device)
            self.bv = _param((kv_w,), dtype, device)
        if cfg.moe is not None:
            self.moe = MoE(d, cfg.moe, dtype, device)
        else:
            self.w_gate = _param((d, cfg.d_ff), dtype, device)
            self.w_up = _param((d, cfg.d_ff), dtype, device)
            self.w_down = _param((cfg.d_ff, d), dtype, device)

    def _qkv(self, x, positions):
        """This step's rotated q [B, S, Hq, Dh] and k, v [B, S, Hkv, Dh]."""
        cfg = self.cfg
        bsz, s, _ = x.shape
        dh = cfg.head_dim
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = rotary(q.reshape(bsz, s, cfg.n_heads, dh), positions,
                   cfg.rotary_pct, cfg.rope_theta)
        k = rotary(k.reshape(bsz, s, cfg.n_kv_heads, dh), positions,
                   cfg.rotary_pct, cfg.rope_theta)
        return q, k, v.reshape(bsz, s, cfg.n_kv_heads, dh)

    def _attn(self, x, positions, cache_kv, cache_pos, attn_impl):
        cfg = self.cfg
        bsz, s, _ = x.shape
        q, k, v = self._qkv(x, positions)
        if cache_kv is not None:
            k_cache, v_cache = cache_kv
            k_cache[:, cache_pos:cache_pos + s] = k
            v_cache[:, cache_pos:cache_pos + s] = v
            # Positions past the current one are masked by q_offset.
            out = attention(q, k_cache, v_cache, q_offset=cache_pos,
                            impl=attn_impl)
            new_kv = (k_cache, v_cache)
        else:
            out = attention(q, k, v, impl=attn_impl)
            new_kv = (k, v)
        out = out.reshape(bsz, s, cfg.n_heads * cfg.head_dim)
        return out @ self.wo, new_kv

    def _ffn(self, h) -> tuple[torch.Tensor, dict]:
        if self.cfg.moe is not None:
            return self.moe(h)
        return (F.silu(h @ self.w_gate) * (h @ self.w_up)) @ self.w_down, {}

    def forward(self, x, positions, cache_kv=None, cache_pos: int = 0,
                attn_impl: str = "auto"):
        """x [B, S, D] -> (x, (k, v), aux); with ``cache_kv`` = (k_cache,
        v_cache) [B, Smax, Hkv, Dh] this step's K/V are written into the
        caches in place at ``cache_pos``.  ``aux`` is the MoE layer's
        (``{}`` for a dense one)."""
        eps = self.cfg.norm_eps
        h = rms_norm(x, self.attn_norm, eps)
        attn_out, new_kv = self._attn(h, positions, cache_kv, cache_pos,
                                      attn_impl)
        x = x + attn_out
        ffn_out, aux = self._ffn(rms_norm(x, self.ffn_norm, eps))
        return x + ffn_out, new_kv, aux

    def decode_quant(self, x, positions, cache_q, pos: int, chunk: int):
        """One token against this layer's int8 cache ``cache_q`` = (k_q,
        k_s, v_q, v_s) [B, Smax, Hkv, *]: the token's K/V are quantized and
        written in place at ``pos``, then attention dequantizes chunk by
        chunk."""
        cfg = self.cfg
        bsz = x.shape[0]
        q, k, v = self._qkv(rms_norm(x, self.attn_norm, cfg.norm_eps),
                            positions)
        k_q, k_s, v_q, v_s = cache_q
        k_q[:, pos:pos + 1], k_s[:, pos:pos + 1] = kvcache.quantize_kv(k)
        v_q[:, pos:pos + 1], v_s[:, pos:pos + 1] = kvcache.quantize_kv(v)
        attn = kvcache.decode_attention_quant(q, k_q, k_s, v_q, v_s, pos,
                                              chunk=chunk)
        x = x + attn.reshape(bsz, 1, cfg.n_heads * cfg.head_dim) @ self.wo
        ffn_out, _ = self._ffn(rms_norm(x, self.ffn_norm, cfg.norm_eps))
        return x + ffn_out


class LM(nn.Module):
    """Embedding, ``n_layers`` :class:`Block` s, final norm, head.  The
    parameters are allocated, not initialised: use :func:`init_lm` or
    ``load_state_dict``."""

    def __init__(self, cfg: LMConfig,
                 device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        dev = resolve_device(device)
        dtype = dtype or DTYPES[cfg.param_dtype]
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), dtype, dev)
        self.final_norm = _param((cfg.d_model,), dtype, dev)
        if not cfg.tie_embeddings:
            self.head = _param((cfg.d_model, cfg.vocab), dtype, dev)
        self.layers = nn.ModuleList(Block(cfg, dtype, dev)
                                    for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                return_cache: bool = False, attn_impl: str = "auto"):
        """Prefill forward: tokens [B, S] -> (final hidden [B, S, D], cache
        (k, v) each [L, B, S, Hkv, Dh] or None, aux).  ``aux`` holds
        ``load_balance`` and ``router_z``, each the mean over layers (0 for
        a dense model).  Logits are not formed here: :meth:`unembed` the
        positions that need them.  Under grad with ``cfg.remat`` each layer
        is checkpointed (its activations recomputed in the backward)."""
        bsz, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(bsz, s)
        x = F.embedding(tokens, self.embed)
        ks, vs, lb, rz = [], [], [], []
        zero = torch.zeros((), device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x, (k, v), aux = checkpoint(layer, x, positions,
                                            attn_impl=attn_impl,
                                            use_reentrant=False)
            else:
                x, (k, v), aux = layer(x, positions, attn_impl=attn_impl)
            if return_cache:
                ks.append(k)
                vs.append(v)
            lb.append(aux.get("load_balance", zero))
            rz.append(aux.get("router_z", zero))
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        aux = {"load_balance": torch.stack(lb).mean(),
               "router_z": torch.stack(rz).mean()}
        return x, ((torch.stack(ks), torch.stack(vs)) if return_cache
                   else None), aux

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """hidden [..., D] -> f32 logits [..., vocab]."""
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return (x @ head.to(x.dtype)).float()

    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    attn_impl: str = "auto") -> tuple[torch.Tensor, dict]:
        """One-token decode: tokens [B, 1] + cache -> (logits [B, 1, V],
        cache).  The token's K/V go into ``cache["k"]``/``cache["v"]`` in
        place (``repro`` returns new arrays); ``pos`` advances by one."""
        pos = int(cache["pos"])
        if pos >= cache["k"].shape[2]:
            raise ValueError(f"KV cache full: position {pos} of "
                             f"{cache['k'].shape[2]}")
        bsz = tokens.shape[0]
        positions = torch.full((bsz, 1), pos, device=tokens.device)
        x = F.embedding(tokens, self.embed)
        for i, layer in enumerate(self.layers):
            x, _, _ = layer(x, positions,
                            cache_kv=(cache["k"][i], cache["v"][i]),
                            cache_pos=pos, attn_impl=attn_impl)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.unembed(x), {"k": cache["k"], "v": cache["v"],
                                 "pos": pos + 1}

    def decode_step_quant(self, cache: dict, tokens: torch.Tensor,
                          chunk: int = 2048) -> tuple[torch.Tensor, dict]:
        """One-token decode against an int8 cache
        (:func:`~repro_torch.models.kvcache.init_cache_quant`): tokens
        [B, 1] -> (logits [B, 1, V], cache).  The token's quantized K/V go
        into the cache in place; ``pos`` advances by one.  The cache length
        must be a multiple of ``chunk``."""
        pos = int(cache["pos"])
        if pos >= cache["k_q"].shape[2]:
            raise ValueError(f"KV cache full: position {pos} of "
                             f"{cache['k_q'].shape[2]}")
        bsz = tokens.shape[0]
        positions = torch.full((bsz, 1), pos, device=tokens.device)
        x = F.embedding(tokens, self.embed)
        for i, layer in enumerate(self.layers):
            x = layer.decode_quant(
                x, positions, tuple(cache[n][i] for n in
                                    ("k_q", "k_s", "v_q", "v_s")), pos, chunk)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.unembed(x), {**cache, "pos": pos + 1}


@torch.no_grad()
def init_lm(cfg: LMConfig, generator: torch.Generator) -> LM:
    """An :class:`LM` on ``generator``'s device with random weights drawn
    as ``repro``'s ``init_params`` draws them: normal x 1/sqrt(fan_in),
    embedding x 0.02, norms one, biases zero; a MoE router in f32."""
    dtype = DTYPES[cfg.param_dtype]
    model = LM(cfg, device=generator.device, dtype=dtype)
    d, dh = cfg.d_model, cfg.head_dim
    q_w, kv_w = cfg.n_heads * dh, cfg.n_kv_heads * dh
    ks = split_keys(generator, ["embed", "head", "wq", "wk", "wv", "wo",
                                "ffn", "moe"])
    model.embed.copy_(dense_init(ks["embed"], (cfg.vocab, d), dtype,
                                 scale=0.02))
    model.final_norm.fill_(1)
    if not cfg.tie_embeddings:
        model.head.copy_(dense_init(ks["head"], (d, cfg.vocab), dtype))
    for layer in model.layers:
        layer.wq.copy_(dense_init(ks["wq"], (d, q_w), dtype))
        layer.wk.copy_(dense_init(ks["wk"], (d, kv_w), dtype))
        layer.wv.copy_(dense_init(ks["wv"], (d, kv_w), dtype))
        layer.wo.copy_(dense_init(ks["wo"], (q_w, d), dtype))
        if cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                getattr(layer, name).zero_()
        layer.attn_norm.fill_(1)
        layer.ffn_norm.fill_(1)
        if cfg.moe is not None:
            weights = moe_lib.init_moe(ks["moe"], d, cfg.moe,
                                       cfg.moe.n_experts, dtype)
            for name, w in weights.items():
                getattr(layer.moe, name).copy_(w)
        else:
            layer.w_gate.copy_(dense_init(ks["ffn"], (d, cfg.d_ff), dtype))
            layer.w_up.copy_(dense_init(ks["ffn"], (d, cfg.d_ff), dtype))
            layer.w_down.copy_(dense_init(ks["ffn"], (cfg.d_ff, d), dtype))
    return model


def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> dict:
    """A zero KV cache: k, v [L, batch, max_seq, Hkv, Dh]; pos 0."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}
