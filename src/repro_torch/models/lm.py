"""Serving heads (``repro.models.lm``'s ``make_prefill_step`` /
``make_decode_step``): batched prefill into a KV cache, then greedy decode.

The port's steps take the :class:`~repro_torch.models.transformer.LM`
module where ``repro``'s take a param tree.  Training (``TrainState``,
``chunked_ce``, ``make_train_step``) is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs import LMConfig
from repro_torch.models import transformer as tfm


def make_prefill_step(attn_impl: str = "auto"):
    """prefill(model, tokens [B, S]) -> (logits_last f32 [B, vocab],
    cache {"k", "v": [L, B, S, Hkv, Dh], "pos": S})."""

    @torch.no_grad()
    def prefill(model: tfm.LM, tokens: torch.Tensor):
        hidden, (k, v), _ = model(tokens, return_cache=True,
                                  attn_impl=attn_impl)
        logits_last = model.unembed(hidden[:, -1])
        return logits_last, {"k": k, "v": v, "pos": tokens.shape[1]}

    return prefill


def make_decode_step(attn_impl: str = "auto"):
    """decode(model, cache, tokens [B, 1]) -> (next_token [B, 1], cache):
    one step of greedy decode; the cache is updated in place."""

    @torch.no_grad()
    def decode(model: tfm.LM, cache: dict, tokens: torch.Tensor):
        logits, cache = model.decode_step(cache, tokens, attn_impl)
        next_tok = logits[:, -1].argmax(dim=-1)
        return next_tok[:, None], cache

    return decode


def grow_cache(cfg: LMConfig, cache: dict, max_seq: int) -> dict:
    """The prefill's cache copied into a zero cache of ``max_seq``
    positions (``repro``'s serve pads it the same way)."""
    k, v = cache["k"], cache["v"]
    s = k.shape[2]
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < cached positions {s}")
    out = tfm.init_cache(cfg, k.shape[1], max_seq, dtype=k.dtype,
                         device=k.device)
    out["k"][:, :, :s] = k
    out["v"][:, :, :s] = v
    out["pos"] = cache["pos"]
    return out
