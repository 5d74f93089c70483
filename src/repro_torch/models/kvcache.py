"""Quantized (int8) KV cache for long-context decode (``repro.models.kvcache``).

int8 halves both the resident cache and the bytes each decode step reads.
Symmetric scales per (layer, batch, position, head) (KIVI-style per-token
granularity); attention dequantizes chunk by chunk inside an online softmax,
so no bf16 copy of the cache exists beyond one chunk.  Plain torch, as
``repro``'s is plain XLA: no kernel.  ``repro``'s ``cache_quant_specs`` is a
mesh sharding and has no counterpart on one card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs import LMConfig
from repro_torch.device import resolve_device

NEG_INF = -1e30


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (int8 [..., Dh], scale f32 [..., 1]); round half to
    even, as ``jnp.round``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def init_cache_quant(cfg: LMConfig, batch: int, max_seq: int,
                     device: str | torch.device | None = None) -> dict:
    """A zero int8 cache: k_q, v_q int8 [L, batch, max_seq, Hkv, Dh], k_s,
    v_s f32 [L, batch, max_seq, Hkv, 1]; pos 0."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    scales = shape[:-1] + (1,)
    return {"k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_s": torch.zeros(scales, dtype=torch.float32, device=dev),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v_s": torch.zeros(scales, dtype=torch.float32, device=dev),
            "pos": 0}


def decode_attention_quant(q, k_q, k_s, v_q, v_s, pos: int,
                           chunk: int = 2048) -> torch.Tensor:
    """One-token attention over an int8 cache, chunk-dequantized.

    q [B, 1, Hq, Dh]; k_q/v_q [B, S, Hkv, Dh] int8 with scales
    [B, S, Hkv, 1]; keys at positions ``<= pos`` are seen.  Every chunk is
    read, whatever ``pos``.  Each chunk dequantizes in bf16 (the scale
    rounded to bf16 first), the scores and running max and sum stay f32,
    and P·V takes P in bf16, as ``repro``'s.  Returns [B, 1, Hq, Dh] in q's
    dtype.  ``S`` must be a multiple of ``chunk``.
    """
    bsz, _, hq, dh = q.shape
    _, s, hkv, _ = k_q.shape
    if s % chunk:
        raise ValueError(f"decode_attention_quant: cache length {s} is not "
                         f"a multiple of chunk {chunk}")
    g = hq // hkv
    qr = q.reshape(bsz, hkv, g, dh)
    scale = 1.0 / math.sqrt(dh)
    m = torch.full((bsz, hkv, g), NEG_INF, device=q.device)
    l = torch.zeros((bsz, hkv, g), device=q.device)
    acc = torch.zeros((bsz, hkv, g, dh), device=q.device)
    for ic in range(s // chunk):
        blk = slice(ic * chunk, (ic + 1) * chunk)
        k_blk = k_q[:, blk].to(torch.bfloat16) * k_s[:, blk].to(torch.bfloat16)
        logits = torch.einsum("bhgd,bkhd->bhgk", qr.float(),
                              k_blk.float()) * scale
        kpos = ic * chunk + torch.arange(chunk, device=q.device)
        logits = logits.masked_fill((kpos > pos)[None, None, None], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        v_blk = v_q[:, blk].to(torch.bfloat16) * v_s[:, blk].to(torch.bfloat16)
        pv = torch.einsum("bhgk,bkhd->bhgd", p.to(torch.bfloat16).float(),
                          v_blk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(bsz, 1, hq, dh).to(q.dtype)
