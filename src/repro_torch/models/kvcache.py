"""Quantized (int8) KV cache for long-context decode (``repro.models.kvcache``).

int8 halves both the resident cache and the bytes each decode step reads.
Symmetric scales per (layer, batch, position, head) (KIVI-style per-token
granularity); attention dequantizes chunk by chunk inside an online softmax,
so no bf16 copy of the cache exists beyond one chunk.  Plain torch, as
``repro``'s is plain XLA: no kernel.  On a mesh a rank holds its positions
of the cache (:func:`cache_quant_specs`); quantization is per position,
so a rank's codes and scales are those of the whole cache, and each
rank's partial softmax (:func:`decode_partial_quant`, its running max
started where one loop over the whole cache would stand) is merged
across ``model``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec, axis_sizes, local_shape

NEG_INF = -1e30


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., Dh] -> (int8 [..., Dh], scale f32 [..., 1]); round half to
    even, as ``jnp.round``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp(min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def cache_quant_specs(b, seq_axes=("model",)) -> dict:
    """``repro``'s int8 cache shardings: the batch over the data axes, the
    positions over ``seq_axes``."""
    sp = PartitionSpec(None, ("pod", "data"), seq_axes, None, None)
    return {"k_q": sp, "k_s": sp, "v_q": sp, "v_s": sp,
            "pos": PartitionSpec()}


def init_cache_quant(cfg, batch: int, max_seq: int,
                     device: str | torch.device | None = None,
                     mesh=None) -> dict:
    """A zero int8 cache at the padded KV heads of a ``BuiltLM`` (a
    config: ``tp=1``): k_q, v_q int8 [L, batch, max_seq, Hkv, Dh], k_s,
    v_s f32 [L, batch, max_seq, Hkv, 1]; pos 0.  On ``mesh``, this rank's
    slice of it (:func:`cache_quant_specs`)."""
    from repro_torch.models.transformer import as_built

    b = as_built(cfg)
    dev = resolve_device(device)
    shape = local_shape((b.cfg.n_layers, batch, max_seq, b.n_kv_heads_p,
                         b.cfg.head_dim), cache_quant_specs(b)["k_q"],
                        axis_sizes(mesh))
    scales = shape[:-1] + (1,)
    return {"k_q": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_s": torch.zeros(scales, dtype=torch.float32, device=dev),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v_s": torch.zeros(scales, dtype=torch.float32, device=dev),
            "pos": 0}


def _max_before(m: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The largest of ``m`` over the ranks before this one along ``axes``
    (NEG_INF on the first): where one loop over a cache split on the
    sequence would stand when it reaches this rank's positions."""
    parts = comm.all_gather(m, axes, dim=0, mesh=mesh)
    j = mesh.axis_index(axes)
    return parts[:j].amax(dim=0) if j else torch.full_like(m, NEG_INF)


def decode_partial_quant(q, k_q, k_s, v_q, v_s, pos: int,
                         chunk: int = 2048, axes=(), mesh=None):
    """:func:`decode_attention_quant`'s online softmax over the cache,
    left unnormalised: (acc f32 [B, 1, Hq, Dh], m, l f32 [B, 1, Hq]), the
    layout of :func:`repro_torch.models.attention.merge_partials`.  Keys
    at positions ``<= pos`` of this cache are seen (``pos`` may be
    negative: a rank whose positions all lie ahead sees none).  With
    ``axes`` the cache is this rank's share of one split on the sequence
    over them, in rank order: the running max starts from the ranks
    before this one's largest score (a first pass over the chunks finds
    this rank's), so each chunk's P rounds to bf16 against the max that
    one loop over the whole cache holds at that chunk."""
    bsz, _, hq, dh = q.shape
    _, s, hkv, _ = k_q.shape
    if s % chunk:
        raise ValueError(f"decode_attention_quant: cache length {s} is not "
                         f"a multiple of chunk {chunk}")
    g = hq // hkv
    qr = q.reshape(bsz, hkv, g, dh).float()
    scale = 1.0 / math.sqrt(dh)

    def scores(ic):
        blk = slice(ic * chunk, (ic + 1) * chunk)
        k_blk = k_q[:, blk].to(torch.bfloat16) * k_s[:, blk].to(torch.bfloat16)
        logits = torch.einsum("bhgd,bkhd->bhgk", qr, k_blk.float()) * scale
        kpos = ic * chunk + torch.arange(chunk, device=q.device)
        return logits.masked_fill((kpos > pos)[None, None, None], NEG_INF)

    m = torch.full((bsz, hkv, g), NEG_INF, device=q.device)
    if axes:
        m = _max_before(torch.stack([scores(ic).amax(dim=-1)
                                     for ic in range(s // chunk)]).amax(0),
                        axes, mesh)
    l = torch.zeros((bsz, hkv, g), device=q.device)
    acc = torch.zeros((bsz, hkv, g, dh), device=q.device)
    for ic in range(s // chunk):
        logits = scores(ic)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        blk = slice(ic * chunk, (ic + 1) * chunk)
        v_blk = v_q[:, blk].to(torch.bfloat16) * v_s[:, blk].to(torch.bfloat16)
        pv = torch.einsum("bhgk,bkhd->bhgd", p.to(torch.bfloat16).float(),
                          v_blk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc.reshape(bsz, 1, hq, dh), m.reshape(bsz, 1, hq),
            l.reshape(bsz, 1, hq))


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
    from repro_torch.models.attention import merge_partials

    return merge_partials(*decode_partial_quant(q, k_q, k_s, v_q, v_s, pos,
                                                chunk), (), None, q.dtype)
