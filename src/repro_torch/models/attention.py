"""Causal GQA attention: naive, chunked (online softmax in plain torch),
and the hand-written flash kernel on the card (``repro.models.attention``).

Layouts: q [B, Sq, Hq, Dh]; k/v [B, Skv, Hkv, Dh]; GQA groups
G = Hq // Hkv, query head ``h`` reading KV head ``h // G``.  Query row
``i`` sits at position ``q_offset + i`` and sees the keys at positions
``<=`` its own: the decoder's only use, so every path is causal.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30
IMPLS = ("auto", "naive", "chunked", "chunked_f32", "cuda")


def rotary(x: torch.Tensor, positions: torch.Tensor, pct: float = 1.0,
           theta: float = 10000.0) -> torch.Tensor:
    """NeoX-style rotary embedding on the first ``pct`` of head dims.

    x: [B, S, H, Dh]; positions: [B, S] (absolute token positions).
    ``pct=0.5`` gives ChatGLM's 2d-RoPE (half the dims rotate).  Computed
    in f32, returned in x's dtype.
    """
    dh = x.shape[-1]
    rot = int(dh * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2, x_pass.float()], dim=-1).to(x.dtype)


def _naive(q, k, v, q_offset: int) -> torch.Tensor:
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qr = q.reshape(b, sq, hkv, g, dh)
    scale = 1.0 / math.sqrt(dh)
    # f32 products summed in f32 (JAX's preferred_element_type=float32).
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    logits = torch.where(kpos[None, :] <= qpos[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, dh)


def _chunked(q, k, v, q_offset: int, block: int,
             score_dtype: torch.dtype) -> torch.Tensor:
    """Online softmax over KV blocks of ``block`` keys: O(Sq·block) live
    memory.  The [.., Sq, block] scores and probabilities live in
    ``score_dtype``; the running max and sum stay f32."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    pad = (-skv) % block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nb = (skv + pad) // block
    qr = q.reshape(b, sq, hkv, g, dh).float()
    # The scale is rounded to the score dtype first, as JAX does.
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=score_dtype,
                         device=q.device)
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), device=q.device)
    for ib in range(nb):
        kblk = k[:, ib * block:(ib + 1) * block]
        vblk = v[:, ib * block:(ib + 1) * block]
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qr, kblk.float())
        logits = logits.to(score_dtype) * scale
        kpos = ib * block + torch.arange(block, device=q.device)
        mask = (kpos < skv)[None, :] & (kpos[None, :] <= qpos[:, None])
        logits = logits.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1).float())
        p = torch.exp(logits - m_new[..., None].to(score_dtype))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, dtype=torch.float32)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              impl: str = "auto", q_offset: int = 0,
              block: int = 512) -> torch.Tensor:
    """Dispatch across causal attention implementations.

    impl="auto": decode (Sq <= 16) -> naive; long KV (> 2048) -> chunked;
    else naive.  "chunked" keeps the scores in bf16, "chunked_f32" in f32.
    impl="cuda" is the flash kernel (``repro``'s "pallas"):
    on a CUDA tensor it launches the kernel, on a CPU tensor it runs the
    kernel's plain version.  ``repro``'s "flash_jax" (training) is not
    ported yet.
    """
    sq, skv = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "naive" if sq <= 16 or skv <= 2048 else "chunked"
    if impl == "cuda":
        return fa_ops.flash_attention(q, k, v, q_offset=int(q_offset))
    if impl == "chunked":
        return _chunked(q, k, v, int(q_offset), block, torch.bfloat16)
    if impl == "chunked_f32":
        return _chunked(q, k, v, int(q_offset), block, torch.float32)
    if impl == "naive":
        return _naive(q, k, v, int(q_offset))
    raise ValueError(f"attention impl {impl!r} is not one of {IMPLS}")
