"""Causal GQA attention: naive, chunked (online softmax in plain torch),
flash_jax (the online softmax with a hand-written FlashAttention-2
backward, for training) and the hand-written flash kernel on the card
(``repro.models.attention``).

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
IMPLS = ("auto", "naive", "chunked", "chunked_f32", "flash_jax", "cuda")


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


def _blocks(k, v, block: int):
    """k, v padded to a multiple of ``block`` keys, and the block count."""
    pad = (-k.shape[1]) % block
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v, k.shape[1] // block


def _block_scores(qr, kblk, ib: int, block: int, skv: int, q_offset: int,
                  scale: torch.Tensor) -> torch.Tensor:
    """Scores of KV block ``ib`` in the score dtype (``scale``'s), [b, hkv,
    g, sq, block], with -1e30 at keys past ``skv`` (padding) and past each
    row's position.  ``repro`` adds a -1e30 bias there instead; a score
    plus -1e30, rounded to the score dtype, is -1e30, so both agree bit
    for bit."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), kblk.float())
    logits = logits.to(scale.dtype) * scale
    kpos = ib * block + torch.arange(block, device=qr.device)
    qpos = q_offset + torch.arange(qr.shape[1], device=qr.device)
    mask = (kpos < skv)[None, :] & (kpos[None, :] <= qpos[:, None])
    return logits.masked_fill(~mask, NEG_INF)


def _online_softmax(q, k, v, q_offset: int, block: int,
                    score_dtype: torch.dtype):
    """Online softmax over KV blocks of ``block`` keys: O(Sq·block) live
    memory.  The [.., Sq, block] scores and probabilities live in
    ``score_dtype``; the running max and sum stay f32.  Returns (out f32
    [b, hkv, g, sq, dh], normalized, and the running max m and sum l, f32
    [b, hkv, g, sq])."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    k, v, nb = _blocks(k, v, block)
    qr = q.reshape(b, sq, hkv, g, dh).float()
    # The scale is rounded to the score dtype first, as JAX does.
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=score_dtype,
                         device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), device=q.device)
    for ib in range(nb):
        kblk = k[:, ib * block:(ib + 1) * block]
        vblk = v[:, ib * block:(ib + 1) * block]
        logits = _block_scores(qr, kblk, ib, block, skv, q_offset, scale)
        m_new = torch.maximum(m, logits.amax(dim=-1).float())
        p = torch.exp(logits - m_new[..., None].to(score_dtype))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, dtype=torch.float32)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None], m, l


def _heads_last(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[b, hkv, g, sq, dh] -> [b, sq, hkv * g, dh] in ``dtype``."""
    b, hkv, g, sq, dh = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hkv * g, dh).to(dtype)


def _chunked(q, k, v, q_offset: int, block: int,
             score_dtype: torch.dtype) -> torch.Tensor:
    """:func:`_online_softmax`'s output in q's layout and dtype; autograd
    differentiates through the loop."""
    out, _, _ = _online_softmax(q, k, v, q_offset, block, score_dtype)
    return _heads_last(out, q.dtype)


class _FlashJax(torch.autograd.Function):
    """``repro``'s ``make_flash_jax``: the forward online softmax keeps
    (q, k, v, out, m, l); the backward recomputes each KV block's
    probabilities in ``score_dtype`` from them (the FlashAttention-2
    backward) instead of storing the [.., Sq, Skv] scores.  dq, dk and dv
    are summed in f32, where ``repro``'s einsums ask for f32."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, block: int,
                score_dtype: torch.dtype):
        out, m, l = _online_softmax(q, k, v, q_offset, block, score_dtype)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.cfg = (q_offset, block, score_dtype)
        return _heads_last(out, q.dtype)

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, out, m, l = ctx.saved_tensors
        q_offset, block, sd = ctx.cfg
        b, sq, hq, dh = q.shape
        _, skv, hkv, _ = k.shape
        g = hq // hkv
        kp, vp, nb = _blocks(k, v, block)
        qr = q.reshape(b, sq, hkv, g, dh).float()
        scale = torch.tensor(1.0 / math.sqrt(dh), dtype=sd, device=q.device)
        do = d_o.reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4).float()
        # delta = rowsum(dO * O), with ``out`` already normalized.
        delta = (do * out).sum(dim=-1)                      # [b,hkv,g,sq]
        linv = 1.0 / torch.clamp(l, min=1e-30)
        do_c = do.to(sd)
        dq = torch.zeros((b, sq, hkv, g, dh), device=q.device)
        dks, dvs = [], []
        for ib in range(nb):
            kblk = kp[:, ib * block:(ib + 1) * block]
            vblk = vp[:, ib * block:(ib + 1) * block]
            logits = _block_scores(qr, kblk, ib, block, skv, q_offset, scale)
            p = torch.exp(logits - m[..., None].to(sd))
            p = p * linv[..., None].to(sd)                  # normalized
            dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p.float(),
                                    do_c.float()).to(v.dtype))
            # dp and ds stay in the score dtype, the other [.., Sq, block]
            # giants; the dq / dk sums run in f32.
            dp = torch.einsum("bhgqd,bkhd->bhgqk", do_c.float(),
                              vblk.to(sd).float()).to(sd)
            ds = p * (dp - delta[..., None].to(sd))
            ds = ds * scale
            dq += torch.einsum("bhgqk,bkhd->bqhgd", ds.float(), kblk.float())
            dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds.float(),
                                    qr).to(k.dtype))
        dq = dq.reshape(b, sq, hq, dh).to(q.dtype)
        dk = torch.cat(dks, dim=1)[:, :skv]
        dv = torch.cat(dvs, dim=1)[:, :skv]
        return dq, dk, dv, None, None, None


def flash_jax(q, k, v, q_offset: int = 0, block: int = 512,
              score_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Causal GQA attention with :class:`_FlashJax`'s backward."""
    return _FlashJax.apply(q, k, v, int(q_offset), block, score_dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              impl: str = "auto", q_offset: int = 0,
              block: int = 512) -> torch.Tensor:
    """Dispatch across causal attention implementations.

    impl="auto": decode (Sq <= 16) -> naive; long KV (> 2048) -> chunked;
    else naive.  "chunked" keeps the scores in bf16, "chunked_f32" in f32;
    "flash_jax" is the online softmax with the hand-written backward
    (scores in bf16).  impl="cuda" is the flash kernel (``repro``'s
    "pallas"): on a CUDA tensor it launches the kernel, on a CPU tensor it
    runs the kernel's plain version.  The kernel has no backward, as
    ``repro``'s Pallas kernel has no VJP: under grad, "cuda" raises.
    """
    sq, skv = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "naive" if sq <= 16 or skv <= 2048 else "chunked"
    if impl == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise ValueError(
                "attention impl 'cuda' (the flash kernel) has no backward; "
                "train with impl='flash_jax' or 'chunked'")
        return fa_ops.flash_attention(q, k, v, q_offset=int(q_offset))
    if impl == "flash_jax":
        return flash_jax(q, k, v, int(q_offset), block)
    if impl == "chunked":
        return _chunked(q, k, v, int(q_offset), block, torch.bfloat16)
    if impl == "chunked_f32":
        return _chunked(q, k, v, int(q_offset), block, torch.float32)
    if impl == "naive":
        return _naive(q, k, v, int(q_offset))
    raise ValueError(f"attention impl {impl!r} is not one of {IMPLS}")
