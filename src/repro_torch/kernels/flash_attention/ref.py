"""Plain torch version of the flash-attention kernel: naive causal GQA
attention with f32 logits and an f32 softmax (``repro``'s
``kernels/flash_attention/ref.py::attention_ref``)."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, Dh], k/v [B, Skv, Hkv, Dh] -> [B, Sq, Hq, Dh] in v's
    dtype.  Query head ``h`` reads KV head ``h // (Hq // Hkv)``; query row
    ``i`` sees the keys at positions ``<= q_offset + i``."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qr = q.reshape(b, sq, hkv, g, dh)
    # f32 products of the inputs, summed in f32 (JAX's
    # preferred_element_type=float32).
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float())
    logits = logits / math.sqrt(dh)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    logits = torch.where(kpos[None, :] <= qpos[:, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(b, sq, hq, dh)
