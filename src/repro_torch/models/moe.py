"""Mixture-of-Experts FFN (dbrx 16e top-4, granite 40e top-8) on one device
(``repro.models.moe``'s ``_moe_local``, the path ``moe_ffn`` takes without
a mesh).

Each token's router picks its top-k experts; a cumsum over the flattened
(token, slot) assignments, token-major, ranks each expert's tokens, and an
assignment past the expert's capacity is dropped.  The kept tokens are
scattered into per-expert buffers ``[E, C, D]``, run through each expert's
SwiGLU MLP, gathered back and summed with their gates.  ``repro``'s two mesh
paths (``_moe_sharded``: all_to_all over the expert axis;
``_moe_dense_all``: every expert for every token) need a mesh and are not
ported; one card has none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import MoESpec
from repro_torch.models.common import dense_init, split_keys

NEG_INF = -1e30
PARAMS = ("router", "w_gate", "w_up", "w_down")


def pad_to(x: int, multiple: int) -> int:
    return int(-(-x // multiple) * multiple)


def param_shapes(d_model: int, spec: MoESpec, e_pad: int) -> dict:
    f = spec.d_ff_expert
    return {"router": (d_model, e_pad), "w_gate": (e_pad, d_model, f),
            "w_up": (e_pad, d_model, f), "w_down": (e_pad, f, d_model)}


def init_moe(generator: torch.Generator, d_model: int, spec: MoESpec,
             e_pad: int, dtype: torch.dtype) -> dict:
    """One layer's expert weights drawn as ``repro``'s ``init_moe`` draws
    them (normal x 1/sqrt(fan_in)); the router is f32 whatever ``dtype``."""
    ks = split_keys(generator, PARAMS)
    return {name: dense_init(ks[name], shape,
                             torch.float32 if name == "router" else dtype)
            for name, shape in param_shapes(d_model, spec, e_pad).items()}


def capacity(n_tokens: int, spec: MoESpec, e_pad: int) -> int:
    """Slots per expert: ``capacity_factor`` x the even share, at least 4,
    a multiple of 4."""
    c = int(n_tokens * spec.top_k * spec.capacity_factor / e_pad) + 1
    return max(4, pad_to(c, 4))


def _route(router, x, spec: MoESpec, n_real: int, e_pad: int):
    """The router in f32: returns (gate [T, k], ids [T, k], probs [T, E],
    logits [T, E]).  Ties go to the lower expert id, as ``lax.top_k``."""
    logits = x.float() @ router
    if n_real < e_pad:
        pad = torch.arange(e_pad, device=x.device) >= n_real
        logits = logits.masked_fill(pad[None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :spec.top_k], ids[:, :spec.top_k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return gate, ids, probs, logits


def _aux(probs, ids, logits, e_pad: int, keep=None) -> dict:
    """Load balance (E x sum of mean prob x mean assignment), router z-loss
    and the share of assignments dropped past capacity."""
    me = probs.mean(dim=0)
    ce = F.one_hot(ids, e_pad).float().mean(dim=(0, 1))
    out = {"load_balance": (me * ce).sum() * e_pad,
           "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean()}
    if keep is None:
        out["dropped_frac"] = torch.zeros((), device=probs.device)
    else:
        # XLA's mean: the sum times the f32 reciprocal of the count.
        inv = torch.tensor(1.0 / keep.numel(), device=keep.device)
        out["dropped_frac"] = 1.0 - keep.float().sum() * inv
    return out


def _dispatch_local(x, gate, ids, spec: MoESpec, e_pad: int, c: int):
    """Cumsum-ranked capacity assignment: returns (buf [E, C, D], slot,
    keep, tok_of), one entry of the last three per (token, slot), token-major.
    A dropped assignment's slot is ``e_pad * c``, past the buffer."""
    t, d = x.shape
    k = spec.top_k
    flat_ids = ids.reshape(-1)
    # Expert-major one-hot [E, T*k]: the cumsum runs along the inner dim,
    # which the card scans in parallel (along the outer dim of a
    # [T*k, E] one-hot it runs one thread per expert).
    oh = F.one_hot(flat_ids, e_pad).T.contiguous()
    pos = oh.cumsum(dim=1) - oh
    my_pos = pos.gather(0, flat_ids[None, :])[0]
    keep = my_pos < c
    slot = torch.where(keep, flat_ids * c + my_pos,
                       torch.full_like(flat_ids, e_pad * c))
    tok_of = torch.arange(t * k, device=x.device) // k
    # Kept slots are distinct; every dropped one lands on the extra row.
    buf = torch.zeros((e_pad * c + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, x[tok_of])
    return buf[:-1].reshape(e_pad, c, d), slot, keep, tok_of


def _combine_local(y_buf, slot, keep, tok_of, gate, t: int):
    """Each kept assignment's expert output x its gate (in the buffer's
    dtype), summed per token.  A token's k assignments are consecutive
    (``tok_of`` is ``arange // k``), so the segment sum is a sum over k."""
    e_c, d = y_buf.shape[0] * y_buf.shape[1], y_buf.shape[2]
    y_rep = y_buf.reshape(e_c, d)[slot.clamp(max=e_c - 1)]
    y_rep = torch.where(keep[:, None], y_rep, 0)
    y_rep = y_rep * gate.reshape(-1)[:, None].to(y_rep.dtype)
    return y_rep.reshape(t, -1, d).sum(dim=1)


def _expert_mlp(buf, wg, wu, wd):
    """Every expert's SwiGLU on its slots: [E, C, D] -> [E, C, D]."""
    return (F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)) @ wd


def moe_local(params: dict, x: torch.Tensor, spec: MoESpec, n_real: int):
    """x [T, D] -> ([T, D] in x's dtype, aux)."""
    t, _ = x.shape
    e_pad = params["router"].shape[1]
    c = capacity(t, spec, e_pad)
    gate, ids, probs, logits = _route(params["router"], x, spec, n_real, e_pad)
    buf, slot, keep, tok_of = _dispatch_local(x, gate, ids, spec, e_pad, c)
    y_buf = _expert_mlp(buf, params["w_gate"], params["w_up"],
                        params["w_down"])
    y = _combine_local(y_buf, slot, keep, tok_of, gate, t)
    return y.to(x.dtype), _aux(probs, ids, logits, e_pad, keep)


def moe_ffn(params: dict, x: torch.Tensor, spec: MoESpec,
            n_experts_real: int) -> tuple[torch.Tensor, dict]:
    """x [B, S, D] -> ([B, S, D], aux metrics), on the one device."""
    b, s, d = x.shape
    y, aux = moe_local(params, x.reshape(b * s, d), spec, n_experts_real)
    return y.reshape(b, s, d), aux
