"""LM task heads (``repro.models.lm``): the loss and the train step, then
the serving heads (batched prefill into a KV cache, greedy decode).

The port's functions take the :class:`~repro_torch.models.transformer.LM`
module where ``repro``'s take a param tree.  A :class:`TrainState` holds
the module itself, AdamW's f32 moments keyed by parameter name and the
step.  :func:`train_state_tree` gives the state as ``repro``'s
``TrainState`` pytree (layer parameters stacked ``[L, ...]`` through
:class:`~repro_torch.checkpoint.Stacked`), the order in which checkpoints
and :mod:`repro_torch.interop` carry it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.checkpointer import Stacked
from repro_torch.configs import LMConfig
from repro_torch.distributed.fault import block_until_ready
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, OptState, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    """The model (its parameters require grad), AdamW's state (``mu`` and
    ``nu``: dicts of f32 tensors keyed as ``model.named_parameters()``) and
    the number of steps taken."""

    model: tfm.LM
    opt: OptState
    step: int


def init_train_state(model: tfm.LM) -> TrainState:
    """Turns grad on for every parameter of ``model`` and pairs it with
    zero AdamW moments, at step 0."""
    for p in model.parameters():
        p.requires_grad_(True)
    return TrainState(model=model,
                      opt=adamw_init(dict(model.named_parameters())), step=0)


def _repro_tree(named: dict, n_layers: int) -> dict:
    """Per-parameter tensors keyed as ``named_parameters()`` -> ``repro``'s
    param tree: ``layers`` as :class:`Stacked` leaves, a MoE layer's keys
    under ``layers/moe``."""
    tree: dict[str, Any] = {k: v for k, v in named.items()
                            if not k.startswith("layers.")}
    layers: dict[str, Any] = {}
    for key in (k[len("layers.0."):] for k in named
                if k.startswith("layers.0.")):
        leaf = Stacked(named[f"layers.{i}.{key}"] for i in range(n_layers))
        if key.startswith("moe."):
            layers.setdefault("moe", {})[key[len("moe."):]] = leaf
        else:
            layers[key] = leaf
    tree["layers"] = layers
    return tree


def _named(tree: dict) -> dict:
    """The inverse of :func:`_repro_tree`."""
    named = {k: v for k, v in tree.items() if k != "layers"}
    for key, leaf in tree["layers"].items():
        sub = leaf.items() if key == "moe" else ((None, leaf),)
        for name, stacked in sub:
            full = key if name is None else f"moe.{name}"
            for i, part in enumerate(stacked.parts):
                named[f"layers.{i}.{full}"] = part
    return named


def train_state_tree(state: TrainState) -> list:
    """``state`` as ``repro``'s ``TrainState`` pytree: ``[params, [mu, nu,
    count], step]``, each of params, mu and nu ``repro``'s param tree
    (keys sorted on flattening, layers stacked).  Its leaves alias the
    state's tensors."""
    n = state.model.cfg.n_layers
    params = {k: p.detach() for k, p in state.model.named_parameters()}
    return [_repro_tree(params, n),
            [_repro_tree(state.opt.mu, n), _repro_tree(state.opt.nu, n),
             state.opt.count],
            state.step]


def train_state_template(cfg: LMConfig) -> list:
    """:func:`train_state_tree` of a state on the ``meta`` device: shapes
    and dtypes without memory, the template a checkpoint restores into."""
    return train_state_tree(init_train_state(tfm.LM(cfg, device="meta")))


def train_state_from_tree(cfg: LMConfig, tree: list) -> TrainState:
    """The inverse of :func:`train_state_tree`: the model takes the tree's
    tensors as its parameters (no copy) and requires grad."""
    params, (mu, nu, count), step = tree
    named = _named(params)
    model = tfm.LM(cfg, device="meta", dtype=named["embed"].dtype)
    model.load_state_dict(named, assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return TrainState(model=model, opt=OptState(mu=_named(mu), nu=_named(nu),
                                                count=count), step=int(step))


def tfm_vocab_p(model: tfm.LM) -> int:
    """The head's width: the vocabulary, which one card never pads."""
    return model.cfg.vocab


def _chunk_ce(model: tfm.LM, h: torch.Tensor, lab: torch.Tensor
              ) -> torch.Tensor:
    logits = model.unembed(h)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab[..., None].long())[..., 0]
    return (logz - gold).sum()


def chunked_ce(model: tfm.LM, hidden: torch.Tensor, labels: torch.Tensor,
               chunk: int = 512) -> torch.Tensor:
    """Mean cross entropy without materializing [B, S, vocab] logits: the
    sequence in chunks of ``chunk`` positions (halved until it divides S),
    each chunk's f32 logits recomputed in the backward pass
    (``torch.utils.checkpoint``), so live memory is O(B·chunk·vocab)."""
    bsz, s, _ = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        args = (model, hidden[:, i * chunk:(i + 1) * chunk],
                labels[:, i * chunk:(i + 1) * chunk])
        total = total + (checkpoint(_chunk_ce, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_ce(*args))
    return total / (bsz * s)


def lm_loss(model: tfm.LM, batch: dict, attn_impl: str = "auto",
            loss_chunk: int = 512) -> tuple[torch.Tensor, dict]:
    """(loss, {"ce", "load_balance", "router_z"}): the chunked cross
    entropy of ``batch["labels"]`` given ``batch["tokens"]``, plus, for a
    MoE model, ``aux_loss_weight`` x load balance and ``router_z_weight``
    x the router z-loss."""
    hidden, _, aux = model(batch["tokens"], attn_impl=attn_impl)
    ce = chunked_ce(model, hidden, batch["labels"], chunk=loss_chunk)
    loss = ce
    moe = model.cfg.moe
    if moe is not None:
        loss = (loss + moe.aux_loss_weight * aux["load_balance"]
                + moe.router_z_weight * aux["router_z"])
    return loss, {"ce": ce, **aux}


def _grads_of(model: tfm.LM, batch: dict, attn_impl: str, leaves: list):
    """(loss, gradients of ``leaves``, each MoE layer's ``dropped_frac``
    [L] or None) of one batch.  The drops are read by forward hooks on the
    MoE modules, removed before the backward recomputes the layers."""
    drops: list = []
    hooks = [layer.moe.register_forward_hook(
        lambda mod, args, out: drops.append(out[1]["dropped_frac"].detach()))
        for layer in model.layers if model.cfg.moe is not None]
    try:
        loss, _ = lm_loss(model, batch, attn_impl)
    finally:
        for h in hooks:
            h.remove()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, (torch.stack(drops) if drops else None)


def loss_and_grads(model: tfm.LM, batch: dict, attn_impl: str = "auto",
                   grad_accum: int = 1) -> tuple[torch.Tensor, dict, Any]:
    """(loss, {name: gradient}, per-layer ``dropped_frac`` or None) of
    ``batch``.  With ``grad_accum`` > 1 the batch is split into that many
    microbatches of consecutive rows and their gradients are summed into
    f32 buffers, then divided by ``grad_accum`` (``repro``'s scan); the
    loss and the drops are the microbatches' means.  Nothing is written to
    ``.grad``."""
    params = dict(model.named_parameters())
    leaves = list(params.values())
    if grad_accum == 1:
        loss, grads, drops = _grads_of(model, batch, attn_impl, leaves)
        return loss, dict(zip(params, grads)), drops
    bsz = batch["tokens"].shape[0]
    if grad_accum < 1 or bsz % grad_accum:
        raise ValueError(f"grad_accum {grad_accum} does not divide the "
                         f"batch of {bsz}")
    mb = bsz // grad_accum
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    drops = []
    for i in range(grad_accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss_i, grads, drops_i = _grads_of(model, micro, attn_impl, leaves)
        for a, g in zip(acc, grads):
            a.add_(g.float())
        del grads
        loss = loss + loss_i
        if drops_i is not None:
            drops.append(drops_i)
    for a in acc:
        a.div_(grad_accum)
    return (loss / grad_accum, dict(zip(params, acc)),
            torch.stack(drops).mean(dim=0) if drops else None)


def _clock(state: TrainState) -> float:
    """Host seconds after the state's card, if any, has finished."""
    block_until_ready(state.opt.count)
    return time.perf_counter()


def make_train_step(opt_cfg: AdamWConfig, attn_impl: str = "auto",
                    grad_accum: int = 1,
                    grad_transform: Callable | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, metrics
    ``{"loss", "grad_norm", "lr"}`` (0-d tensors), ``"grad_s"`` (forward +
    backward) and ``"update_s"`` (clip + AdamW), host seconds each ended by
    a device synchronize, and, for a MoE model, ``"dropped_frac"`` per
    layer.

    ``grad_accum`` > 1 splits the batch into microbatches accumulated in
    f32 (:func:`loss_and_grads`); ``grad_transform(grads) -> grads``
    post-processes the gradients (a dict keyed by parameter name).  The
    step updates ``state``'s model and moments in place, and only after
    the loss, the backward and the global norm have all been computed: an
    exception raised before then leaves ``state`` as it was, so a
    :class:`~repro_torch.distributed.fault.StepGuard` can replay the step
    from it.  A fault inside the update itself raises
    :class:`~repro_torch.distributed.fault.UnreplayableStepError`, which
    the guard does not replay.
    """

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        t0 = _clock(state)
        loss, grads, drops = loss_and_grads(state.model, batch, attn_impl,
                                            grad_accum)
        if grad_transform is not None:
            grads = grad_transform(grads)
        t1 = _clock(state)
        params = dict(state.model.named_parameters())
        _, opt, metrics = adamw_update(opt_cfg, grads, state.opt, params)
        del grads
        new_state = TrainState(model=state.model, opt=opt,
                               step=state.step + 1)
        metrics = {"loss": loss, **metrics,
                   "grad_s": t1 - t0, "update_s": _clock(new_state) - t1}
        if drops is not None:
            metrics["dropped_frac"] = drops
        return new_state, metrics

    return train_step


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
