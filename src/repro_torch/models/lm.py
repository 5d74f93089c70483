"""LM task heads (``repro.models.lm``): the loss and the train step, then
the serving heads (batched prefill into a KV cache, greedy decode).

The port's functions take the :class:`~repro_torch.models.transformer.LM`
module where ``repro``'s take a param tree and a ``BuiltLM``: the module
carries its ``BuiltLM`` (``model.b``) and, on several ranks, its mesh
(``model.mesh``), under whose :func:`~repro_torch.distributed.comm.mesh_scope`
the steps run.  A :class:`TrainState` holds the module itself, AdamW's f32
moments keyed by parameter name and the step.  :func:`train_state_tree`
gives the state as ``repro``'s ``TrainState`` pytree (layer parameters
stacked ``[L, ...]`` through :class:`~repro_torch.checkpoint.Stacked`),
the order in which checkpoints and :mod:`repro_torch.interop` carry it.

On a mesh each rank takes its rows of the batch (the data axes) and holds
its slices of the parameters and of the vocabulary: the cross entropy
reduces its max and its sum of exponentials over ``model`` and its total
over the data axes, the greedy pick takes the first index of the largest
logit over ``model`` (``jnp.argmax``'s tie rule), and the train step
differentiates ``loss / world size`` on every rank (the collectives'
transposes carry the rest), sums each gradient over the axes its
parameter is replicated on and clips by the norm summed over shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.checkpointer import Stacked
from repro_torch.configs import LMConfig
from repro_torch.distributed import comm
from repro_torch.distributed.fault import block_until_ready
from repro_torch.models import kvcache
from repro_torch.models import transformer as tfm
from repro_torch.models.common import TP, mesh_axes, mesh_sizes
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update, global_norm)
from repro_torch.optim import reduce_replicated as optim_reduce_replicated


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
    n = len(state.model.layers)    # a pipeline stage holds its own
    params = {k: p.detach() for k, p in state.model.named_parameters()}
    return [_repro_tree(params, n),
            [_repro_tree(state.opt.mu, n), _repro_tree(state.opt.nu, n),
             state.opt.count],
            state.step]


def train_state_template(cfg: LMConfig | tfm.BuiltLM) -> list:
    """:func:`train_state_tree` of a state on the ``meta`` device: shapes
    and dtypes without memory, the template a checkpoint restores into."""
    return train_state_tree(init_train_state(tfm.LM(cfg, device="meta")))


def train_state_from_tree(cfg: LMConfig | tfm.BuiltLM, tree: list
                          ) -> TrainState:
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
    """The head's width: the vocabulary padded to ``tp``."""
    return model.b.vocab_p


def _scope(model: tfm.LM):
    """The model's mesh as the ambient mesh, or nothing."""
    return comm.mesh_scope(model.mesh) if model.mesh is not None \
        else contextlib.nullcontext()


def _padded_vocab(model: tfm.LM, logits: torch.Tensor, fill: float
                  ) -> torch.Tensor:
    """``logits`` (this rank's vocabulary slice) with the padded entries
    set to ``fill``."""
    if model.b.vocab_p == model.cfg.vocab:
        return logits
    cols = model.vocab_offset() + torch.arange(logits.shape[-1],
                                               device=logits.device)
    return logits.masked_fill(cols >= model.cfg.vocab, fill)


def _chunk_ce(model: tfm.LM, h: torch.Tensor, lab: torch.Tensor
              ) -> torch.Tensor:
    logits = _padded_vocab(model, model.unembed(h), -1e30)
    tp = mesh_axes(model.mesh, TP)
    if not tp:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lab[..., None].long())[..., 0]
        return (logz - gold).sum()
    # The vocabulary split over ``model``: max and sum of exponentials
    # reduced across it, the gold logit from the rank that holds it.
    mesh, v_loc = model.mesh, logits.shape[-1]
    m = comm.pmax(logits.amax(dim=-1), tp, mesh=mesh)
    total = comm.psum(torch.exp(logits - m[..., None]).sum(dim=-1), tp,
                      mesh=mesh)
    rel = lab.long() - model.vocab_offset()
    inside = (rel >= 0) & (rel < v_loc)
    gold = logits.gather(-1, rel.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = comm.psum(torch.where(inside, gold, torch.zeros_like(gold)), tp,
                     mesh=mesh)
    return (m + torch.log(total) - gold).sum()


def chunked_ce(model: tfm.LM, hidden: torch.Tensor, labels: torch.Tensor,
               chunk: int = 512) -> torch.Tensor:
    """Mean cross entropy without materializing [B, S, vocab] logits: the
    sequence in chunks of ``chunk`` positions (halved until it divides S),
    each chunk's f32 logits recomputed in the backward pass
    (``torch.utils.checkpoint``), so live memory is O(B·chunk·vocab).  The
    padded vocabulary is masked to -1e30.  On a mesh ``hidden`` and
    ``labels`` are this rank's rows, and the mean is over every rank's."""
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
    data = model.data_axes
    if data:
        total = comm.psum(total, data, mesh=model.mesh)
        bsz *= model.mesh.axis_size(data)
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
    seed = None
    if model.mesh is not None:
        # Every rank holds the whole loss: the objective is their mean.
        seed = torch.full_like(loss, 1.0 / model.mesh.size)
    grads = torch.autograd.grad(loss, leaves, grad_outputs=seed)
    return loss.detach(), grads, (torch.stack(drops) if drops else None)


def reduce_replicated(model: tfm.LM, grads: dict) -> dict:
    """Each gradient summed over the mesh axes its parameter is replicated
    on (those its spec does not split): every rank then holds the whole
    model's gradient of its slice (:func:`repro_torch.optim.
    reduce_replicated`, whose order of ``psum`` s follows the parameters',
    the same on every rank)."""
    if model.mesh is None:
        return grads
    specs = model.named_specs(stacked=True)
    out = optim_reduce_replicated(grads, {n: specs[n] for n in grads},
                                  model.mesh)
    return {n: out[n] for n in grads}


def grad_norm(model: tfm.LM, grads: dict) -> torch.Tensor:
    """The global norm of ``grads`` (:func:`reduce_replicated`'s): on a
    mesh each leaf's square-sum is summed over the axes its spec splits,
    a replicated leaf counted once."""
    if model.mesh is None:
        return global_norm(grads)
    specs = model.named_specs(stacked=True)
    return global_norm(grads, {n: specs[n] for n in grads}, model.mesh)


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
        return loss, reduce_replicated(model, dict(zip(params, grads))), \
            drops
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
    return (loss / grad_accum,
            reduce_replicated(model, dict(zip(params, acc))),
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
    post-processes the gradients (a dict keyed by parameter name).  On a
    mesh ``batch`` is this rank's rows, and the step runs under the
    model's mesh.  The
    step updates ``state``'s model and moments in place, and only after
    the loss, the backward and the global norm have all been computed: an
    exception raised before then leaves ``state`` as it was, so a
    :class:`~repro_torch.distributed.fault.StepGuard` can replay the step
    from it.  A fault inside the update itself raises
    :class:`~repro_torch.distributed.fault.UnreplayableStepError`, which
    the guard does not replay.
    """

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        with _scope(state.model):
            return step(state, batch)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        t0 = _clock(state)
        loss, grads, drops = loss_and_grads(state.model, batch, attn_impl,
                                            grad_accum)
        if grad_transform is not None:
            grads = grad_transform(grads)
        norm = grad_norm(state.model, grads) if state.model.mesh is not None \
            else None
        t1 = _clock(state)
        params = dict(state.model.named_parameters())
        _, opt, metrics = adamw_update(opt_cfg, grads, state.opt, params,
                                       norm=norm)
        del grads
        new_state = TrainState(model=state.model, opt=opt,
                               step=state.step + 1)
        metrics = {"loss": loss, **metrics,
                   "grad_s": t1 - t0, "update_s": _clock(new_state) - t1}
        if drops is not None:
            metrics["dropped_frac"] = drops
        return new_state, metrics

    return train_step


def gather_vocab(model: tfm.LM, logits: torch.Tensor) -> torch.Tensor:
    """Logits over this rank's vocabulary slice -> over the whole padded
    vocabulary (all-gathered over ``model``)."""
    tp = mesh_axes(model.mesh, TP)
    if not tp:
        return logits
    return comm.all_gather(logits, tp, dim=-1, tiled=True, mesh=model.mesh)


def greedy_token(model: tfm.LM, logits: torch.Tensor) -> torch.Tensor:
    """The greedy pick of f32 ``logits`` [B, V] (this rank's vocabulary
    slice on a mesh): the first index of the largest real logit, as
    ``jnp.argmax(logits[:, :vocab])``; over ``model`` the largest value's
    ``pmax``, then the least index that holds it (``pmin``).  [B] int64."""
    logits = _padded_vocab(model, logits, float("-inf"))
    idx = logits.argmax(dim=-1)
    val = logits.gather(-1, idx[:, None])[:, 0]
    idx = idx + model.vocab_offset()
    tp = mesh_axes(model.mesh, TP)
    if not tp:
        return idx
    top = comm.pmax(val, tp, mesh=model.mesh)
    cand = torch.where(val == top, idx, torch.full_like(idx, 2 ** 62))
    return comm.pmin(cand, tp, mesh=model.mesh)


def make_prefill_step(attn_impl: str = "auto"):
    """prefill(model, tokens [B, S]) -> (logits_last f32 [B, vocab_p],
    cache {"k", "v": [L, B, S, Hkv, Dh], "pos": S}).  On a mesh ``tokens``
    are this rank's rows, the logits are gathered over the vocabulary and
    the cache holds this rank's KV heads (:func:`grow_cache` turns it into
    the decode layout)."""

    @torch.no_grad()
    def prefill(model: tfm.LM, tokens: torch.Tensor):
        with _scope(model):
            hidden, (k, v), _ = model(tokens, return_cache=True,
                                      attn_impl=attn_impl)
            logits_last = gather_vocab(model, model.unembed(hidden[:, -1]))
        return logits_last, {"k": k, "v": v, "pos": tokens.shape[1]}

    return prefill


def make_decode_step(attn_impl: str = "auto", seq_axes=TP):
    """decode(model, cache, tokens [B, 1]) -> (next_token [B, 1], cache):
    one step of greedy decode (:func:`greedy_token`); the cache is updated
    in place.  On a mesh the cache's sequence is split over ``seq_axes``
    (:func:`~repro_torch.models.transformer.decode_layout`)."""

    @torch.no_grad()
    def decode(model: tfm.LM, cache: dict, tokens: torch.Tensor):
        with _scope(model):
            logits, cache = model.decode_step(cache, tokens, attn_impl,
                                              seq_axes)
            next_tok = greedy_token(model, logits[:, -1])
        return next_tok[:, None], cache

    return decode


def _decode_layout(b: tfm.BuiltLM, t: torch.Tensor, max_seq: int, mesh
                   ) -> tuple[torch.Tensor, int]:
    """A prefill's cache tensor [L, B, S, H, Dh] -> (its positions of a
    ``max_seq`` cache in :func:`~repro_torch.models.transformer.cache_specs`'
    decode layout, with every KV head and zeros past S; how many of them
    are filled).  Without a mesh, the whole cache."""
    s = t.shape[2]
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} < cached positions {s}")
    tp = mesh_axes(mesh, TP)
    if tp and t.shape[3] < b.n_kv_heads_p:
        t = comm.all_gather(t, tp, dim=3, tiled=True, mesh=mesh)
    n = mesh_sizes(mesh)[1]
    if max_seq % n:
        raise ValueError(f"max_seq {max_seq} does not split over {n} "
                         f"ranks of 'model'")
    c = max_seq // n
    lo = mesh.axis_index(tp) * c if tp else 0
    out = t.new_zeros((*t.shape[:2], c, *t.shape[3:]))
    filled = max(0, min(s, lo + c) - lo)
    out[:, :, :filled] = t[:, :, lo:lo + filled]
    return out, filled


def grow_cache(cfg: LMConfig | tfm.BuiltLM, cache: dict, max_seq: int,
               mesh=None) -> dict:
    """The prefill's cache copied into a zero cache of ``max_seq``
    positions (``repro``'s serve pads it the same way).  On ``mesh`` the
    result is this rank's positions with every KV head
    (``cache_specs(b)``), from a prefill cache of this rank's KV heads."""
    b = tfm.as_built(cfg)
    return {"k": _decode_layout(b, cache["k"], max_seq, mesh)[0],
            "v": _decode_layout(b, cache["v"], max_seq, mesh)[0],
            "pos": cache["pos"]}


def quantize_cache(cfg: LMConfig | tfm.BuiltLM, cache: dict, max_seq: int,
                   mesh=None) -> dict:
    """The prefill's cache quantized into an int8 cache of ``max_seq``
    positions (:func:`~repro_torch.models.kvcache.quantize_kv` of each
    filled position; zero codes and scales past them, as
    ``init_cache_quant``'s).  On ``mesh``, this rank's positions."""
    b = tfm.as_built(cfg)
    out = {"pos": cache["pos"]}
    for src in ("k", "v"):
        t, filled = _decode_layout(b, cache[src], max_seq, mesh)
        q, scale = kvcache.quantize_kv(t[:, :, :filled])
        codes = torch.zeros(t.shape, dtype=torch.int8, device=t.device)
        scales = torch.zeros((*t.shape[:-1], 1), device=t.device)
        codes[:, :, :filled], scales[:, :, :filled] = q, scale
        out[f"{src}_q"], out[f"{src}_s"] = codes, scales
    return out
