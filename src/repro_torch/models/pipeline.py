"""Pipeline parallelism: the GPipe schedule over the ``"pod"`` axis (the
twin of ``repro.models.pipeline``).

Each stage rank holds ``n_layers / n_stages`` consecutive layers
(:func:`keep_stage_layers`) beside the embedding, the final norm and the
head.  Micro-batch ``t`` lives on rank ``t % n_stages``.  The ticks are
unrolled, as ``repro``'s are: at tick ``t`` micro-batch ``t`` is injected
into stage 0 (sent there by its owner), every stage runs its layers, the
last stage's finished micro-batch is parked on its owner, and every
stage's activation shifts to the next stage (``comm.ppermute``).  Each
stage's layers are checkpointed (``repro``'s ``jax.checkpoint`` of the
scan body).  The gradients of the stage layers flow back through
``ppermute``'s backward (the inverse shift), so each rank's backward
gives its own layers' full gradient; the embedding, the final norm and
the head are summed over the stages.

``repro``'s ``stage_layer_specs`` (the stacked layers sharded over
``"pod"`` with the FSDP and tensor-parallel specs of each layer) waits for
``param_specs``; here the stages cut the layer list by rank.
"""

from __future__ import annotations

import time

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import comm
from repro_torch.models import lm as lm_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.optimizers import global_norm

AXIS = "pod"
# Parameters every stage holds whole; their gradients are summed over the
# stages (each stage's share comes from its own micro-batches).
SHARED = ("embed", "final_norm", "head")


def keep_stage_layers(model: tfm.LM, stage: int, n_stages: int) -> tfm.LM:
    """Drop every layer of ``model`` but stage ``stage``'s ``n_layers /
    n_stages`` consecutive ones (in place; ``model.cfg`` keeps the whole
    model's depth)."""
    n = len(model.layers)
    if n % n_stages:
        raise ValueError(f"{n} layers do not split into {n_stages} stages")
    lps = n // n_stages
    model.layers = nn.ModuleList(model.layers[stage * lps:(stage + 1) * lps])
    return model


def _stage(model: tfm.LM, h: torch.Tensor, positions: torch.Tensor,
           attn_impl: str) -> torch.Tensor:
    """This stage's layers, each checkpointed under grad."""
    for layer in model.layers:
        if torch.is_grad_enabled():
            h, _, _ = checkpoint(layer, h, positions, attn_impl=attn_impl,
                                 use_reentrant=False)
        else:
            h, _, _ = layer(h, positions, attn_impl=attn_impl)
    return h


def _own_rows(x: torch.Tensor, n_stages: int, n_micro: int, stage: int
              ) -> torch.Tensor:
    """This stage's micro-batches of ``x`` [B, ...]: [n_micro / n_stages,
    mb, ...], micro-batch ``j * n_stages + stage`` in slot ``j``."""
    mb = x.shape[0] // n_micro
    return x.reshape(n_micro // n_stages, n_stages, mb,
                     *x.shape[1:])[:, stage]


def pp_local_forward(model: tfm.LM, tokens: torch.Tensor, *, n_stages: int,
                     n_micro: int, attn_impl: str = "auto",
                     mesh: comm.Mesh | None = None) -> torch.Tensor:
    """The pipelined forward on this stage rank: tokens [B, S] (the same
    on every rank) -> the final-normed hidden states of this rank's
    micro-batches, [n_micro / n_stages, B / n_micro, S, D]."""
    mesh = mesh if mesh is not None else comm.get_mesh()
    if mesh is None or mesh.axis_size(AXIS) != n_stages:
        raise ValueError(f"the pipeline needs a mesh whose {AXIS!r} axis "
                         f"has {n_stages} ranks")
    bsz, s = tokens.shape
    if bsz % n_micro or n_micro % n_stages:
        raise ValueError(f"batch {bsz}, {n_micro} micro-batches and "
                         f"{n_stages} stages do not divide")
    mb = bsz // n_micro
    stage = mesh.axis_index(AXIS)
    positions = torch.arange(s, device=tokens.device).expand(mb, s)
    x_stream = F.embedding(_own_rows(tokens, n_stages, n_micro, stage),
                           model.embed)
    shift = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    h = torch.zeros((mb, s, model.cfg.d_model), dtype=x_stream.dtype,
                    device=tokens.device)
    collected = []
    n_ticks = n_micro + n_stages - 1
    for t in range(n_ticks):
        if t < n_micro:
            owner = t % n_stages
            inj = x_stream[t // n_stages]
            if owner != 0:
                inj = comm.ppermute(inj, AXIS, [(owner, 0)], mesh=mesh)
            # Masks, not branches: every rank must keep every ppermute's
            # output in its graph, so that the backward runs the same
            # inverse shifts on every rank (a dropped one leaves its peer
            # waiting).
            m_inj = float(stage == 0)
            h = inj.to(h.dtype) * m_inj + h * (1 - m_inj)
        h = _stage(model, h, positions, attn_impl)
        if t >= n_stages - 1:
            # A finished micro-batch: parked on its owner, zero elsewhere.
            dest = (t - (n_stages - 1)) % n_stages
            out_t = h
            if n_stages - 1 != dest:
                out_t = comm.ppermute(out_t, AXIS, [(n_stages - 1, dest)],
                                      mesh=mesh)
            collected.append(out_t * float(stage == dest))
        if t < n_ticks - 1:
            h = comm.ppermute(h, AXIS, shift, mesh=mesh)
    # Each group of n_stages parked outputs is nonzero on one rank only:
    # slot j holds micro-batch j * n_stages + stage.
    local = torch.stack([sum(collected[j * n_stages:(j + 1) * n_stages])
                         for j in range(n_micro // n_stages)])
    return tfm.rms_norm(local, model.final_norm, model.cfg.norm_eps)


def pp_hidden_forward(model: tfm.LM, tokens: torch.Tensor, *,
                      n_stages: int, n_micro: int, attn_impl: str = "auto",
                      mesh: comm.Mesh | None = None) -> torch.Tensor:
    """The pipelined forward to the final hidden states [B, S, D], whole on
    every stage rank (``model`` holds this stage's layers)."""
    mesh = mesh if mesh is not None else comm.get_mesh()
    local = pp_local_forward(model, tokens, n_stages=n_stages,
                             n_micro=n_micro, attn_impl=attn_impl, mesh=mesh)
    outs = comm.all_gather(local, AXIS, dim=0, mesh=mesh)
    # [n_stages, n_micro / n_stages, mb, S, D], [p, j] = micro-batch
    # j * n_stages + p.
    return outs.transpose(0, 1).reshape(*tokens.shape, -1)


def make_pp_train_step(opt_cfg: AdamWConfig, *, n_stages: int, n_micro: int,
                       attn_impl: str = "auto",
                       mesh: comm.Mesh | None = None):
    """The GPipe train step on this stage rank: ``train_step(state, batch)
    -> (state, metrics)`` with ``state`` a
    :class:`~repro_torch.models.lm.TrainState` of the stage's model.  The
    loss is the mean cross entropy over the whole batch: each rank's share
    from its own micro-batches, summed over the stages for the metric.
    The gradients of the shared parameters are summed over the stages,
    the clip reads the global norm, and AdamW updates in place."""
    mesh = mesh if mesh is not None else comm.get_mesh()

    def train_step(state: lm_lib.TrainState, batch: dict):
        t0 = time.perf_counter()
        model = state.model
        stage = mesh.axis_index(AXIS)
        hidden = pp_local_forward(model, batch["tokens"], n_stages=n_stages,
                                  n_micro=n_micro, attn_impl=attn_impl,
                                  mesh=mesh)
        labels = _own_rows(batch["labels"], n_stages, n_micro, stage)
        rows = labels.shape[0] * labels.shape[1]
        share = lm_lib.chunked_ce(model, hidden.flatten(0, 1),
                                  labels.flatten(0, 1)) * (
            rows / batch["labels"].shape[0])
        params = dict(model.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(share,
                                                     list(params.values()))))
        for name in SHARED:
            if name in grads:
                grads[name] = comm.psum(grads[name], AXIS, mesh=mesh)
        own = {k: g for k, g in grads.items() if k not in SHARED}
        shared = {k: g for k, g in grads.items() if k in SHARED}
        norm = torch.sqrt(comm.psum(global_norm(own) ** 2, AXIS, mesh=mesh)
                          + global_norm(shared) ** 2)
        t1 = time.perf_counter()
        _, opt, metrics = adamw_update(opt_cfg, grads, state.opt, params,
                                       norm=norm)
        loss = comm.psum(share.detach(), AXIS, mesh=mesh)
        new_state = lm_lib.TrainState(model=model, opt=opt,
                                      step=state.step + 1)
        return new_state, {"loss": loss, **metrics, "grad_s": t1 - t0,
                           "update_s": time.perf_counter() - t1}

    return train_step
