"""Pipeline parallelism: the GPipe schedule over the ``"pod"`` axis (the
twin of ``repro.models.pipeline``).

The stages are the ranks of ``"pod"``.  :func:`stage_layer_specs` is
``repro``'s spec tree for it: the stacked layer axis split over ``"pod"``
(each stage rank holds ``n_layers / n_stages`` consecutive layers,
:func:`keep_stage_layers`), ``"pod"`` dropped from every other entry, so
each stage's weights are cut over ``"data"`` and ``"model"`` alone and
the embedding, the final norm and the head are whole across the stages.
On a ``(pod, data, model)`` mesh a stage rank's model is cut by that tree
(:func:`repro_torch.launch.mesh.shard_lm`) and its layer math is the
transformer's: FSDP gathers over ``"data"``, Megatron splits with
sequence-parallel norms over ``"model"``; the batch is split over
``"data"`` only, as ``repro``'s ``lm_pp_cell`` splits it.  A model built
without a mesh runs on a mesh of ``"pod"`` alone, its stage's layers
whole.

Micro-batch ``t`` lives on stage ``t % n_stages``.  The ticks are
unrolled, as ``repro``'s are: at tick ``t`` micro-batch ``t`` is injected
into stage 0 (sent there by its owner), every stage runs its layers, the
last stage's finished micro-batch is parked on its owner, and every
stage's activation (the residual's block on this rank) shifts to the next
stage (``comm.ppermute``).  Each stage's layers are checkpointed
(``repro``'s ``jax.checkpoint`` of the scan body).  Every rank
differentiates its stage's share of the loss over the ranks of its stage;
the gradients of the stage layers flow back through ``ppermute``'s
backward (the inverse shift), and each gradient is then summed over the
axes its stacked spec does not split: the embedding, the final norm and
the head over the stages too, each rank's slice.
"""

from __future__ import annotations

import time
from typing import Any

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec as P
from repro_torch.models import lm as lm_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.optimizers import global_norm, reduce_replicated

AXIS = "pod"


def _drop_pod(entry):
    if isinstance(entry, tuple):
        kept = tuple(a for a in entry if a != AXIS)
        return kept if kept else None
    return entry


def stage_layer_specs(b: tfm.BuiltLM) -> Any:
    """``repro``'s param specs for the pipeline: the stacked layer axis
    split over ``"pod"`` (stages at rest), FSDP restricted to ``"data"``
    (the pod axis is the pipe)."""
    specs = tfm.param_specs(b)

    def repl_pod(spec: P) -> P:
        parts = [_drop_pod(e) for e in spec]
        parts[0] = AXIS   # layer-stack axis -> stage-sharded
        return P(*parts)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return repl_pod(tree)

    specs["layers"] = walk(specs["layers"])
    for k in ("embed", "head", "final_norm"):
        if k in specs:
            specs[k] = P(*(_drop_pod(e) for e in specs[k]))
    return specs


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
           attn_impl: str, sp: bool) -> torch.Tensor:
    """This stage's layers, each checkpointed under grad."""
    for layer in model.layers:
        if torch.is_grad_enabled():
            h, _, _ = checkpoint(layer, h, positions, attn_impl=attn_impl,
                                 sp=sp, use_reentrant=False)
        else:
            h, _, _ = layer(h, positions, attn_impl=attn_impl, sp=sp)
    return h


def _own_rows(x: torch.Tensor, n_stages: int, n_micro: int, stage: int
              ) -> torch.Tensor:
    """This stage's micro-batches of ``x`` [B, ...]: [n_micro / n_stages,
    mb, ...], micro-batch ``j * n_stages + stage`` in slot ``j``."""
    mb = x.shape[0] // n_micro
    return x.reshape(n_micro // n_stages, n_stages, mb,
                     *x.shape[1:])[:, stage]


def _pipe_mesh(model: tfm.LM, mesh, n_stages: int) -> comm.Mesh:
    """The pipeline's mesh: the model's, or (a model without a mesh) a
    mesh of ``"pod"`` alone; its ``"pod"`` axis has ``n_stages`` ranks."""
    mesh = mesh if mesh is not None else (model.mesh or comm.get_mesh())
    if mesh is None or AXIS not in mesh.shape or \
            mesh.axis_size(AXIS) != n_stages:
        raise ValueError(f"the pipeline needs a mesh whose {AXIS!r} axis "
                         f"has {n_stages} ranks")
    if model.mesh is not None and model.mesh is not mesh:
        raise ValueError("the pipeline runs on its stage model's mesh")
    if model.mesh is None and mesh.size != n_stages:
        raise ValueError(f"a model without a mesh runs on a mesh of "
                         f"{AXIS!r} alone, not {mesh.shape}")
    return mesh


def pp_local_forward(model: tfm.LM, tokens: torch.Tensor, *, n_stages: int,
                     n_micro: int, attn_impl: str = "auto",
                     mesh: comm.Mesh | None = None) -> torch.Tensor:
    """The pipelined forward on this stage rank: tokens [B, S] (this
    rank's rows over ``"data"``, the same on every stage) -> the
    final-normed hidden states of this rank's micro-batches,
    [n_micro / n_stages, B / n_micro, S, D]."""
    mesh = _pipe_mesh(model, mesh, n_stages)
    bsz, s = tokens.shape
    if bsz % n_micro or n_micro % n_stages:
        raise ValueError(f"batch {bsz}, {n_micro} micro-batches and "
                         f"{n_stages} stages do not divide")
    mb = bsz // n_micro
    stage = mesh.axis_index(AXIS)
    sp = tfm.seq_parallel(model.mesh, s)
    positions = torch.arange(s, device=tokens.device).expand(mb, s)
    own = _own_rows(tokens, n_stages, n_micro, stage)
    x_stream = model._embed(own.flatten(0, 1), sp).unflatten(
        0, own.shape[:2])
    shift = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    h = torch.zeros(x_stream.shape[1:], dtype=x_stream.dtype,
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
        h = _stage(model, h, positions, attn_impl, sp)
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
    normed = tfm.rms_norm(local.flatten(0, 1), model.final_norm,
                          model.cfg.norm_eps)
    return tfm._from_residual(normed, model.mesh, sp).unflatten(
        0, local.shape[:2])


def pp_hidden_forward(model: tfm.LM, tokens: torch.Tensor, *,
                      n_stages: int, n_micro: int, attn_impl: str = "auto",
                      mesh: comm.Mesh | None = None) -> torch.Tensor:
    """The pipelined forward to the final hidden states [B, S, D] of this
    rank's rows, whole on every stage rank (``model`` holds this stage's
    layers)."""
    mesh = _pipe_mesh(model, mesh, n_stages)
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
    :class:`~repro_torch.models.lm.TrainState` of the stage's model and
    ``batch`` this rank's rows.  The loss is the mean cross entropy over
    the whole batch: each stage's share from its own micro-batches,
    summed over the stages for the metric.  Each rank differentiates its
    share over its stage's ranks; every gradient is summed over the axes
    its :func:`stage_layer_specs` entry does not split, the clip reads
    the global norm, and AdamW updates in place."""

    def train_step(state: lm_lib.TrainState, batch: dict):
        t0 = time.perf_counter()
        model = state.model
        pipe = _pipe_mesh(model, mesh, n_stages)
        stage = pipe.axis_index(AXIS)
        hidden = pp_local_forward(model, batch["tokens"], n_stages=n_stages,
                                  n_micro=n_micro, attn_impl=attn_impl,
                                  mesh=pipe)
        labels = _own_rows(batch["labels"], n_stages, n_micro, stage)
        rows = labels.shape[0] * labels.shape[1]
        share = lm_lib.chunked_ce(model, hidden.flatten(0, 1),
                                  labels.flatten(0, 1)) * (
            rows / batch["labels"].shape[0])
        params = dict(model.named_parameters())
        # Every rank of a stage holds its whole share: their mean is the
        # stage's objective.
        seed = torch.full_like(share, n_stages / pipe.size)
        grads = dict(zip(params, torch.autograd.grad(
            share, list(params.values()), grad_outputs=seed)))
        specs = tfm.named_param_specs(model.b, stage_layer_specs(model.b),
                                      stacked=True)
        specs = {k: specs[k] for k in grads}
        grads = reduce_replicated(grads, specs, pipe)
        norm = global_norm(grads, specs, pipe)
        t1 = time.perf_counter()
        _, opt, metrics = adamw_update(opt_cfg, grads, state.opt, params,
                                       norm=norm)
        loss = comm.psum(share.detach(), AXIS, mesh=pipe)
        new_state = lm_lib.TrainState(model=model, opt=opt,
                                      step=state.step + 1)
        return new_state, {"loss": loss, **metrics, "grad_s": t1 - t0,
                           "update_s": time.perf_counter() - t1}

    return train_step
