"""Cell catalog: every (architecture x input shape) pair as one callable
unit on one card, the twin of ``repro.launch.cells``.

A :class:`Cell` holds the step function ``repro``'s cell lowers (the same
``attn_impl``, the same AdamW step, ``mp_dtype="bfloat16"`` for the GNNs,
``top_k=100`` retrieval, the same DKS superstep) and builds its arguments
with :meth:`Cell.build`: on ``meta`` they hold no memory (the dry run
counts them with :mod:`repro_torch.analysis.count`); on the card they hold
random content from a seeded generator.  The arguments are ``repro``'s
cell's, leaf for leaf at ``tp=1`` (``tests/test_torch_accounting.py``):
the port's own layouts (int64 edge indices, a lane axis on the DKS state,
the LM as a module) are made inside the step, where their cost is
counted.

By default the catalog runs on one card: ``tp`` is 1 and the
grad-accumulation rule divides activations by the card count (1).  On a
``mesh``, a :class:`~repro_torch.distributed.comm.Mesh` of which this
process is one rank, or a
:class:`~repro_torch.distributed.comm.CountingMesh` that stands for
``repro``'s 256- or 512-chip production mesh on ``meta``
(:func:`mesh_cells`, ``repro``'s ``iter_cells``), :meth:`Cell.build`
builds this rank's slice of each argument by ``repro``'s in-specs (the
whole argument drawn from the generator, as every rank draws it, and cut
by :func:`~repro_torch.launch.mesh.shard_tree`; on ``meta``, of the
shape ``comm.local_shape`` gives), and the step runs the sharded
program: the LMs built at ``tp`` (16 on the production meshes) with the
transformer's Megatron / FSDP splits, the batch's rows over the data
axes, a decode cache in ``repro``'s layout (``decode_layout``), and the
grad-accumulation rule divided by 256 as ``repro``'s; :func:`lm_pp_cell`
with ``pipeline.stage_layer_specs`` on the multi-pod mesh; DCN-v2's
tables split by ``recsys.param_specs`` with the grouped kernel on each
rank's rows; the GNNs' nodes and edges split over every axis; the
frontier DKS cells one shard a rank; the dense DKS cell's edges and node
rows over the data axes and its keyword sets over ``model``
(:func:`~repro_torch.core.dks.mesh_superstep`).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import INF
from repro_torch.analysis import count
from repro_torch.analysis import roofline as rl
from repro_torch.configs import (DKS_CONFIGS, GNN_SHAPES, LM_SHAPES,
                                 RECSYS_SHAPES, get_arch)
from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec as P
from repro_torch.distributed.fault import block_until_ready
from repro_torch.models.common import ALL, DP, TP, mesh_axes
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update, tree_map)

CARDS = 1
MESH_CARDS = 256        # repro's divisor of the rule on either mesh
# repro's catalog, in its order: (arch, family).
CATALOG = (
    ("qwen1.5-4b", "lm"), ("chatglm3-6b", "lm"),
    ("command-r-plus-104b", "lm"), ("dbrx-132b", "lm"),
    ("granite-moe-3b-a800m", "lm"), ("gat-cora", "gnn"), ("schnet", "gnn"),
    ("gin-tu", "gnn"), ("pna", "gnn"), ("dcn-v2", "recsys"))
SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}
DKS_SHARDS = 4          # the frontier cells' shards, all on the one card

Build = Callable[[torch.device, "torch.Generator | None"],
                 tuple[Callable, tuple]]


def pad_to(x: int, m: int) -> int:
    return int(-(-x // m) * m)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    build: Build             # (device, generator or None on meta) -> (fn, args)
    model_flops: float = 0.0
    notes: str = ""

    @property
    def name(self) -> str:
        return f"{self.arch_id}__{self.shape_name}"


@dataclasses.dataclass
class ParamState:
    """``repro``'s ``TrainState`` for a plain parameter tree (GNN, DCN-v2):
    parameters, AdamW's state and the int32 step."""

    params: Any
    opt: OptState
    step: torch.Tensor


def _ints(shape, high: int, device, generator) -> torch.Tensor:
    """int32 ``shape``: uniform in [0, high) on a card, empty on meta."""
    if generator is None:
        return torch.empty(shape, dtype=torch.int32, device=device)
    return torch.randint(0, max(high, 1), shape, generator=generator,
                         device=device, dtype=torch.int32)


def _normal(shape, device, generator, dtype=torch.float32) -> torch.Tensor:
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=generator, device=device).to(dtype)


def _param_state(params, device) -> ParamState:
    return ParamState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _scalars(metrics: dict) -> dict:
    return {k: metrics[k] for k in ("loss", "grad_norm", "lr")}


def _local(tree, specs, mesh):
    """This rank's slice of every leaf of ``tree`` by ``specs`` (the tree
    itself without a mesh), of the shape ``comm.local_shape`` gives: cut
    from the whole leaf, which every rank builds alike."""
    if mesh is None:
        return tree
    from repro_torch.launch.mesh import shard_tree

    return shard_tree(tree, specs, mesh)


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------


def lm_grad_accum(cfg, shape, cards: int = CARDS) -> int:
    """``repro``'s activation-memory rule over ``cards`` cards (one, or
    :data:`MESH_CARDS` on either production mesh, as ``repro`` divides by
    its 256 chips): double the accumulation until a micro-batch's saved
    layer inputs fit the budget (2 GB, 0.5 GB past 50 B parameters)."""
    tokens = shape.seq_len * shape.global_batch
    act_bytes = tokens * cfg.d_model * 2 * cfg.n_layers  # saved layer inputs
    per_card = act_bytes / cards
    budget = 0.5e9 if cfg.param_count_analytic() > 5e10 else 2e9
    accum = 1
    while per_card / accum > budget and accum < shape.global_batch:
        accum *= 2
    return accum


def _clock(t: torch.Tensor) -> float:
    """Host seconds after ``t``'s card, if any, has finished."""
    block_until_ready(t)
    return time.perf_counter()


def folded_train_step(opt_cfg: AdamWConfig, attn_impl: str, trips: int):
    """``make_train_step(opt_cfg, attn_impl, grad_accum=trips)`` folded
    for a count: it runs the first of the ``trips`` micro-batches,
    counted ``trips`` times (:func:`count.scaled`), then the f32 mean and
    the AdamW update once.  Its gradients are that one micro-batch's over
    ``trips``, so the state it leaves is not the step's: the dry run
    counts and times it, nothing trains with it.  ``grad_s`` runs to the
    mean's end (the buffers' zeros, one micro-batch's forward and
    backward, the mean), ``update_s`` is the update's; the dry run's time
    is ``grad_s`` x ``trips`` + ``update_s``, which counts the buffers'
    two f32 passes ``trips`` times (a few ms each)."""
    from repro_torch.models import lm as lm_lib

    def step(state, batch):
        model = state.model
        params = dict(model.named_parameters())
        t0 = _clock(state.step)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params.values()]
        mb = batch["tokens"].shape[0] // trips
        with lm_lib._scope(model), count.scaled(trips):
            loss, grads, _ = lm_lib.loss_and_grads(
                model, {k: v[:mb] for k, v in batch.items()}, attn_impl)
            for a, g in zip(acc, grads.values()):
                a.add_(g.float())
            del grads
        for a in acc:
            a.div_(trips)
        grads = dict(zip(params, acc))
        with lm_lib._scope(model):
            norm = (lm_lib.grad_norm(model, grads) if model.mesh is not None
                    else None)
        t1 = _clock(acc[0])
        _, opt, metrics = adamw_update(opt_cfg, grads, state.opt, params,
                                       norm=norm)
        new = lm_lib.TrainState(model=model, opt=opt, step=state.step + 1)
        return new, {"loss": loss, **metrics, "grad_s": t1 - t0,
                     "update_s": _clock(new.step) - t1}

    return step


def _lm_model(b, device, generator, mesh=None, specs=None):
    """An LM at the padded widths of ``b``: allocated on ``meta``
    (``generator`` None), else drawn whole by ``init_lm``; on ``mesh``
    this rank's slice by the spec tree ``specs`` (default
    ``param_specs``)."""
    from repro_torch.launch.mesh import shard_lm
    from repro_torch.models import transformer as tfm

    if generator is None:
        return tfm.LM(b, device=device, mesh=mesh, specs=specs)
    model = tfm.init_lm(b, generator)
    return shard_lm(model, mesh, specs) if mesh is not None else model


def _rows(shape, high: int, spec, mesh, device, generator) -> torch.Tensor:
    """int32 ``shape`` cut by ``spec`` over ``mesh``: on ``meta`` made at
    the slice's shape, else drawn whole (every rank alike) and cut."""
    if generator is None:
        return _ints(comm.local_shape(shape, spec, comm.axis_sizes(mesh)),
                     high, device, None)
    return _local(_ints(shape, high, device, generator), spec, mesh)


def _lm_train_fn(step):
    """A train cell's function: ``step``'s new state and its scalars."""
    def fn(state, batch):
        new, metrics = step(state, batch)
        return new, {k: metrics[k] for k in (
            "loss", "grad_norm", "lr", "grad_s", "update_s")}

    return fn


def _lm_train_state(model, device):
    """``model``'s train state with ``repro``'s int32 step."""
    from repro_torch.models import lm as lm_lib

    state = lm_lib.init_train_state(model)
    state.step = torch.zeros((), dtype=torch.int32, device=device)
    return state


def _train_batch(cfg, shape, spec, mesh, device, generator) -> dict:
    b, s = shape.global_batch, shape.seq_len
    return {k: _rows((b, s), cfg.vocab, spec, mesh, device, generator)
            for k in ("tokens", "labels")}


def _accum(cfg, shape, spec, mesh) -> tuple[int, str]:
    """(the train cell's accumulation, its note): ``repro``'s rule over
    the cards, at most the rows a rank holds on a mesh (a micro-batch of
    at least one row each).  Past them (command-r's 16 on the multi-pod
    mesh, whose ranks hold 8 rows) a rank's program could hold ``repro``'s
    micro-batches only with padded rows; its rows folded one a micro-batch
    give the same mean gradient over the same rows, and the note leads
    with the count folded."""
    want = lm_grad_accum(cfg, shape, MESH_CARDS if mesh is not None
                         else CARDS)
    accum, note = want, f"grad_accum={want}"
    if mesh is not None:
        rows = comm.local_shape((shape.global_batch,), P(spec),
                                comm.axis_sizes(mesh))[0]
        if want > rows:
            accum = rows
            return accum, (f"grad_accum={rows} folded (repro's rule: "
                           f"{want}; a rank holds {rows} of the "
                           f"{shape.global_batch} rows)")
    return accum, note + (", folded" if accum > 1 else "")


def lm_cell(arch_id: str, shape, tp: int = 1,
            mesh: "comm.Mesh | None" = None) -> Cell:
    """``repro``'s LM cell built at ``tp``; on a ``mesh``, one rank of it:
    the model and AdamW's state cut by ``param_specs``, the batch's rows
    over the data axes, and a decode cache in ``decode_layout``'s layout
    (the sequence over ``model``, or over ``("data", "model")`` with the
    batch whole below 32 sequences)."""
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import transformer as tfm

    cfg = get_arch(arch_id)
    built = tfm.build(cfg, tp)
    mf = rl.model_flops_lm(cfg, shape)
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        accum, note = _accum(cfg, shape, DP, mesh)
        attn = "flash_jax" if s > 2048 else "naive"

        fn = _lm_train_fn(
            folded_train_step(AdamWConfig(), attn, accum) if accum > 1
            else lm_lib.make_train_step(AdamWConfig(), attn_impl=attn))

        def build(device, generator=None):
            state = _lm_train_state(_lm_model(built, device, generator, mesh),
                                    device)
            return fn, (state, _train_batch(cfg, shape, P(DP, None), mesh,
                                            device, generator))

        return Cell(arch_id, shape.name, "train", build, mf, notes=note)

    if shape.kind == "prefill":
        def build(device, generator=None):
            return (lm_lib.make_prefill_step(attn_impl="flash_jax"),
                    (_lm_model(built, device, generator, mesh),
                     _rows((b, s), cfg.vocab, P(DP, None), mesh, device,
                           generator)))

        return Cell(arch_id, shape.name, "prefill", build, mf)

    batch_axes, seq_axes = tfm.decode_layout(b)

    def build(device, generator=None):
        # One new token against a seq_len KV cache, as repro's cell.
        cache = tfm.init_cache(built, b, s, device=device, mesh=mesh,
                               seq_axes=seq_axes, batch_axes=batch_axes)
        return (lm_lib.make_decode_step(attn_impl="naive",
                                        seq_axes=seq_axes),
                (_lm_model(built, device, generator, mesh), cache,
                 _rows((b, 1), cfg.vocab, P(batch_axes, None), mesh, device,
                       generator)))

    return Cell(arch_id, shape.name, "decode", build, mf)


def lm_pp_cell(arch_id: str, shape_name: str = "train_4k", tp: int = 16,
               n_stages: int = 2, n_micro: int = 16,
               mesh: "comm.Mesh | None" = None) -> Cell:
    """``repro``'s pipeline-parallel train cell on one rank of ``mesh``
    (which has ``"pod"``: the multi-pod mesh): the GPipe step
    (:mod:`repro_torch.models.pipeline`) on this stage's layers, the
    model and AdamW's state cut by ``stage_layer_specs``, the batch's
    rows over ``"data"``."""
    from repro_torch.models import pipeline as pp
    from repro_torch.models import transformer as tfm

    if mesh is None or mesh.shape.get(pp.AXIS) != n_stages:
        raise ValueError(f"lm_pp_cell runs on a mesh whose {pp.AXIS!r} "
                         f"axis has {n_stages} ranks")
    cfg = get_arch(arch_id)
    shape = next(x for x in LM_SHAPES if x.name == shape_name)
    built = tfm.build(cfg, tp)
    specs = pp.stage_layer_specs(built)
    fn = _lm_train_fn(pp.make_pp_train_step(
        AdamWConfig(), n_stages=n_stages, n_micro=n_micro,
        attn_impl="flash_jax", mesh=mesh))

    def build(device, generator=None):
        model = pp.keep_stage_layers(
            _lm_model(built, device, generator, mesh, specs),
            mesh.axis_index(pp.AXIS), n_stages)
        return fn, (_lm_train_state(model, device),
                    _train_batch(cfg, shape, P(("data",), None), mesh,
                                 device, generator))

    return Cell(arch_id, f"{shape_name}_pp{n_stages}", "train", build,
                rl.model_flops_lm(cfg, shape),
                notes=f"GPipe n_stages={n_stages} n_micro={n_micro}")


def lm_decode_quant_cell(arch_id: str, shape_name: str) -> Cell:
    """The decode cell with the int8 KV cache (``LM.decode_step_quant``)."""
    from repro_torch.models import kvcache

    cfg = get_arch(arch_id)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    b, s = shape.global_batch, shape.seq_len

    def fn(model, cache, tokens):
        logits, cache = model.decode_step_quant(cache, tokens)
        nxt = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
        return nxt.to(torch.int32)[:, None], cache

    def build(device, generator=None):
        cache = kvcache.init_cache_quant(cfg, b, s, device=device)
        return fn, (_lm_model(cfg, device, generator), cache,
                    _ints((b, 1), cfg.vocab, device, generator))

    return Cell(arch_id, f"{shape_name}_int8kv", "decode", build,
                rl.model_flops_lm(cfg, shape), notes="int8 KV cache")


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------


def gnn_sizes(shape) -> tuple[int, int, int]:
    """(nodes, edges, graphs) of a GNN shape, as ``repro``'s cell sizes
    them (a minibatch shape: its fanout sample's padded size)."""
    if shape.kind == "minibatch":
        from repro_torch.graph.sampler import plan_sizes
        n_nodes, n_edges = plan_sizes(shape.batch_nodes, list(shape.fanout))
        return n_nodes, n_edges, 1
    if shape.kind == "molecule":
        return (shape.n_nodes * shape.batch_graphs,
                shape.n_edges * shape.batch_graphs, shape.batch_graphs)
    return shape.n_nodes, shape.n_edges, 1


def gnn_batch_specs(label_len: int, n_graphs: int):
    """``repro``'s ``gnn_cell`` layout: nodes and edges split over every
    axis, the labels too when there are at least 4,096 of them."""
    from repro_torch.models.gnn import GraphBatch

    return GraphBatch(
        x=P(ALL, None), edge_src=P(ALL), edge_dst=P(ALL), node_mask=P(ALL),
        edge_mask=P(ALL), labels=P(None) if label_len < 4096 else P(ALL),
        graph_ids=P(ALL), positions=P(ALL, None), n_graphs=n_graphs)


def gnn_cell(arch_id: str, shape, mesh_divisor: int = 512,
             mesh: "comm.Mesh | None" = None) -> Cell:
    """``repro``'s GNN train cell; on a ``mesh``, one rank of it: the
    batch cut by :func:`gnn_batch_specs`, the parameters and AdamW's
    state whole."""
    from repro_torch.models import gnn as gnn_lib

    # repro's production cells pass messages in bf16.
    cfg = dataclasses.replace(get_arch(arch_id), mp_dtype="bfloat16")
    n_nodes, n_edges, n_graphs = gnn_sizes(shape)
    n_pad = pad_to(n_nodes, mesh_divisor)
    e_pad = pad_to(n_edges, mesh_divisor)
    d_feat = max(shape.d_feat, 1)
    graph_level = n_graphs > 1
    label_len = max(n_graphs if (graph_level or cfg.family == "schnet")
                    else n_pad, 1)
    opt_cfg = AdamWConfig()

    def fn(state, batch):
        # The port's GraphBatch indexes in int64 (torch's gather and
        # scatter take int64 indices): converted here, and counted.
        b64 = dataclasses.replace(
            batch, edge_src=batch.edge_src.long(),
            edge_dst=batch.edge_dst.long(), graph_ids=batch.graph_ids.long())
        params, opt, metrics = gnn_lib.gnn_train_step(
            state.params, state.opt, b64, cfg, opt_cfg, mesh)
        return ParamState(params, opt, state.step + 1), _scalars(metrics)

    def build(device, generator=None):
        if generator is None:
            # The initialisers draw on their generator's device: shapes
            # from a CPU draw (the GNNs' parameters are small).
            cpu = gnn_lib.init_gnn(torch.Generator("cpu").manual_seed(0),
                                   cfg, d_feat)
            params = tree_map(lambda p: torch.empty_like(p, device=device),
                              cpu)
        else:
            params = gnn_lib.init_gnn(generator, cfg, d_feat)
        node = torch.arange(n_pad, device=device)
        edge = torch.arange(e_pad, device=device)
        per_graph = max(n_nodes // n_graphs, 1)
        if cfg.family == "schnet":
            labels = _normal((label_len,), device, generator)
        else:
            labels = _ints((label_len,), cfg.n_classes, device, generator)
        batch = gnn_lib.GraphBatch(
            x=_normal((n_pad, d_feat), device, generator),
            edge_src=_ints((e_pad,), n_nodes, device, generator),
            edge_dst=_ints((e_pad,), n_nodes, device, generator),
            node_mask=node < n_nodes, edge_mask=edge < n_edges,
            labels=labels,
            graph_ids=torch.clamp(node // per_graph, max=n_graphs - 1
                                  ).to(torch.int32),
            positions=_normal((n_pad, 3), device, generator),
            n_graphs=n_graphs)
        if mesh is not None:
            specs = gnn_batch_specs(label_len, n_graphs)
            batch = dataclasses.replace(batch, **{
                f.name: _local(getattr(batch, f.name), getattr(specs, f.name),
                               mesh)
                for f in dataclasses.fields(batch) if f.name != "n_graphs"})
        return fn, (_param_state(params, device), batch)

    return Cell(arch_id, shape.name, "gnn_train", build,
                rl.model_flops_gnn(cfg, shape, n_nodes, n_edges),
                notes=f"n_pad={n_pad} e_pad={e_pad}")


# --------------------------------------------------------------------------
# Recsys cells
# --------------------------------------------------------------------------


def _dcn_params(cfg, device, generator) -> dict:
    from repro_torch.models import recsys as rec_lib

    if generator is not None:
        return rec_lib.init_dcn(cfg, generator)

    def empties(tree):
        if isinstance(tree, dict):
            return {key: empties(sub) for key, sub in tree.items()}
        if isinstance(tree, list):
            return [empties(sub) for sub in tree]
        return torch.empty(tree, device=device)      # a shape tuple

    return empties(rec_lib.param_shapes(cfg))


def _dcn_inputs(cfg, batch: int, device, generator):
    """Dense features and sparse ids, each field's ids uniform over its
    vocabulary."""
    if generator is None:
        sparse = _ints((batch, cfg.n_sparse), 1, device, None)
    else:
        high = torch.tensor(cfg.vocab_sizes, device=device)
        sparse = (torch.rand((batch, cfg.n_sparse), generator=generator,
                             device=device) * high).to(torch.int32)
    return _normal((batch, cfg.n_dense), device, generator), sparse


def recsys_cell(arch_id: str, shape,
                mesh: "comm.Mesh | None" = None) -> Cell:
    """``repro``'s DCN-v2 cell; on a ``mesh``, one rank of it: the
    parameters (and AdamW's state) cut by ``recsys.param_specs``, the
    batch split over the data axes, retrieval's query whole and its
    candidates split over every axis."""
    from repro_torch.launch.train import make_recsys_step
    from repro_torch.models import recsys as rec_lib

    cfg = get_arch(arch_id)
    mf = rl.model_flops_recsys(cfg, shape)
    pspec = rec_lib.param_specs(cfg)

    def params_of(device, generator):
        return _local(_dcn_params(cfg, device, generator), pspec, mesh)

    def rows(x):
        return _local(x, P(DP, *([None] * (x.dim() - 1))), mesh)

    if shape.kind == "train":
        step = make_recsys_step(cfg, AdamWConfig(), mesh=mesh)

        def fn(state, batch):
            (params, opt), metrics = step((state.params, state.opt), batch)
            return ParamState(params, opt, state.step + 1), _scalars(metrics)

        def build(device, generator=None):
            dense, sparse = _dcn_inputs(cfg, shape.batch, device, generator)
            batch = {"dense": dense, "sparse": sparse,
                     "label": _ints((shape.batch,), 2, device, generator)}
            return fn, (_param_state(params_of(device, generator), device),
                        {k: rows(v) for k, v in batch.items()})

        return Cell(arch_id, shape.name, "rec_train", build, mf)

    if shape.kind == "serve":
        def build(device, generator=None):
            return (functools.partial(rec_lib.dcn_forward, cfg=cfg,
                                      mesh=mesh),
                    (params_of(device, generator),
                     *map(rows, _dcn_inputs(cfg, shape.batch, device,
                                            generator))))

        return Cell(arch_id, shape.name, "rec_serve", build, mf)

    # retrieval: 1 query against 1 M candidates (padded as repro's).
    n_cand = pad_to(shape.n_candidates, 512)

    def build(device, generator=None):
        return (functools.partial(rec_lib.retrieval_scores, cfg=cfg,
                                  top_k=100, mesh=mesh),
                (params_of(device, generator),
                 *_dcn_inputs(cfg, shape.batch, device, generator),
                 _local(_ints((n_cand,), cfg.vocab_sizes[0], device,
                              generator), P(ALL), mesh)))

    return Cell(arch_id, shape.name, "rec_retrieval", build, mf,
                notes=f"n_cand_pad={n_cand}")


# --------------------------------------------------------------------------
# DKS cells: one superstep on a uniform random graph of the dataset's
# size, every node changed (the work model_flops_dks counts)
# --------------------------------------------------------------------------


def _dks_state(v_pad: int, n_nodes: int, m: int, k: int, device,
               generator):
    """``repro``'s unbatched ``DKSState`` (no lane axis) with every real
    node changed: sorted, distinct tables from the generator."""
    from repro_torch.core.dks import DKSState

    n_sets = 1 << m

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    if generator is None:
        S = torch.empty((v_pad, n_sets, k), device=device)
        changed = torch.empty(v_pad, dtype=torch.bool, device=device)
    else:
        base = torch.randint(0, 40, (v_pad, n_sets, 1), generator=generator,
                             device=device).float()
        S = base + torch.arange(k, device=device, dtype=torch.float32)
        changed = torch.arange(v_pad, device=device) < n_nodes
    return DKSState(
        S=S, changed=changed, first_fire=changed.clone(),
        visited=changed.clone(),
        g=full((n_sets,), INF, torch.float32),
        s_front=full((n_sets,), INF, torch.float32),
        topk_w=full((k,), INF, torch.float32),
        topk_root=full((k,), -1, torch.int32),
        msgs_bfs=full((), 0.0, torch.float32),
        msgs_deep=full((), 0.0, torch.float32),
        step=full((), 0, torch.int32), done=full((), False, torch.bool),
        budget_hit=full((), False, torch.bool),
        capped=full((), False, torch.bool))


def _one_lane(step: Callable, graph, state, cfg):
    """``step`` of the port's lane-batched superstep on ``repro``'s
    unbatched state: a lane axis of 1 added (views) and taken off."""
    from repro_torch.core.dks import DKSState, STATE_FIELDS

    lanes = DKSState(**{f: getattr(state, f)[None] for f in STATE_FIELDS})
    nxt = step(graph, lanes, cfg)
    return DKSState(**{f: getattr(nxt, f)[0] for f in STATE_FIELDS})


def _edge_weights(n: int, device, generator) -> torch.Tensor:
    # Degree-class lengths 1..3 (the paper's log10 step function).
    return (torch.randint(1, 4, (n,), generator=generator, device=device)
            .float())


def dks_cell(ds_name: str, m: int = 4, k: int = 2,
             n_shards: int = DKS_SHARDS,
             mesh: "comm.Mesh | None" = None) -> Cell:
    """The frontier-compressed superstep
    (``core/dks_sharded.py::superstep_frontier``) with every shard on the
    one card; on a ``mesh``, one shard a rank (``n_shards`` the mesh's
    size), node arrays and edge shards split over every axis as
    ``repro``'s in-specs split them."""
    from repro_torch.core import dks_sharded
    from repro_torch.core.dks import DKSConfig

    ds = DKS_CONFIGS[ds_name]
    if mesh is not None:
        n_shards = mesh.size
    v_pad = pad_to(ds.n_nodes, max(512, n_shards))
    e_sym = 2 * ds.n_edges
    e_cap = pad_to(int(e_sym / n_shards * 1.2), 8)
    n_loc = v_pad // n_shards
    cfg = DKSConfig(m=m, k=k, max_supersteps=64)

    def fn(graph, state):
        return _one_lane(dks_sharded.superstep_frontier, graph, state, cfg)

    def build(device, generator=None):
        if generator is None:
            src = torch.empty((n_shards, e_cap), dtype=torch.int32,
                              device=device)
            dst_l, w = torch.empty_like(src), torch.empty(
                (n_shards, e_cap), device=device)
            out_degree = torch.empty(v_pad, dtype=torch.int32, device=device)
        else:
            # e_sym / n_shards real edges a shard, uniform ends; padding as
            # pack_frontier_graph's (-1, 0, INF).
            real = torch.arange(e_cap, device=device) < e_sym // n_shards
            src = torch.where(real, _ints((n_shards, e_cap), ds.n_nodes,
                                          device, generator), -1)
            hi = torch.clamp(ds.n_nodes - n_loc * torch.arange(
                n_shards, device=device), 1, n_loc)[:, None]
            dst_l = torch.where(real, (torch.rand(
                (n_shards, e_cap), generator=generator, device=device)
                * hi).to(torch.int32), 0)
            w = torch.where(real, _edge_weights(
                n_shards * e_cap, device, generator).view(n_shards, e_cap),
                INF)
            out_degree = torch.bincount(src[src >= 0].long(),
                                        minlength=v_pad).to(torch.int32)
        leaves = {"edge_src": src, "edge_dst_l": dst_l, "edge_w": w,
                  "out_degree": out_degree,
                  "node_valid": torch.arange(v_pad, device=device)
                  < ds.n_nodes}
        state = _dks_state(v_pad, ds.n_nodes, m, k, device, generator)
        where = {}
        if mesh is not None:
            # repro's in-specs: node arrays, edge shards and the node
            # tables over every axis, the per-query fields whole.
            leaves = {f: _local(v, P(ALL, *([None] * (v.dim() - 1))), mesh)
                      for f, v in leaves.items()}
            state = dataclasses.replace(state, **{
                f: _local(getattr(state, f), P(ALL, *([None] * (
                    getattr(state, f).dim() - 1))), mesh)
                for f in ("S", "changed", "first_fire", "visited")})
            where = {"shard0": mesh.axis_index(mesh_axes(mesh, ALL)),
                     "mesh": mesh}
        graph = dks_sharded.FrontierGraph(
            **leaves, n_nodes=ds.n_nodes, n_edges=e_sym, n_shards=n_shards,
            **where)
        return fn, (graph, state)

    return Cell(f"dks-{ds_name}", f"superstep_m{m}_k{k}", "dks", build,
                rl.model_flops_dks(ds.n_nodes, e_sym, m, k),
                notes=f"V={ds.n_nodes} E_sym={e_sym} shards={n_shards}")


# ``repro``'s in-specs of the dense cell's state fields that are split.
DENSE_SPECS = {"S": P(DP, TP, None), "changed": P(DP), "first_fire": P(DP),
               "visited": P(DP)}


def dks_cell_dense(ds_name: str, m: int = 4, k: int = 2,
                   mesh: "comm.Mesh | None" = None) -> Cell:
    """The dense-relax superstep (``core/dks.py::superstep``), its relax in
    chunks of edges, on one card; on a ``mesh``, one rank of it by
    ``repro``'s in-specs: the graph's leaves and the node masks over the
    data axes, ``S``'s node rows over the data axes and its keyword sets
    over ``model``, the rest whole (``core/dks.py::mesh_superstep``)."""
    from repro_torch.core import dks as dks_mod
    from repro_torch.graph.structure import DeviceGraph

    ds = DKS_CONFIGS[ds_name]
    v_pad = pad_to(ds.n_nodes, 512)
    e_sym = 2 * ds.n_edges
    e_pad = pad_to(e_sym, 512)
    cfg = dks_mod.DKSConfig(m=m, k=k, max_supersteps=64)
    where = {}
    if mesh is not None:
        nodes = mesh_axes(mesh, DP)
        dp, i = mesh.axis_size(nodes), mesh.axis_index(nodes)
        where = {"mesh": mesh, "node_axes": nodes,
                 "set_axes": mesh_axes(mesh, TP),
                 "node_lo": i * (v_pad // dp), "edge_lo": i * (e_pad // dp)}

    def step(leaves: dict, state, offsets: np.ndarray):
        dev = leaves["src"].device
        graph = (dks_mod.MeshGraph if mesh is not None else DeviceGraph)(
            **leaves, n_nodes=ds.n_nodes, n_edges=e_sym,
            # The lane kernel's CSR, which this superstep does not read.
            in_offsets=torch.empty(0, dtype=torch.int64, device=dev),
            hub_nodes=torch.empty(0, dtype=torch.int32, device=dev),
            in_offsets_host=offsets, **where)
        return _one_lane(dks_mod.superstep, graph, state, cfg)

    def build(device, generator=None):
        if generator is None:
            leaves = {"src": torch.empty(e_pad, dtype=torch.int32,
                                         device=device)}
            leaves["dst"] = torch.empty_like(leaves["src"])
            leaves["w"] = torch.empty(e_pad, device=device)
            leaves["valid"] = torch.empty(e_pad, dtype=torch.bool,
                                          device=device)
            leaves["out_degree"] = torch.empty(v_pad, dtype=torch.int32,
                                               device=device)
            # A uniform graph's expected destination offsets.
            offsets = np.zeros(v_pad + 1, np.int64)
            offsets[:ds.n_nodes + 1] = np.linspace(
                0, e_sym, ds.n_nodes + 1).astype(np.int64)
            offsets[ds.n_nodes + 1:] = e_sym
        else:
            real = torch.arange(e_pad, device=device) < e_sym
            dst = torch.sort(_ints((e_pad,), ds.n_nodes, device,
                                   generator)[:e_sym]).values
            pad = torch.zeros(e_pad - e_sym, dtype=torch.int32, device=device)
            src = torch.where(real, _ints((e_pad,), ds.n_nodes, device,
                                          generator), 0)
            leaves = {"src": src, "dst": torch.cat([dst, pad]),
                      "w": torch.where(real, _edge_weights(
                          e_pad, device, generator), INF),
                      "valid": real,
                      "out_degree": torch.bincount(
                          src[:e_sym].long(), minlength=v_pad
                      ).to(torch.int32)}
            offsets = np.zeros(v_pad + 1, np.int64)
            offsets[1:] = torch.cumsum(torch.bincount(
                dst.long(), minlength=v_pad), 0).cpu().numpy()
        leaves["node_valid"] = torch.arange(v_pad, device=device) < ds.n_nodes
        state = _dks_state(v_pad, ds.n_nodes, m, k, device, generator)
        if mesh is not None:
            leaves = _local(leaves, {f: P(DP) for f in leaves}, mesh)
            state = dataclasses.replace(state, **_local(
                {f: getattr(state, f) for f in DENSE_SPECS},
                DENSE_SPECS, mesh))
        return functools.partial(step, offsets=offsets), (leaves, state)

    return Cell(f"dks-{ds_name}", f"superstep_dense_m{m}_k{k}", "dks", build,
                rl.model_flops_dks(ds.n_nodes, e_sym, m, k),
                notes=f"V={ds.n_nodes} E_sym={e_sym} dense relax")


# --------------------------------------------------------------------------
# Catalog
# --------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, tp: int = 1,
               mesh: "comm.Mesh | None" = None) -> Cell:
    """One cell of the catalog; an LM built at ``tp``; on ``mesh``, one
    rank of it (``repro``'s ``build_cell`` on its production meshes takes
    ``tp=16``)."""
    family = dict(CATALOG)[arch_id]
    shape = next(s for s in SHAPES[family] if s.name == shape_name)
    if family == "lm":
        return lm_cell(arch_id, shape, tp=tp, mesh=mesh)
    if family == "gnn":
        return gnn_cell(arch_id, shape, mesh=mesh)
    return recsys_cell(arch_id, shape, mesh=mesh)


def all_assigned_cells() -> list[tuple[str, str]]:
    return [(a, s.name) for a, family in CATALOG for s in SHAPES[family]]


def dks_cells(n_shards: int = DKS_SHARDS) -> list[Cell]:
    return [dks_cell("sec-rdfabout", n_shards=n_shards),
            dks_cell("bluk-bnb", n_shards=n_shards),
            dks_cell_dense("bluk-bnb")]


def mesh_cells(mesh: "comm.Mesh", tp: int = 16
               ) -> list[tuple[str, Callable[[], Cell]]]:
    """``repro``'s ``iter_cells`` on a production mesh, as (name, maker):
    every assigned cell at ``tp``, then the frontier DKS cells with one
    shard a rank and the dense one."""
    makers = [(f"{a}__{s}", functools.partial(build_cell, a, s, tp, mesh))
              for a, s in all_assigned_cells()]
    return makers + [
        (f"dks-{ds}__superstep_m4_k2",
         functools.partial(dks_cell, ds, mesh=mesh))
        for ds in ("sec-rdfabout", "bluk-bnb")] + [
        ("dks-bluk-bnb__superstep_dense_m4_k2",
         functools.partial(dks_cell_dense, "bluk-bnb", mesh=mesh))]


def pp_cells(mesh: "comm.Mesh", tp: int = 16
             ) -> list[tuple[str, Callable[[], Cell]]]:
    """:func:`lm_pp_cell` at ``train_4k`` for every LM of the catalog, on
    the multi-pod ``mesh``, as (name, maker)."""
    return [(f"{a}__train_4k_pp2", functools.partial(
        lm_pp_cell, a, "train_4k", tp, mesh=mesh))
            for a, family in CATALOG if family == "lm"]


def all_cells() -> list[Cell]:
    """Every cell: the assigned (arch, shape) pairs, then the DKS cells."""
    return [build_cell(a, s) for a, s in all_assigned_cells()] + dks_cells()


def get_cell(name: str) -> Cell:
    for cell in all_cells():
        if cell.name == name:
            return cell
    raise KeyError(f"no cell {name!r}; the catalog has "
                   f"{[c.name for c in all_cells()]}")
