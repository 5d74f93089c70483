"""GNN zoo: GAT, SchNet, GIN, PNA — segment-op message passing, trained on
one device or a mesh; the counterpart of ``repro.models.gnn``.

Message passing is a gather (edge src) -> edge compute -> segment reduce
(edge dst): sums are ``index_add`` on a zero base, maxima and minima
``scatter_reduce`` (``"amax"`` / ``"amin"``, ``include_self=False``) on a
``-inf`` / ``+inf`` base, so an empty segment gives ``-inf`` / ``+inf`` and
a tie of maxima splits its gradient evenly, as JAX's ``segment_max`` does.
Where JAX's ``jnp.maximum`` / ``jnp.minimum`` meets a constant, the port
uses ``torch.maximum`` / ``torch.minimum`` too (a tie splits the gradient
in half), never ``clamp``.

Parameters are plain trees shaped like ``repro``'s (``{"layers": [...],
"out": ...}``, ``"interactions"``, ``"embed"``, ``"delta"``), so
:func:`repro_torch.optim.tree_leaves` flattens them in JAX's order.

Dtypes follow JAX's op by op.  Under ``mp_dtype="bfloat16"``
:func:`gnn_forward` casts every floating parameter and ``x`` to bf16; JAX
then promotes bf16 with f32 to f32 wherever an f32 tensor meets a bf16
one (PNA's degree scalers, SchNet's filters and positions), and so does
the port, with explicit casts where torch would not: ``torch.matmul``
refuses mixed dtypes, and a 0-d tensor does not promote in torch as it
does in JAX.  bf16 segment sums run in bf16, as ``repro``'s do, but add in
another order (``index_add`` on the card uses atomics), so bf16 results
agree with ``repro``'s to bf16's precision, not bit for bit.

On a mesh (``mesh=``) the nodes and the edges are split over every axis
(``repro``'s ``gnn_cell``: ``P(ALL)``), the parameters whole.  A rank holds
a block of the nodes and a block of the edges, whose ends are global node
ids, so each node-table read at an edge end (``h[src]``) gathers the table
over every rank first (:func:`_gather_rows`: ``comm.all_gather`` in the
message-passing dtype, ``repro``'s explicit bf16 gather for GAT), and each
segment reduction over the rank's edges is a partial over all N nodes:
sums are reduce-scattered to their node blocks (:func:`_node_sum`), or
``psum``-ed where a whole table is read back at ``dst`` (GAT's softmax)
or per graph (the readouts); maxima and minima are reduced by
:class:`_SegExtremum`, whose backward splits the gradient among the ties
of every rank.  The loss is the rank's sums over ``psum``; every rank
differentiates ``loss / world size`` and sums the gradients over every
axis (:func:`gnn_loss_and_grads`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import GNNConfig
from repro_torch.distributed import comm
from repro_torch.models.common import ALL, dense_init, mesh_axes, split_keys
from repro_torch.optim import (AdamWConfig, OptState, adamw_update,
                               reduce_replicated, tree_leaves, tree_map)

# PNA's edge chunk: at ogb-products scale the four [E, d] message tensors
# do not fit at once, so the aggregate runs over checkpointed edge chunks.
PNA_CHUNK_EDGES = 16_000_000


@dataclasses.dataclass
class GraphBatch:
    x: torch.Tensor          # f32[N, F] node features (atom types for schnet)
    edge_src: torch.Tensor   # int64[E]
    edge_dst: torch.Tensor   # int64[E]
    node_mask: torch.Tensor  # bool[N]
    edge_mask: torch.Tensor  # bool[E]
    labels: torch.Tensor     # int[N] (node tasks) or f32/int[G] (graph tasks)
    graph_ids: torch.Tensor  # int64[N] graph id per node (0 for one graph)
    positions: torch.Tensor  # f32[N, 3] (schnet; zeros otherwise)
    n_graphs: int = 1


class _SegSum(torch.autograd.Function):
    """``index_add`` on a zero base whose backward keeps only the index
    (torch's own ``index_add`` keeps ``vals`` too, for its shape: an [E, d]
    tensor per layer at ogb-products scale)."""

    @staticmethod
    def forward(ctx, vals, seg, n: int):
        ctx.save_for_backward(seg)
        return vals.new_zeros((n, *vals.shape[1:])).index_add_(0, seg, vals)

    @staticmethod
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        return grad.index_select(0, seg), None, None


def _seg_sum(vals, seg, n):
    return _SegSum.apply(vals, seg, n)


def _seg_max(vals, seg, n, mesh=None):
    return _SegExtremum.apply(vals, seg, n, True, mesh, _taped(vals))


def _seg_min(vals, seg, n, mesh=None):
    return _SegExtremum.apply(vals, seg, n, False, mesh, _taped(vals))


def _taped(vals) -> bool:
    """Whether autograd records an op on ``vals`` (inside a custom
    Function's forward grad mode is always off)."""
    return torch.is_grad_enabled() and vals.requires_grad


class _SegExtremum(torch.autograd.Function):
    """The segment max (or min) of every rank's edges, [n, ...] on every
    rank (of the one process's edges without a mesh): the rank's own
    (``scatter_reduce``, ``include_self=False``), then ``pmax`` / ``pmin``
    over every axis.  The backward gives each message that equals its
    segment's result the sum of every rank's cotangent over the number of
    such messages on every rank, as one process splits a tie among the
    messages of its segment (torch's ``scatter_reduce`` backward and JAX's
    ``segment_max``); it keeps a bool per message and the tie counts, not
    the messages, and only where a gradient is taped (``taped``)."""

    @staticmethod
    def forward(ctx, vals, seg, n: int, is_max: bool, mesh, taped: bool):
        op, fill = ("amax", -math.inf) if is_max else ("amin", math.inf)
        idx = seg.view(-1, *([1] * (vals.dim() - 1))).expand_as(vals)
        out = vals.new_full((n, *vals.shape[1:]), fill).scatter_reduce(
            0, idx, vals, op, include_self=False)
        if mesh is not None:
            out = (comm.pmax if is_max else comm.pmin)(
                out, mesh_axes(mesh, ALL), mesh=mesh)
        if not taped:
            return out
        tie = vals == out.gather(0, idx)
        count = _table_sum(vals.new_zeros(out.shape).index_add_(
            0, seg, tie.to(vals.dtype)), mesh)
        ctx.save_for_backward(seg, tie, count)
        ctx.mesh = mesh
        return out

    @staticmethod
    def backward(ctx, grad):
        seg, tie, count = ctx.saved_tensors
        total = _table_sum(grad, ctx.mesh)
        share = (total / torch.clamp(count, min=1)).index_select(0, seg)
        return torch.where(tie, share, 0.0), None, None, None, None, None


def _world(mesh) -> int:
    """The ranks the nodes and edges are split over (1 without a mesh)."""
    return mesh.axis_size(mesh_axes(mesh, ALL)) if mesh is not None else 1


def _nodes_all(h, mesh):
    """Every rank's block of a node table, in node order (the table
    itself without a mesh); its gradient is reduce-scattered back."""
    if mesh is None:
        return h
    return comm.all_gather(h, mesh_axes(mesh, ALL), dim=0, tiled=True,
                           mesh=mesh)


def _node_sum(part, mesh):
    """A rank's partial sums over all N nodes -> its block of the sums
    over every rank (reduce-scattered)."""
    if mesh is None:
        return part
    return comm.reduce_scatter(part, mesh_axes(mesh, ALL), dim=0, mesh=mesh)


def _table_sum(part, mesh):
    """A rank's partial sums of a table read whole (at ``dst``, per
    graph) -> the sums over every rank, on every rank."""
    if mesh is None:
        return part
    return comm.psum(part, mesh_axes(mesh, ALL), mesh=mesh)


def _node_block(t, mesh):
    """This rank's block of a whole node table."""
    if mesh is None:
        return t
    w = t.shape[0] // _world(mesh)
    i = mesh.axis_index(mesh_axes(mesh, ALL))
    return t[i * w:(i + 1) * w]


class _Extremum(torch.autograd.Function):
    """``torch.maximum`` (or ``minimum``) of two tensors whose backward
    keeps one int8 code per element (which side won, or a tie) in place of
    both operands; a tie splits the gradient in half, as ``torch.maximum``
    and ``jnp.maximum`` do."""

    @staticmethod
    def forward(ctx, a, b, is_max: bool):
        won = b > a if is_max else b < a
        ctx.save_for_backward(won.to(torch.int8) + 2 * (a == b).to(torch.int8))
        return torch.maximum(a, b) if is_max else torch.minimum(a, b)

    @staticmethod
    def backward(ctx, grad):
        (code,) = ctx.saved_tensors
        tie = torch.where(code == 2, grad / 2, 0.0)
        return (torch.where(code == 0, grad, tie),
                torch.where(code == 1, grad, tie), None)


def _maximum(a, c: float):
    """``jnp.maximum(a, c)``: a tie with the constant halves the gradient."""
    return torch.maximum(a, a.new_full((), c))


def _minimum(a, c: float):
    return torch.minimum(a, a.new_full((), c))


def _mm(a, b):
    """``a @ b`` with JAX's promotion: both in their common dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _scale(c, a):
    """``c * a`` for a 0-d ``c`` with JAX's promotion (torch keeps ``a``'s
    dtype where JAX promotes an f32 ``c`` with a bf16 ``a`` to f32)."""
    dt = torch.promote_types(c.dtype, a.dtype)
    return c.to(dt) * a.to(dt)


def _degree(batch: GraphBatch, n: int, mesh=None) -> torch.Tensor:
    """In-degree of each node (of the rank's block on a mesh)."""
    return _node_sum(_seg_sum(batch.edge_mask.float(), batch.edge_dst, n),
                     mesh)


def _mp_dtype(cfg: GNNConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.mp_dtype == "bfloat16" else torch.float32


def _gather_rows(h, idx, mpd, mesh=None):
    """``h[idx]`` with the node table cast to the message-passing dtype
    first; on a mesh ``h`` is the rank's block, all-gathered in that dtype
    (``repro``'s explicit bf16 all-gather; the gradient comes back as a
    reduce-scatter in it)."""
    return _nodes_all(h.to(mpd), mesh)[idx]


def _edge_softmax(scores, dst, edge_mask, n, mesh=None):
    """Segment softmax over incoming edges (GAT); f32 for stability.  On a
    mesh the maxima and the denominators are whole tables, read at
    ``dst``."""
    scores = scores.float()
    mask = edge_mask[..., None] if scores.dim() > 1 else edge_mask
    scores = torch.where(mask, scores, -1e30)
    mx = _seg_max(scores, dst, n, mesh)
    ex = torch.where(mask, torch.exp(scores - mx[dst]), 0.0)
    den = _table_sum(_seg_sum(ex, dst, n), mesh)
    return ex / _maximum(den[dst], 1e-16)


# --------------------------------------------------------------------------
# GAT (arXiv:1710.10903): SDDMM edge scores -> segment softmax -> SpMM.
# --------------------------------------------------------------------------


def init_gat(generator: torch.Generator, cfg: GNNConfig, d_in: int) -> dict:
    layers = []
    gens = split_keys(generator, list(range(cfg.n_layers)))
    d_prev = d_in
    for li in range(cfg.n_layers):
        last = li == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        heads = 1 if last else cfg.n_heads
        ks = split_keys(gens[li], ["w", "a_src", "a_dst"])
        layers.append({
            "w": dense_init(ks["w"], (d_prev, heads * d_out), torch.float32),
            "a_src": dense_init(ks["a_src"], (heads, d_out), torch.float32),
            "a_dst": dense_init(ks["a_dst"], (heads, d_out), torch.float32),
        })
        d_prev = d_out * (heads if not last else 1)
    return {"layers": layers}


def _leaky_relu(x, slope: float):
    """``jax.nn.leaky_relu``: the gradient at 0 is 1 (torch's is slope)."""
    return torch.where(x >= 0, x, slope * x)


def gat_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                mesh=None) -> torch.Tensor:
    x = batch.x
    n_loc = x.shape[0]
    n = n_loc * _world(mesh)
    n_layers = len(params["layers"])
    mpd = _mp_dtype(cfg)
    for li, lw in enumerate(params["layers"]):
        last = li == n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = lw["w"].shape[1] // heads
        h = _mm(x, lw["w"]).reshape(n_loc, heads, d_out)
        s_src = torch.sum(h * lw["a_src"][None], dim=-1)   # [N, H]
        s_dst = torch.sum(h * lw["a_dst"][None], dim=-1)
        s_all = _nodes_all(torch.cat([s_src, s_dst], dim=-1), mesh)
        e = _leaky_relu(s_all[batch.edge_src, :heads]
                        + s_all[batch.edge_dst, heads:], 0.2)
        alpha = _edge_softmax(e, batch.edge_dst, batch.edge_mask, n, mesh)
        h_src = _gather_rows(h.reshape(n_loc, heads * d_out), batch.edge_src,
                             mpd, mesh).reshape(-1, heads, d_out)
        msg = h_src * alpha.to(mpd)[..., None]             # [E, H, D]
        agg = _node_sum(_seg_sum(msg, batch.edge_dst, n), mesh)  # mp_dtype
        x = (agg.reshape(n_loc, heads * d_out) if not last
             else agg.mean(dim=1))
        if not last:
            x = torch.nn.functional.elu(x)
    return x  # [N, n_classes] logits


# --------------------------------------------------------------------------
# GIN (arXiv:1810.00826): sum aggregation + MLP, learnable eps.
# --------------------------------------------------------------------------


def init_gin(generator: torch.Generator, cfg: GNNConfig, d_in: int) -> dict:
    f32 = torch.float32
    dev = generator.device
    gens = split_keys(generator, list(range(cfg.n_layers + 1)))
    layers = []
    d_prev = d_in
    for li in range(cfg.n_layers):
        ks = split_keys(gens[li], ["w1", "w2"])
        layers.append({
            "w1": dense_init(ks["w1"], (d_prev, cfg.d_hidden), f32),
            "b1": torch.zeros((cfg.d_hidden,), dtype=f32, device=dev),
            "w2": dense_init(ks["w2"], (cfg.d_hidden, cfg.d_hidden), f32),
            "b2": torch.zeros((cfg.d_hidden,), dtype=f32, device=dev),
            "eps": torch.zeros((), dtype=f32, device=dev),
        })
        d_prev = cfg.d_hidden
    out = dense_init(gens[cfg.n_layers], (cfg.d_hidden, cfg.n_classes), f32)
    return {"layers": layers, "out": out}


def gin_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                graph_level: bool = False, mesh=None) -> torch.Tensor:
    x = batch.x
    n = x.shape[0] * _world(mesh)
    mpd = _mp_dtype(cfg)
    for lw in params["layers"]:
        xm = x.to(mpd)
        msg = torch.where(batch.edge_mask[:, None],
                          _gather_rows(xm, batch.edge_src, mpd, mesh), 0.0)
        agg = _node_sum(_seg_sum(msg, batch.edge_dst, n), mesh)  # mp_dtype
        h = _scale(1.0 + lw["eps"], xm) + agg
        h = torch.relu(_mm(h, lw["w1"]) + lw["b1"])
        x = torch.relu(_mm(h, lw["w2"]) + lw["b2"])
    if graph_level:
        pooled = _table_sum(_seg_sum(
            torch.where(batch.node_mask[:, None], x, 0.0), batch.graph_ids,
            batch.n_graphs), mesh)
        return _mm(pooled, params["out"])                 # [G, classes]
    return _mm(x, params["out"])                          # [N, classes]


# --------------------------------------------------------------------------
# PNA (arXiv:2004.05718): mean/max/min/std aggregators x id/amp/atten scalers.
# --------------------------------------------------------------------------


def init_pna(generator: torch.Generator, cfg: GNNConfig, d_in: int,
             delta: float = 2.5) -> dict:
    f32 = torch.float32
    gens = split_keys(generator, list(range(cfg.n_layers + 1)))
    n_agg = len(cfg.aggregators) * len(cfg.scalers)
    layers = []
    d_prev = d_in
    for li in range(cfg.n_layers):
        ks = split_keys(gens[li], ["pre", "post"])
        layers.append({
            "pre": dense_init(ks["pre"], (d_prev, cfg.d_hidden), f32),
            "post": dense_init(
                ks["post"], (n_agg * cfg.d_hidden + d_prev, cfg.d_hidden), f32),
        })
        d_prev = cfg.d_hidden
    out = dense_init(gens[cfg.n_layers], (cfg.d_hidden, cfg.n_classes), f32)
    return {"layers": layers, "out": out,
            "delta": torch.tensor(delta, dtype=f32, device=generator.device)}


def pna_chunks(n_edges: int, chunk_edges: int = PNA_CHUNK_EDGES) -> int:
    """The number of edge chunks :func:`_pna_aggregate` runs; 1 is the
    unchunked path, taken also when the chunks would not be equal."""
    nc = max(1, -(-n_edges // chunk_edges))
    return 1 if nc == 1 or n_edges % nc else nc


def _pna_messages(h, src, dst, mask, n, mesh=None):
    """(sum, sumsq, max, min) of one set of edges' messages per node; on
    a mesh the sums are the rank's partials and the extrema every rank's
    (whole tables)."""
    g = h[src]
    m = torch.where(mask[:, None], g, 0.0)
    return (_seg_sum(m, dst, n), _seg_sum(m * m, dst, n),
            _seg_max(torch.where(mask[:, None], g, -1e30), dst, n, mesh),
            _seg_min(torch.where(mask[:, None], g, 1e30), dst, n, mesh))


def _pna_aggregate(h, batch: GraphBatch, n: int,
                   chunk_edges: int = PNA_CHUNK_EDGES, mesh=None):
    """(sum, sumsq, max, min) per destination — edge-CHUNKED when the edge
    set is large (:func:`pna_chunks`): each chunk's messages run under
    ``torch.utils.checkpoint``, so the live set is one chunk's [chunk, d]
    and the backward recomputes them, as ``repro``'s checkpointed scan
    does.  Each chunk's partial sums are added to the running ones, and
    its maxima and minima taken as ``torch.maximum`` / ``minimum`` would
    (a tie across chunks splits the gradient, as ``jnp.maximum``'s does)
    by :class:`_Extremum`, which keeps an int8 code per element for the
    backward where ``torch.maximum`` would keep both [N, d] operands.

    On a mesh ``h`` is the whole node table (gathered), the edges and
    their chunks the rank's, and the result the rank's node block: the
    sums reduce-scattered, the extrema (every rank's edges of a chunk)
    cut to the block."""
    e = batch.edge_src.shape[0]
    nc = pna_chunks(e, chunk_edges)
    if nc == 1:
        s, sq, mx, mn = _pna_messages(h, batch.edge_src, batch.edge_dst,
                                      batch.edge_mask, n, mesh)
    else:
        ec = e // nc
        d = h.shape[1]
        s = h.new_zeros((n, d))
        sq = h.new_zeros((n, d))
        mx = h.new_full((n, d), -1e30)
        mn = h.new_full((n, d), 1e30)
        for c in range(nc):
            part = slice(c * ec, (c + 1) * ec)
            ps, psq, pmx, pmn = checkpoint(
                _pna_messages, h, batch.edge_src[part], batch.edge_dst[part],
                batch.edge_mask[part], n, mesh, use_reentrant=False)
            s, sq = s + ps, sq + psq
            mx = _Extremum.apply(mx, pmx, True)
            mn = _Extremum.apply(mn, pmn, False)
    return (_node_sum(s, mesh), _node_sum(sq, mesh), _node_block(mx, mesh),
            _node_block(mn, mesh))


def _pna_features(aggregates, x, deg, log_deg, delta, cfg: GNNConfig):
    """z: every aggregator under every scaler, then ``x``, concatenated
    (``torch.cat`` promotes as JAX's ``concatenate`` does: bf16 with f32
    to f32)."""
    s, sq, mmax, mmin = aggregates
    has = deg[:, None] > 0
    mean = s / torch.clamp(deg[:, None], min=1.0)
    mmax = torch.where(has, _maximum(mmax, -1e30), 0.0)
    mmin = torch.where(has, _minimum(mmin, 1e30), 0.0)
    var = (sq.float() / torch.clamp(deg[:, None], min=1.0)
           - mean.float() ** 2)
    std = torch.sqrt(_maximum(var, 0.0) + 1e-5).to(s.dtype)
    aggs = {"mean": mean, "max": mmax, "min": mmin, "std": std, "sum": s}
    scale = {"amplification": (log_deg / delta)[:, None],
             "attenuation": (delta / _maximum(log_deg, 1e-2))[:, None]}
    feats = []
    for agg_name in cfg.aggregators:
        a = aggs[agg_name]
        for sc in cfg.scalers:
            feats.append(a if sc == "identity" else a * scale[sc])
    return torch.cat(feats + [x], dim=-1)


def _pna_update(aggregates, x, deg, log_deg, delta, post, cfg: GNNConfig):
    return torch.relu(_mm(_pna_features(aggregates, x, deg, log_deg, delta,
                                        cfg), post))


def pna_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                mesh=None) -> torch.Tensor:
    """PNA's layers.  Each layer's z ([N, 13 d], f32 from the first layer
    on under bf16) is recomputed in the backward from the aggregates
    (``torch.utils.checkpoint``) instead of kept, so that a step at
    ogb-products scale fits one card; the recomputation is elementwise
    and one product, so the gradients are those of the forward's z."""
    x = batch.x
    n = x.shape[0] * _world(mesh)
    deg = _degree(batch, n, mesh)
    log_deg = torch.log(deg + 1.0)
    delta = params["delta"]
    for lw in params["layers"]:
        h = _nodes_all(torch.relu(_mm(x, lw["pre"])), mesh)
        x = checkpoint(_pna_update,
                       _pna_aggregate(h, batch, n, mesh=mesh), x, deg,
                       log_deg, delta, lw["post"], cfg, use_reentrant=False)
    return _mm(x, params["out"])


# --------------------------------------------------------------------------
# SchNet (arXiv:1706.08566): RBF expansion + continuous-filter convolution.
# --------------------------------------------------------------------------


def shifted_softplus(x):
    return torch.nn.functional.softplus(x) - math.log(2.0)


def init_schnet(generator: torch.Generator, cfg: GNNConfig,
                n_atom_types: int = 100) -> dict:
    f32 = torch.float32
    d = cfg.d_hidden
    gens = split_keys(generator, list(range(cfg.n_layers + 2)))
    inter = []
    for li in range(cfg.n_layers):
        ks = split_keys(gens[li], ["filt1", "filt2", "in", "out1", "out2"])
        inter.append({
            "filt1": dense_init(ks["filt1"], (cfg.rbf, d), f32),
            "filt2": dense_init(ks["filt2"], (d, d), f32),
            "w_in": dense_init(ks["in"], (d, d), f32),
            "w_out1": dense_init(ks["out1"], (d, d), f32),
            "w_out2": dense_init(ks["out2"], (d, d), f32),
        })
    ks = split_keys(gens[cfg.n_layers], ["o1", "o2"])
    return {
        "embed": dense_init(gens[cfg.n_layers + 1], (n_atom_types, d), f32,
                            scale=1.0),
        "interactions": inter,
        "out1": dense_init(ks["o1"], (d, d // 2), f32),
        "out2": dense_init(ks["o2"], (d // 2, 1), f32),
    }


def schnet_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                   mesh=None) -> torch.Tensor:
    """Per-graph energy [G]. batch.x[:, 0] holds integer atom types."""
    n = batch.x.shape[0] * _world(mesh)
    embed = params["embed"]
    z = batch.x[:, 0].to(torch.int32).clamp(0, embed.shape[0] - 1)
    x = embed[z.long()]
    pos = _nodes_all(batch.positions, mesh)
    diff = pos[batch.edge_src] - pos[batch.edge_dst]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    centers = torch.linspace(0.0, cfg.cutoff, cfg.rbf, dtype=torch.float32,
                             device=dist.device)
    gamma = 10.0
    rbf = torch.exp(-gamma * (dist[:, None] - centers[None]) ** 2)  # [E, rbf]
    # Smooth cosine cutoff.
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                 + 1.0)
    for lw in params["interactions"]:
        filt = shifted_softplus(_mm(rbf, lw["filt1"]))
        filt = shifted_softplus(_mm(filt, lw["filt2"])) * env[:, None]
        h = _mm(x, lw["w_in"])
        msg = _nodes_all(h, mesh)[batch.edge_src] * filt
        msg = torch.where(batch.edge_mask[:, None], msg, 0.0)
        agg = _node_sum(_seg_sum(msg, batch.edge_dst, n), mesh)
        v = _mm(shifted_softplus(_mm(agg, lw["w_out1"])), lw["w_out2"])
        x = x + v
    e_atom = _mm(shifted_softplus(_mm(x, params["out1"])), params["out2"])
    e_atom = torch.where(batch.node_mask[:, None], e_atom, 0.0)
    return _table_sum(_seg_sum(e_atom[:, 0], batch.graph_ids,
                               batch.n_graphs), mesh)            # [G]


# --------------------------------------------------------------------------
# Dispatch, task losses and the train step
# --------------------------------------------------------------------------


def init_gnn(generator: torch.Generator, cfg: GNNConfig, d_in: int) -> dict:
    """Random f32 parameters on ``generator``'s device, with ``repro``'s
    distributions and tree."""
    if cfg.family == "gat":
        return init_gat(generator, cfg, d_in)
    if cfg.family == "gin":
        return init_gin(generator, cfg, d_in)
    if cfg.family == "pna":
        return init_pna(generator, cfg, d_in)
    if cfg.family == "schnet":
        return init_schnet(generator, cfg)
    raise ValueError(cfg.family)


def gnn_forward(params: dict, batch: GraphBatch, cfg: GNNConfig,
                graph_level: bool = False, mesh=None) -> torch.Tensor:
    """The family's output in f32: per node (the rank's block on a mesh),
    or per graph, whole on every rank (GIN's ``graph_level`` head,
    SchNet's energies)."""
    if cfg.mp_dtype == "bfloat16":
        # bf16 across the whole message-passing path (params, features,
        # edge gathers and their gradients); softmax and losses stay f32.
        params = tree_map(lambda p: p.to(torch.bfloat16)
                          if p.is_floating_point() else p, params)
        batch = dataclasses.replace(batch, x=batch.x.to(torch.bfloat16))
    if cfg.family == "gat":
        out = gat_forward(params, batch, cfg, mesh)
    elif cfg.family == "gin":
        out = gin_forward(params, batch, cfg, graph_level, mesh)
    elif cfg.family == "pna":
        out = pna_forward(params, batch, cfg, mesh)
    elif cfg.family == "schnet":
        out = schnet_forward(params, batch, cfg, mesh)
    else:
        raise ValueError(cfg.family)
    return out.float()


def _cross_entropy(logits, labels):
    """Per-row ``logsumexp - gold`` with labels clipped into the classes."""
    labels = labels.long().clamp(0, logits.shape[-1] - 1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[:, None], dim=1)[:, 0]
    return logz - gold


def _graph_labels(batch: GraphBatch, mesh) -> torch.Tensor:
    """The per-graph labels whole (gathered where they are split)."""
    if batch.labels.shape[0] == batch.n_graphs:
        return batch.labels
    return _nodes_all(batch.labels, mesh)


def gnn_loss(params: dict, batch: GraphBatch, cfg: GNNConfig,
             mesh=None) -> torch.Tensor:
    """``repro``'s task losses: SchNet's energy MSE (always f32: it calls
    :func:`schnet_forward` on the parameters as they are, whatever
    ``mp_dtype``), a graph-level cross entropy when ``n_graphs > 1`` (GAT
    and PNA heads mean-pooled per graph), else a node-level one masked by
    ``node_mask``.  On a mesh every rank returns the whole loss: the
    per-graph tables and the node-level sums and counts over ``psum``."""
    if cfg.family == "schnet":
        energy = schnet_forward(params, batch, cfg, mesh)
        return torch.mean((energy - _graph_labels(batch, mesh).float()) ** 2)
    graph_level = batch.n_graphs > 1
    logits = gnn_forward(params, batch, cfg, graph_level, mesh)
    if graph_level:
        per_node = not (cfg.family == "gin")     # GIN's head pools itself
        rows = logits.shape[0] * (_world(mesh) if per_node else 1)
        if rows != batch.n_graphs:
            # Node-level heads (GAT/PNA): mean-pool per graph.
            cnt = _table_sum(_seg_sum(batch.node_mask.float(),
                                      batch.graph_ids, batch.n_graphs), mesh)
            pooled = _table_sum(_seg_sum(
                torch.where(batch.node_mask[:, None], logits, 0.0),
                batch.graph_ids, batch.n_graphs), mesh)
            logits = pooled / torch.clamp(cnt[:, None], min=1.0)
        return torch.mean(_cross_entropy(logits, _graph_labels(batch, mesh)))
    labels = batch.labels
    if labels.shape[0] != logits.shape[0]:       # whole: this rank's block
        labels = _node_block(labels, mesh)
    mask = batch.node_mask.float()
    total = _table_sum(torch.sum(_cross_entropy(logits, labels) * mask), mesh)
    return total / torch.clamp(_table_sum(torch.sum(mask), mesh), min=1.0)


def gnn_loss_and_grads(params: dict, batch: GraphBatch, cfg: GNNConfig,
                       mesh=None) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """:func:`gnn_loss` and its gradient for every leaf of ``params``, in
    :func:`repro_torch.optim.tree_leaves`'s order (zeros for a leaf the
    loss does not reach, as JAX's ``grad`` gives).  On a mesh every rank
    differentiates ``loss / world size`` (the collectives' transposes
    carry the rest) and the gradients, of parameters every rank holds
    whole, are summed over every rank."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = gnn_loss(params, batch, cfg, mesh)
    seed = None if mesh is None else torch.full_like(loss, 1.0 / mesh.size)
    grads = torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                allow_unused=True, materialize_grads=True)
    for p in leaves:
        p.requires_grad_(False)
    grads = list(grads)
    if mesh is not None:
        grads = reduce_replicated(grads, [comm.PartitionSpec()] * len(grads),
                                  mesh)
    return loss.detach(), grads


def gnn_train_step(params: dict, opt: OptState, batch: GraphBatch,
                   cfg: GNNConfig, opt_cfg: AdamWConfig, mesh=None
                   ) -> tuple[dict, OptState, dict]:
    """One step of ``repro``'s GNN cell (``launch/cells.py``'s
    ``_gnn_train_step``): :func:`gnn_loss_and_grads`, then AdamW in place.
    Returns (``params``, the new :class:`OptState`, ``{"loss", "grads",
    "grad_norm", "lr"}``), ``grads`` the step's gradient leaves.  On a
    mesh ``batch`` is the rank's block and every rank takes the same
    step."""
    loss, grads = gnn_loss_and_grads(params, batch, cfg, mesh)
    _, opt, metrics = adamw_update(opt_cfg, grads, opt, tree_leaves(params))
    return params, opt, {"loss": loss, "grads": grads, **metrics}


def collective_bytes(cfg: GNNConfig, n: int, e: int, d_feat: int,
                     chunk_edges: int = PNA_CHUNK_EDGES) -> dict:
    """The bytes a rank passes to the collectives in one
    :func:`gnn_train_step` of a node-level task of GAT, GIN or PNA on a
    mesh: ``{(pass, collective): bytes}``, ``pass`` ``"forward"`` or
    ``"backward"`` (the gradients' ``psum`` included), each table at its
    whole size (an all-gather's output, a reduce-scatter's input), for
    ``n`` nodes in all, ``e`` edges a rank, ``d_feat`` features and
    PNA's edge chunk ``chunk_edges``.

    GIN's first layer reads the features, which take no gradient, so its
    collectives have no transpose.  Every other all-gather's transpose is
    a reduce-scatter of its table and back, a ``psum``'s a ``psum``, and a
    segment extremum (:class:`_SegExtremum`: a ``pmax`` or ``pmin``, and
    a ``psum`` of its tie counts where a gradient is taped, as in a step)
    has one ``psum`` of its cotangent.  PNA's
    checkpointed edge chunks (:func:`pna_chunks`) each reduce their
    extrema across ranks, and run their forward again in the backward.
    The loss adds two 0-d ``psum``s, and one in the backward."""
    if cfg.family not in ("gat", "gin", "pna"):
        raise ValueError(f"collective_bytes: {cfg.family}")
    out = {(p, k): 0 for p in ("forward", "backward")
           for k in ("all_gather", "reduce_scatter", "all_reduce")}

    def add(pas, kind, nbytes, times=1):
        out[(pas, kind)] += times * nbytes

    mb = _mp_dtype(cfg).itemsize
    d_in = d_feat
    for layer in range(cfg.n_layers):
        if cfg.family == "gin":          # x gathered, agg reduce-scattered
            t = n * d_in * mb
            add("forward", "all_gather", t)
            add("forward", "reduce_scatter", t)
            if layer:
                add("backward", "reduce_scatter", t)
                add("backward", "all_gather", t)
            d_in = cfg.d_hidden
        elif cfg.family == "gat":
            last = layer == cfg.n_layers - 1
            heads = 1 if last else cfg.n_heads
            width = heads * (cfg.n_classes if last else cfg.d_hidden)
            # s_src | s_dst and h gathered, agg reduce-scattered; the
            # softmax's max (pmax and tie counts) and denominator in f32
            for t in (n * 2 * heads * mb, n * width * mb):
                add("forward", "all_gather", t)
                add("backward", "reduce_scatter", t)
            add("forward", "reduce_scatter", n * width * mb)
            add("backward", "all_gather", n * width * mb)
            add("forward", "all_reduce", n * heads * 4, 3)
            add("backward", "all_reduce", n * heads * 4, 2)
        else:                            # pna: f32 from the second layer
            t = n * cfg.d_hidden * (mb if layer == 0 else 4)
            nc = pna_chunks(e, chunk_edges)
            add("forward", "all_gather", t)
            add("backward", "reduce_scatter", t)
            add("forward", "reduce_scatter", t, 2)   # sum, sum of squares
            add("backward", "all_gather", t, 2)
            add("forward", "all_reduce", t, 4 * nc)  # max, min, 2 counts
            add("backward", "all_reduce", t, 2 * nc + (4 * nc if nc > 1
                                                      else 0))
    if cfg.family == "pna":
        add("forward", "reduce_scatter", n * 4)      # the degrees
    params = init_gnn(torch.Generator().manual_seed(0), cfg, d_feat)
    add("forward", "all_reduce", 4, 2)
    add("backward", "all_reduce", 4 + 4 * sum(
        p.numel() for p in tree_leaves(params)))
    return out
