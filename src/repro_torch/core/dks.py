"""DKS — Distributed Keyword Search (the paper's core algorithm) in torch.

The twin of ``repro.core.dks``.  Vertex state is the dense table
``S[L, V, 2^m, K]``: for each of ``L`` concurrent queries (lanes), the
top-K distinct partial answer weights per node and keyword-set.  Where
``repro`` writes one unbatched query and ``vmap``s it over lanes, every
function here carries the lane axis explicitly — a single query is the
``L = 1`` case.  One superstep is:

  1. *Send/Receive* — min-plus edge relaxation from every node whose table
     changed last superstep, reduced per destination with an exact
     segment-top-K;
  2. *Combine* — per-node min-plus subset convolution over keyword-sets;
  3. *Aggregate* — frontier minima per keyword-set and the global top-K
     answer weights;
  4. *Exit check* — ``nu[full] >= W_K``, frontier exhaustion, message
     budget, superstep cap.

On a mesh the superstep runs on one rank's :class:`MeshGraph`, the layout
``repro``'s dense cell gives GSPMD: edges and node rows split over the
data axes, the keyword-set axis of ``S`` over ``"model"``, with explicit
collectives (:func:`mesh_superstep`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import INF
from repro_torch.core import semiring, spa
from repro_torch.graph.structure import DeviceGraph
from repro_torch.obs.telemetry import HostTelemetryCollector

BACKENDS = ("torch", "cuda")

# The "torch" backend at bluk-bnb scale (16.1 M nodes, 92.4 M symmetric
# edges): its relax would build [L, E, 2^m, K] candidates at once (71 GB at
# 8 lanes, m = 3, K = 3), and its node-local merge and combine sort about
# 20x their input (K x K sums, int64 indices).  Both go in chunks instead.
RELAX_CHUNK_BYTES = 1 << 30   # candidates of one chunk of edges
NODE_CHUNK_BYTES = 128 << 20  # table rows of one chunk of nodes


@dataclasses.dataclass(frozen=True)
class DKSConfig:
    """Static configuration of a DKS run.

    ``backend``: "torch" (stock torch ops, the twin of ``repro``'s "jnp"
    ``relax_impl``/``combine_impl``) or "cuda" (the hand-written kernels,
    the twin of "pallas"): :func:`combine` runs the subset-combine kernel
    and the lane driver runs the fused superstep kernel.  :func:`relax`
    itself is always the torch edge-list relax (as ``repro``'s "pallas"
    relax is its jnp edge-list relax).
    """

    m: int                      # number of query keywords
    k: int = 1                  # top-K answers
    max_supersteps: int = 64
    message_budget: float = float("inf")
    exit_mode: str = "sound"    # "sound" | "none"
    backend: str = "torch"      # "torch" | "cuda"
    combine_passes: int | None = None  # default ceil(log2 m)
    frontier_frac: float = 0.25  # per-shard frontier cap (sharded relax);
    # overflow marks budget_hit, the paper's Sec. 5.4 forced stop + SPA.

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def n_sets(self) -> int:
        return 1 << self.m

    @property
    def full(self) -> int:
        return (1 << self.m) - 1

    def n_combine_passes(self) -> int:
        if self.combine_passes is not None:
            return self.combine_passes
        if self.m <= 1:
            return 0
        return int(np.ceil(np.log2(self.m)))


@dataclasses.dataclass
class DKSState:
    """Per-superstep state; every field has a leading lane axis ``L``."""

    S: torch.Tensor            # f32[L, V, 2^m, K] top-K distinct weights
    changed: torch.Tensor      # bool[L, V] — Pregel "active" vertices
    first_fire: torch.Tensor   # bool[L, V] — active for the first time
    visited: torch.Tensor      # bool[L, V] — ever active
    g: torch.Tensor            # f32[L, 2^m] global running min per set
    s_front: torch.Tensor      # f32[L, 2^m] min over current frontier
    topk_w: torch.Tensor       # f32[L, K] global top-K answer weights
    topk_root: torch.Tensor    # i32[L, K] their root nodes
    msgs_bfs: torch.Tensor     # f32[L] cumulative BFS messages
    msgs_deep: torch.Tensor    # f32[L] cumulative deep messages
    step: torch.Tensor         # i32[L]
    done: torch.Tensor         # bool[L]
    budget_hit: torch.Tensor   # bool[L] — stopped by the message budget
    capped: torch.Tensor       # bool[L] — stopped ONLY by the superstep cap


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(DKSState))


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshGraph(DeviceGraph):
    """One rank's part of a :class:`DeviceGraph` on ``mesh``, as ``repro``'s
    dense cell lays it out: every leaf split over ``node_axes`` (its
    ``P(DP)``), so the rank holds a contiguous block of the
    destination-sorted edges, from edge ``edge_lo``, and of the node rows,
    from node ``node_lo``.  The rank's tables ``S`` split their keyword-set
    axis over ``set_axes`` (``"model"``) and repeat over nothing else.
    ``in_offsets_host`` are the whole graph's destination offsets."""

    mesh: Any = None
    node_axes: tuple[str, ...] = ()
    set_axes: tuple[str, ...] = ()
    node_lo: int = 0
    edge_lo: int = 0

    def e_min(self) -> torch.Tensor:
        """Smallest real edge length of the whole graph, f32[]."""
        return across_nodes(self, super().e_min(), "min")


def across_nodes(graph: Any, x: torch.Tensor, op: str) -> torch.Tensor:
    """``x``, reduced over the node rows the graph holds, reduced over
    every rank that holds rows of the node axis (``op``: "sum", "max" or
    "min"): the graph's ``node_axes`` (a :class:`MeshGraph`'s data axes),
    else every axis of its mesh (a
    :class:`~repro_torch.core.dks_sharded.FrontierGraph`).  The identity
    on a graph without a mesh."""
    mesh = getattr(graph, "mesh", None)
    if mesh is None:
        return x
    from repro_torch.distributed import comm

    return {"sum": comm.psum, "max": comm.pmax, "min": comm.pmin}[op](
        x, getattr(graph, "node_axes", None), mesh=mesh)


def node_rows(graph: Any, S: torch.Tensor, nodes: list[int]
              ) -> torch.Tensor:
    """Rows ``S[nodes]`` of one lane's table ``[rows, 2^m, K]`` (``nodes``:
    global ids), whole on every rank.  On a graph split across the ranks
    of a mesh each rank fills the rows it holds and INF elsewhere, and a
    min over the ranks gives every rank the owner's rows: a few rows cross
    the wire, never the table."""
    lo = getattr(graph, "node_lo", 0)
    held = S.shape[0]
    idx = torch.tensor(nodes, dtype=torch.long, device=S.device) - lo
    mine = (idx >= 0) & (idx < held)
    rows = S[idx.clamp(0, held - 1)]
    rows = torch.where(mine[:, None, None], rows, torch.full_like(rows, INF))
    return across_nodes(graph, rows, "min")


def init_state(graph: DeviceGraph, kw_masks: torch.Tensor,
               cfg: DKSConfig) -> DKSState:
    """Superstep 0 for ``L`` lanes (``kw_masks``: bool[L, m, V]):
    keyword-nodes hold weight-0 singletons and are active.  Reads only
    ``node_valid`` of the graph (and ``node_lo``, where a sharded
    :class:`~repro_torch.core.dks_sharded.FrontierGraph` on one rank holds
    only some of the node rows: the masks are cut to them)."""
    dev = graph.node_valid.device
    lanes = kw_masks.shape[0]
    v_pad = graph.node_valid.shape[0]
    lo = getattr(graph, "node_lo", 0)
    kw_masks = kw_masks[..., lo: lo + v_pad]
    n, k = cfg.n_sets, cfg.k
    S = torch.full((lanes, v_pad, n, k), INF, dtype=torch.float32, device=dev)
    for i in range(cfg.m):
        S[:, :, 1 << i, 0] = torch.where(kw_masks[:, i], 0.0, INF)
    changed = kw_masks.any(dim=1) & graph.node_valid
    S = combine(S, cfg)  # nodes holding several keywords already combine

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    state = DKSState(
        S=S,
        changed=changed,
        first_fire=changed,
        visited=changed,
        g=full((lanes, n), INF, torch.float32),
        s_front=full((lanes, n), INF, torch.float32),
        topk_w=full((lanes, k), INF, torch.float32),
        topk_root=full((lanes, k), -1, torch.int32),
        msgs_bfs=full((lanes,), 0.0, torch.float32),
        msgs_deep=full((lanes,), 0.0, torch.float32),
        step=full((lanes,), 0, torch.int32),
        done=full((lanes,), False, torch.bool),
        budget_hit=full((lanes,), False, torch.bool),
        capped=full((lanes,), False, torch.bool),
    )
    return aggregate(graph, state, cfg)


def relax(graph: DeviceGraph, S: torch.Tensor, changed: torch.Tensor,
          cfg: DKSConfig) -> torch.Tensor:
    """Messages: every active node sends its table along every incident
    edge; destinations keep the per-keyword-set top-K of what arrives.

    ``S``: [L, V, 2^m, K]; ``changed``: bool[L, V].  Returns R of the same
    shape (INF where nothing arrived).
    """
    return relax_edges(S, changed, graph.src, graph.dst, graph.w,
                       graph.valid, dst_offsets=graph.in_offsets_host)


def _chunk_range(dst_offsets: np.ndarray, e0: int, e1: int
                 ) -> tuple[int, int]:
    """A range of destinations that holds every edge of ``[e0, e1)``:
    real edges (the first ``dst_offsets[-1]``, sorted by destination) from
    their CSR offsets; padding points at node 0."""
    n_real = int(dst_offsets[-1])
    if e0 >= n_real:
        return 0, 1
    lo = int(np.searchsorted(dst_offsets, e0, side="right")) - 1
    hi = int(np.searchsorted(dst_offsets, min(e1, n_real) - 1,
                             side="right"))
    return (0 if e1 > n_real else lo), hi


def relax_edges(S: torch.Tensor, changed: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, w: torch.Tensor,
                valid: torch.Tensor | None = None, *,
                n_dst: int | None = None,
                chunk_edges: int | None = None,
                dst_offsets: np.ndarray | None = None) -> torch.Tensor:
    """:func:`relax` over an explicit edge list (``valid=None``: all real)
    into ``n_dst`` destinations (default ``S.shape[1]``), over chunks of
    ``chunk_edges`` edges (default: :data:`RELAX_CHUNK_BYTES` of
    candidates).  Each chunk's candidates are reduced per destination and
    merged into the running result with ``topk_merge``, over the range of
    destinations the chunk reaches: the K smallest distinct values of a
    union are those of the union of each part's K smallest distinct
    values, so every chunk size gives the same result.  The range is read
    from the device, or, given ``dst_offsets`` (the host CSR offsets of a
    destination-sorted list), computed on the host; a wider range merges
    nothing into the rows it adds."""
    lanes, v, n, k = S.shape
    n_dst = v if n_dst is None else n_dst
    n_e = src.shape[0]
    if chunk_edges is None:
        chunk_edges = max(1, RELAX_CHUNK_BYTES // (lanes * n * k * 4))
    if n_e <= chunk_edges:
        return receive_candidates(edge_candidates(S, changed, src, w, valid),
                                  dst, n_dst)
    R = torch.full((lanes, n_dst, n, k), INF, dtype=S.dtype, device=S.device)
    for e0 in range(0, n_e, chunk_edges):
        part = slice(e0, min(n_e, e0 + chunk_edges))
        d = dst[part].long()
        if dst_offsets is None:
            lo, hi = int(d.min()), int(d.max()) + 1
        else:
            lo, hi = _chunk_range(dst_offsets, part.start, part.stop)
        red = receive_candidates(edge_candidates(
            S, changed, src[part], w[part],
            None if valid is None else valid[part]), d - lo, hi - lo)
        R[:, lo:hi] = semiring.topk_merge(R[:, lo:hi], red)
    return R


def edge_candidates(S: torch.Tensor, changed: torch.Tensor,
                    src: torch.Tensor, w: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """The send half of the relax: ``cand[l, e, ks, k] = S[l, src(e), ks,
    k] + w(e)`` where ``src(e)`` is active, else INF.  [L, E, 2^m, K]."""
    src = src.long()
    send = changed[:, src]                                  # [L, E]
    if valid is not None:
        send = send & valid
    cand = S[:, src] + w[None, :, None, None]
    cand = torch.where(send[:, :, None, None], cand,
                       torch.full_like(cand, INF))
    return semiring.bump_to_inf(cand)


def receive_candidates(cand: torch.Tensor, dst: torch.Tensor,
                       v_pad: int) -> torch.Tensor:
    """The receive half of the relax: every destination keeps the
    per-keyword-set top-K of the candidates that arrive.  [L, V, 2^m, K]."""
    lanes, n_e, n, k = cand.shape
    # Candidate axis = (edge, slot); segment by destination.
    vals = cand.permute(1, 3, 0, 2).reshape(n_e * k, lanes, n)
    seg = dst.long().repeat_interleave(k)
    red = semiring.segment_topk_min(vals, seg, v_pad, k)
    return red.permute(1, 0, 2, 3)                          # [L, V, 2^m, K]


def combine(S: torch.Tensor, cfg: DKSConfig) -> torch.Tensor:
    """Per-node min-plus subset convolution:
    ``S[.., a|b] <- topk(S[.., a|b] ∪ (S[.., a] ⊕ S[.., b]))`` for disjoint
    a, b.  ``S``: [..., V, 2^m, K].

    "torch": batched over all split pairs at once, ``ceil(log2 m)`` passes
    reach the closure.  "cuda": the subset-combine kernel's single
    popcount-ordered sweep.
    """
    if cfg.m <= 1:
        return S
    if cfg.backend == "cuda":
        from repro_torch.kernels.subset_combine import subset_combine
        return subset_combine(S, cfg.m)
    return map_node_chunks(lambda s: _combine_torch(s, cfg), S)


def _combine_torch(S: torch.Tensor, cfg: DKSConfig) -> torch.Tensor:
    """:func:`combine`'s "torch" branch on one chunk of nodes."""
    pairs = spa.split_pairs(cfg.m)
    dev = S.device
    t_ids = torch.tensor([p[0] for p in pairs], device=dev)
    a_ids = torch.tensor([p[1] for p in pairs], device=dev)
    b_ids = torch.tensor([p[2] for p in pairs], device=dev)
    k = cfg.k
    n_pairs = len(pairs)
    seg = t_ids.repeat_interleave(k)
    lead = S.shape[:-2]
    for _ in range(cfg.n_combine_passes()):
        a = S.index_select(-2, a_ids)                       # [..., P, K]
        b = S.index_select(-2, b_ids)
        cand = semiring.outer_combine(a, b)                 # [..., P, K]
        # Reduce candidates into their target keyword-sets: rows
        # (pair, kslot) -> segment t_ids[pair].
        vals = cand.reshape(-1, n_pairs, k).permute(1, 2, 0).reshape(
            n_pairs * k, -1)                                # [(P K), N]
        red = semiring.segment_topk_min(vals, seg, cfg.n_sets, k)
        red = red.permute(1, 0, 2).reshape(*lead, cfg.n_sets, k)
        S = semiring.topk_merge(S, red)
    return S


def node_chunks(v: int, node_bytes: int) -> list[slice]:
    """Slices of a node axis of ``v`` nodes, each at most
    :data:`NODE_CHUNK_BYTES` of rows at ``node_bytes`` a node."""
    step = max(1, NODE_CHUNK_BYTES // max(node_bytes, 1))
    return [slice(lo, min(v, lo + step)) for lo in range(0, v, step)]


def map_node_chunks(fn: Callable[..., torch.Tensor], *tables: torch.Tensor
                    ) -> torch.Tensor:
    """``fn`` of node-local tables ``[..., V, 2^m, K]`` (its result shaped
    like the first), over :func:`node_chunks` of the node axis.  Exact for
    any chunking: ``fn`` reads nothing across nodes."""
    v = tables[0].shape[-3]
    chunks = node_chunks(v, sum(t.numel() * t.element_size()
                                for t in tables) // max(v, 1))
    if len(chunks) <= 1:
        return fn(*tables)
    out = torch.empty_like(tables[0])
    for rows in chunks:
        out[..., rows, :, :] = fn(*(t[..., rows, :, :].contiguous()
                                    for t in tables))
    return out


def aggregate(graph: DeviceGraph, state: DKSState, cfg: DKSConfig
              ) -> DKSState:
    """Aggregators A_S (frontier minima per keyword-set) and A_A (global
    top-K answers: smallest full-set values across all nodes).

    The top-K takes a *stable* ascending sort, so equal weights keep the
    lower (node, slot) index first — the tie order of ``lax.top_k`` in
    ``repro``, which decides ``topk_root`` (``torch.topk`` promises none).
    On a graph split across ranks every rank sorts its own rows and the
    ranks merge their K candidates on (weight, global cell index): the
    same order, without a gathered table.
    """
    S, changed = state.S, state.changed
    S0 = S[..., 0]                                          # [L, V, 2^m]
    masked = torch.where(changed[..., None], S0, torch.full_like(S0, INF))
    mins = across_nodes(graph, torch.stack(
        [masked.min(dim=1).values, S0.min(dim=1).values]), "min")
    s_front = mins[0]
    g = torch.minimum(state.g, mins[1])
    lanes = S.shape[0]
    full_vals = S[:, :, cfg.full, :].reshape(lanes, -1)     # [L, V*K]
    srt = torch.sort(full_vals, dim=1, stable=True)
    topk_w = srt.values[:, :cfg.k]
    cell = srt.indices[:, :cfg.k] + getattr(graph, "node_lo", 0) * cfg.k
    if getattr(graph, "mesh", None) is not None:
        topk_w, cell = _merge_topk(graph.mesh, topk_w, cell, cfg.k,
                                   getattr(graph, "node_axes", None))
    topk_root = torch.div(cell, cfg.k, rounding_mode="floor").to(torch.int32)
    topk_root = torch.where(topk_w >= INF, torch.full_like(topk_root, -1),
                            topk_root)
    return dataclasses.replace(
        state, s_front=s_front, g=g, topk_w=topk_w, topk_root=topk_root)


def _merge_topk(mesh: Any, w: torch.Tensor, cell: torch.Tensor, k: int,
                axes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The K smallest of the K candidates per lane of every rank of
    ``axes`` (None: the mesh's), ordered by (weight, global cell index):
    the head of the stable sort of the whole table, since each rank's
    candidates are the head of its own rows."""
    from repro_torch.distributed import comm

    w = comm.all_gather(w, axes, dim=1, tiled=True, mesh=mesh)
    cell = comm.all_gather(cell, axes, dim=1, tiled=True, mesh=mesh)
    by_cell = torch.argsort(cell, dim=1, stable=True)
    w, cell = w.gather(1, by_cell), cell.gather(1, by_cell)
    by_w = torch.argsort(w, dim=1, stable=True)[:, :k]
    return w.gather(1, by_w), cell.gather(1, by_w)


def exit_check(graph: DeviceGraph, state: DKSState, cfg: DKSConfig
               ) -> DKSState:
    """Sound exit per lane: stop when no future superstep can produce a
    full-set value better than the current K-th best (nu[full] >= W_K),
    when the frontier is empty, or when the message budget is exhausted.
    A lane stopped for none of these but at ``max_supersteps`` is
    ``capped`` (truncated, its answer unproven)."""
    frontier_empty = ~across_nodes(graph, state.changed.any(dim=1), "max")
    done = frontier_empty
    budget_hit = torch.zeros_like(done)
    if cfg.exit_mode == "sound":
        nu = spa.nu_lower_bound(state.g, graph.e_min(), cfg.m)
        w_k = state.topk_w[:, cfg.k - 1]
        done = done | (nu[:, cfg.full] >= torch.clamp(w_k, max=INF))
    msgs = state.msgs_bfs + state.msgs_deep
    if np.isfinite(cfg.message_budget):
        budget_hit = msgs > cfg.message_budget
        done = done | budget_hit
    capped = (state.step >= cfg.max_supersteps) & ~done
    done = done | capped
    return dataclasses.replace(state, done=done, budget_hit=budget_hit,
                               capped=capped)


def freeze_finished(old: DKSState, new: DKSState) -> DKSState:
    """Keep ``old`` in every lane whose exit criterion has already fired.

    The lattice makes extra steps idempotent on ``S``, but
    ``msgs_bfs``/``msgs_deep``/``step`` are counters; without this select
    a finished lane would keep accumulating them.  The host loop applies
    it every superstep, one lane or many.
    """
    done = old.done

    def sel(o: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        d = done.reshape(done.shape + (1,) * (o.dim() - 1))
        return torch.where(d, o, n)

    return DKSState(**{f: sel(getattr(old, f), getattr(new, f))
                       for f in STATE_FIELDS})


def finish_superstep(graph: Any, S0: torch.Tensor, state: DKSState,
                     cfg: DKSConfig, overflow: torch.Tensor | None = None,
                     changed: torch.Tensor | None = None) -> DKSState:
    """The post-combine tail of every superstep flavor (dense and
    frontier-sharded): recompute the active set from the table delta,
    fold visit tracking, run the aggregators and the exit check.
    ``state.S`` holds the combined table; ``S0`` is the pre-relax table;
    counters/step are the caller's.

    ``overflow``: bool[L], the sharded relax's frontier-overflow flag; it
    folds into ``budget_hit`` and ``done`` (frontier overflow is the
    paper's Sec. 5.4 message-budget forced stop).  ``changed``: the
    active set, where the caller has it (:func:`mesh_superstep`, whose
    ``S0`` holds some of the keyword sets).
    """
    if changed is None:
        changed = (state.S < S0).any(dim=3).any(dim=2) & graph.node_valid
    st = dataclasses.replace(
        state,
        changed=changed,
        first_fire=changed & ~state.visited,
        visited=state.visited | changed,
    )
    st = aggregate(graph, st, cfg)
    st = exit_check(graph, st, cfg)
    if overflow is not None:
        st = dataclasses.replace(st, budget_hit=st.budget_hit | overflow,
                                 done=st.done | overflow)
    return st


def message_counts(graph: DeviceGraph, state: DKSState
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """This superstep's (BFS, deep) message counts per lane: the out-degree
    summed over first-time fires and over re-fires (paper Fig. 11), in
    f32.  The integer degrees are summed in int64 and rounded to f32 once,
    so the count is the correctly rounded one on every device and backend.
    Below 2^24 that is ``repro``'s f32 sum in any order; past it,
    ``repro``'s sum depends on XLA's reduction order
    (``tests/test_torch_scale.py``).  Across ranks the int64 sums are
    summed before the one rounding."""
    deg = graph.out_degree.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=deg.device)
    n_bfs = torch.where(state.first_fire, deg, zero).sum(dim=1)
    n_deep = torch.where(state.changed & ~state.first_fire, deg,
                         zero).sum(dim=1)
    n = across_nodes(graph, torch.stack([n_bfs, n_deep]), "sum")
    return n[0].to(torch.float32), n[1].to(torch.float32)


def superstep(graph: DeviceGraph, state: DKSState, cfg: DKSConfig
              ) -> DKSState:
    """One Pregel superstep for every lane (phases 1-4 above), without the
    freeze select (the driver applies it); on a :class:`MeshGraph`,
    :func:`mesh_superstep`."""
    if isinstance(graph, MeshGraph):
        return mesh_superstep(graph, state, cfg)
    S0 = state.S
    n_bfs, n_deep = message_counts(graph, state)
    R = relax(graph, S0, state.changed, cfg)
    S1 = map_node_chunks(
        lambda s, r: combine(semiring.topk_merge(s, r), cfg), S0, R)
    nxt = dataclasses.replace(
        state,
        S=S1,
        msgs_bfs=state.msgs_bfs + n_bfs,
        msgs_deep=state.msgs_deep + n_deep,
        step=state.step + 1,
    )
    return finish_superstep(graph, S0, nxt, cfg)


def mesh_superstep(graph: MeshGraph, state: DKSState, cfg: DKSConfig
                   ) -> DKSState:
    """:func:`superstep` on one rank of ``graph.mesh``: ``S`` is this
    rank's [L, V / dp, 2^m / tp, K] (node rows over the ``dp`` ranks of
    ``node_axes``, keyword sets over the ``tp`` of ``set_axes``), the node
    masks its [L, V / dp], the rest whole.  Every field equals the
    one-process superstep's rows and sets of it, bit for bit:

    1. the message counts are int64 sums over the rows, summed over the
       data ranks before the one rounding;
    2. the relax gathers this rank's sets of ``S`` and ``changed`` over the
       data ranks, takes the candidates of the rank's edges into every
       destination, in chunks, and sends each destination's rows to the
       rank that holds them (one ``all_to_all``); the pieces merge with
       ``topk_merge``, whose K smallest distinct values of a union do not
       depend on the order of its parts;
    3. the merged rows gather their sets over ``set_axes`` for the
       closure, which reads every set of a node; each rank keeps its sets,
       and ``changed`` is the ``pmax`` over ``set_axes`` of its sets'
       changes;
    4. the aggregators read the whole sets of the rank's rows and reduce
       over the data ranks (the top-K in ``lax.top_k``'s order), the exit
       check too (``e_min`` a ``pmin`` of each rank's edges): the fields
       whole on every rank come out equal on every rank."""
    from repro_torch.distributed import comm

    mesh, nodes, sets = graph.mesh, graph.node_axes, graph.set_axes
    S0 = state.S
    n_bfs, n_deep = message_counts(graph, state)
    S_all = comm.all_gather(S0, nodes, dim=1, tiled=True, mesh=mesh)
    changed_all = comm.all_gather(state.changed, nodes, dim=1, tiled=True,
                                  mesh=mesh)
    offsets = graph.in_offsets_host
    R = relax_edges(S_all, changed_all, graph.src, graph.dst, graph.w,
                    graph.valid, dst_offsets=None if offsets is None
                    else offsets - graph.edge_lo)
    del S_all, changed_all
    # [L, dp, V / dp, 2^m / tp, K]: piece j, the rows data rank j's edges
    # sent to this rank's rows.
    pieces = comm.all_to_all(R.unflatten(1, (mesh.axis_size(nodes), -1)),
                             nodes, split_dim=1, concat_dim=1, mesh=mesh)
    del R

    def merge(s, parts):
        for part in parts.unbind(1):
            s = semiring.topk_merge(s, part)
        return s

    merged = map_node_chunks(merge, S0, pieces)
    del pieces
    S1_all = combine(comm.all_gather(merged, sets, dim=2, tiled=True,
                                     mesh=mesh), cfg)
    width = S0.shape[2]
    j = mesh.axis_index(sets)
    S1 = S1_all[:, :, j * width:(j + 1) * width].contiguous()
    changed = comm.pmax((S1 < S0).any(dim=3).any(dim=2), sets,
                        mesh=mesh) & graph.node_valid
    nxt = dataclasses.replace(
        state,
        S=S1_all,
        msgs_bfs=state.msgs_bfs + n_bfs,
        msgs_deep=state.msgs_deep + n_deep,
        step=state.step + 1,
    )
    nxt = finish_superstep(graph, S0, nxt, cfg, changed=changed)
    return dataclasses.replace(nxt, S=S1)


# --------------------------------------------------------------------------
# Drivers
# --------------------------------------------------------------------------


def run_dks(graph: DeviceGraph, kw_masks: torch.Tensor, cfg: DKSConfig
            ) -> DKSState:
    """Full DKS run of one query (``kw_masks``: bool[m, V]): the 1-lane
    case of the lane driver.  The state keeps its lane axis of 1."""
    from repro_torch.core.driver import run_lanes

    return run_lanes(graph, kw_masks[None], cfg)


def run_dks_batched(graph: DeviceGraph, kw_masks_batch: torch.Tensor,
                    cfg: DKSConfig) -> DKSState:
    """Serve a batch of queries (``kw_masks_batch``: bool[Q, m, V]) as the
    lanes of one driver run; finished lanes freeze, so their counters stop
    with them.  An alias of :func:`repro_torch.core.driver.run_lanes`."""
    from repro_torch.core.driver import run_lanes

    return run_lanes(graph, kw_masks_batch, cfg)


def _sync(t: torch.Tensor) -> None:
    """End a timed phase: wait for the card, so that its time is honest."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def run_dks_instrumented(
    graph: DeviceGraph,
    kw_masks: torch.Tensor,
    cfg: DKSConfig,
    exit_hook: Callable[[DKSState], bool] | None = None,
) -> tuple[DKSState, dict[str, Any]]:
    """Host-driven superstep loop with per-phase wall times (paper Table 1)
    for one query (``kw_masks``: bool[m, V]; the final state keeps a lane
    axis of 1).

    The phases are the torch ones whatever the backend (``"cuda"`` reaches
    the subset-combine kernel in "evaluate", as ``repro``'s ``"pallas"``
    reaches its combine kernel): send_bfs (gather + add candidates),
    receive (segment top-K + merge), evaluate (subset combine), send_agg
    (aggregators + exit).  See :func:`host_instrumented_loop` for
    ``exit_hook`` and ``info``.
    """
    return host_instrumented_loop(
        graph, kw_masks, cfg, exit_hook,
        phase_relax=lambda S, changed: edge_candidates(
            S, changed, graph.src, graph.w, graph.valid),
        phase_receive=lambda S, cand: semiring.topk_merge(
            S, receive_candidates(cand, graph.dst, graph.v_pad)),
        phase_combine=lambda S: combine(S, cfg),
        phase_agg=lambda S0, state, _cand: finish_superstep(
            graph, S0, state, cfg))


def host_instrumented_loop(
    graph: Any,
    kw_masks: torch.Tensor,
    cfg: DKSConfig,
    exit_hook: Callable[[DKSState], bool] | None,
    phase_relax: Callable,
    phase_receive: Callable,
    phase_combine: Callable,
    phase_agg: Callable,
) -> tuple[DKSState, dict[str, Any]]:
    """The timed superstep loop shared by the dense and the sharded
    instrumented runners: one copy of the timing buckets, the message
    accounting, the history rows and the ``exit_hook`` contract.  Each
    phase is ended by a device synchronisation, so its time is honest::

      phase_relax(S, changed) -> aux           "send_bfs"
      phase_receive(S, aux) -> S1              "receive"
      phase_combine(S1) -> S1                  "evaluate"
      phase_agg(S0, state, aux) -> state       "send_agg"

    ``aux`` is what the relax hands forward (the per-edge candidates on
    the dense path; ``(R, overflow)`` on the sharded one).
    ``exit_hook``: an optional host-side exit criterion evaluated between
    supersteps on the 1-lane state (on a graph split across ranks, this
    rank's rows of it: the hook must answer the same on every rank, as
    :func:`repro_torch.core.fagin.paper_exit_hook` does).  Per-superstep
    rows accumulate on a :class:`HostTelemetryCollector`; ``info``
    carries ``timings``, ``history`` (the collector's rows) and
    ``telemetry``.
    """
    timings = {"send_bfs": 0.0, "receive": 0.0, "evaluate": 0.0,
               "send_agg": 0.0}
    state = init_state(graph, kw_masks[None], cfg)
    _sync(state.S)
    collector = HostTelemetryCollector()
    while not bool(state.done[0]):
        n_bfs, n_deep = message_counts(graph, state)

        t0 = time.perf_counter()
        aux = phase_relax(state.S, state.changed)
        _sync(state.S)
        t1 = time.perf_counter()
        S1 = phase_receive(state.S, aux)
        _sync(S1)
        t2 = time.perf_counter()
        S1 = phase_combine(S1)
        _sync(S1)
        t3 = time.perf_counter()
        S0 = state.S
        state = dataclasses.replace(
            state,
            S=S1,
            msgs_bfs=state.msgs_bfs + n_bfs,
            msgs_deep=state.msgs_deep + n_deep,
            step=state.step + 1,
        )
        state = phase_agg(S0, state, aux)
        _sync(state.S)
        t4 = time.perf_counter()
        del aux

        timings["send_bfs"] += t1 - t0
        timings["receive"] += t2 - t1
        timings["evaluate"] += t3 - t2
        timings["send_agg"] += t4 - t3
        collector.record(
            frontier=int(across_nodes(graph, state.changed[0].sum(),
                                      "sum")),
            msgs_bfs=float(state.msgs_bfs[0]),
            msgs_deep=float(state.msgs_deep[0]),
            frozen=int(state.done.sum()),
            best=float(state.topk_w[0, 0]),
        )
        if exit_hook is not None and exit_hook(state):
            state = dataclasses.replace(
                state, done=torch.ones_like(state.done))
    telemetry = collector.build()
    info = dict(timings=timings, history=telemetry.rows(),
                telemetry=telemetry)
    return state, info


def extract_answer_weights(state: DKSState, cfg: DKSConfig) -> np.ndarray:
    """Global top-K distinct answer weights (INF-padded), per lane."""
    return state.topk_w.cpu().numpy()
