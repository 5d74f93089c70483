"""Frontier-compressed sharded DKS — the twin of ``repro.core.dks_sharded``.

Pregel semantics only need the tables of *active* vertices on the wire,
not the whole ``S`` table.  The node axis is split into ``n_shards``
contiguous shards of ``n_loc`` nodes, and the edges are partitioned by
the shard that owns their destination (host-side, once).  One superstep:

  1. every shard packs ``(global id, table)`` for up to ``f_cap`` of its
     changed nodes, per lane, and flags overflow;
  2. one all-gather (:func:`all_gather_frontier`) moves only the packed
     frontiers, for all lanes at once;
  3. every shard relaxes its own edges against the gathered frontier
     through a sorted-id binary search, reducing per destination with
     the exact segment-top-K.

Frontier overflow (more than ``f_cap`` active nodes on some shard) raises
``budget_hit``: the paper's Sec. 5.4 forced stop, so the run finishes
with the SPA bound instead of silently dropping messages.

``repro`` runs the shard body under ``shard_map`` with one controller
driving a device mesh.  Here every shard lives on the graph's one device,
and the shard bodies run batched over a leading shard axis: each reads
only its own rows of the edge arrays and the gathered frontier.  The
collective is the one function :func:`all_gather_frontier` (a
concatenation along the frontier axis, as ``all_gather(tiled=True,
axis=1)`` gives every shard), so an exchange across cards or processes
replaces that function alone.  The lane axis stays inside the shard
body, so a bucket of queries shares one exchange per superstep.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import INF
from repro_torch.core import semiring
from repro_torch.core.dks import (
    DKSConfig,
    DKSState,
    combine,
    finish_superstep,
    host_instrumented_loop,
    message_counts,
    receive_candidates,
)
from repro_torch.device import host_tensor, resolve_device
from repro_torch.graph.structure import Graph

# Global id of an empty frontier slot: 2^30 + its local index.  It repeats
# across shards; the relax's hit test (ids equal and the source real) is
# what makes the repeats harmless.
INVALID_GID = 1 << 30


@dataclasses.dataclass(frozen=True)
class FrontierGraph:
    """Edges partitioned by destination owner; node arrays over ``V_pad``.

    edge_src:   i32[n_shards, e_cap]  global source ids (-1 pad)
    edge_dst_l: i32[n_shards, e_cap]  destination LOCAL index on its shard
    edge_w:     f32[n_shards, e_cap]  (INF pad)
    out_degree: i32[V_pad]; node_valid: bool[V_pad], with
    ``V_pad = ceil(V / n_shards) * n_shards`` (padded nodes are invalid:
    they never fire and never receive).
    """

    edge_src: torch.Tensor
    edge_dst_l: torch.Tensor
    edge_w: torch.Tensor
    out_degree: torch.Tensor
    node_valid: torch.Tensor
    n_nodes: int
    n_edges: int
    n_shards: int

    @property
    def device(self) -> torch.device:
        return self.edge_src.device

    @property
    def v_pad(self) -> int:
        return self.node_valid.shape[0]

    @property
    def n_loc(self) -> int:
        return self.v_pad // self.n_shards

    @property
    def e_cap(self) -> int:
        return self.edge_src.shape[1]

    def e_min(self) -> torch.Tensor:
        """Smallest real edge length (the paper's ``e_min``), f32[]."""
        return torch.where(self.edge_w < INF, self.edge_w,
                           torch.full_like(self.edge_w, INF)).min()


def pack_frontier_graph(g: Graph, n_shards: int,
                        device: str | torch.device | None = None,
                        ) -> FrontierGraph:
    """Host-side: the symmetrized edges grouped by destination owner into
    padded rows, exactly as ``repro``'s packer lays them out, then put on
    ``device`` (``None``: the card)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    v_pad = int(-(-g.n_nodes // n_shards) * n_shards)
    n_loc = v_pad // n_shards
    deg = np.diff(g.indptr)
    src = np.repeat(np.arange(g.n_nodes, dtype=np.int32), deg)
    dst = g.indices.astype(np.int32)
    w = g.ew.astype(np.float32)
    owner = dst // n_loc
    counts = np.bincount(owner, minlength=n_shards)
    e_cap = int(max(8, -(-int(counts.max()) // 8) * 8))
    edge_src = np.full((n_shards, e_cap), -1, np.int32)
    edge_dst_l = np.zeros((n_shards, e_cap), np.int32)
    edge_w = np.full((n_shards, e_cap), INF, np.float32)
    order = np.argsort(owner, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    starts = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        lo, hi = starts[s], starts[s + 1]
        edge_src[s, : hi - lo] = src[lo:hi]
        edge_dst_l[s, : hi - lo] = dst[lo:hi] - s * n_loc
        edge_w[s, : hi - lo] = w[lo:hi]
    out_degree = np.zeros(v_pad, np.int32)
    out_degree[: g.n_nodes] = deg
    node_valid = np.zeros(v_pad, bool)
    node_valid[: g.n_nodes] = True
    return FrontierGraph(
        edge_src=host_tensor(edge_src, dev),
        edge_dst_l=host_tensor(edge_dst_l, dev),
        edge_w=host_tensor(edge_w, dev),
        out_degree=host_tensor(out_degree, dev),
        node_valid=host_tensor(node_valid, dev),
        n_nodes=g.n_nodes, n_edges=len(src), n_shards=n_shards)


def frontier_cap(graph: FrontierGraph, cfg: DKSConfig) -> int:
    """Per-shard, per-lane frontier capacity ``f_cap``, as ``repro``
    computes it."""
    n_loc = graph.n_loc
    return min(n_loc, max(1, int(n_loc * cfg.frontier_frac)))


def pack_frontiers(graph: FrontierGraph, S: torch.Tensor,
                   changed: torch.Tensor, f_cap: int,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every shard's send half: per lane, the ascending local ids of up to
    ``f_cap`` changed nodes with their tables.  ``S``: [L, V_pad, 2^m, K];
    ``changed``: bool[L, V_pad].  Returns ``gids`` i32[L, n_shards,
    f_cap] (global ids; empty slots :data:`INVALID_GID` + slot),
    ``tab`` [L, n_shards, f_cap, 2^m, K] (INF in empty slots) and
    ``overflow`` bool[L, n_shards]."""
    lanes, _, n_sets, k = S.shape
    ns, n_loc = graph.n_shards, graph.n_loc
    S_sh = S.reshape(lanes, ns, n_loc, n_sets, k)
    ch = changed.reshape(lanes, ns, n_loc)
    # Sorting a keyed arange == nonzero(size=f_cap, fill_value=n_loc),
    # lane- and shard-batched.
    arange = torch.arange(n_loc, dtype=torch.int32, device=S.device)
    key = torch.where(ch, arange, torch.full_like(arange, n_loc))
    idx = torch.sort(key, dim=2).values[:, :, :f_cap]      # [L, ns, f_cap]
    fvalid = idx < n_loc
    rows = torch.clamp(idx, max=n_loc - 1).long()
    tab = torch.gather(S_sh, 2, rows[..., None, None].expand(
        lanes, ns, f_cap, n_sets, k))
    tab = torch.where(fvalid[..., None, None], tab,
                      torch.full_like(tab, INF))
    offset = (torch.arange(ns, dtype=torch.int32, device=S.device)
              * n_loc)[None, :, None]
    gids = torch.where(fvalid, idx + offset, idx + INVALID_GID)
    overflow = ch.sum(dim=2) > f_cap
    return gids, tab, overflow


def all_gather_frontier(gids: torch.Tensor, tab: torch.Tensor,
                        overflow: torch.Tensor,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """THE exchange: every shard's packed frontier, concatenated in shard
    order along the frontier axis (``repro``'s ``all_gather(tiled=True,
    axis=1)``), and the overflow flag reduced over shards (its ``pmax``).
    All shards share one device, so one gathered copy serves them all.
    Returns ``(gids i32[L, F_tot], tab [L, F_tot, 2^m, K], overflow
    bool[L])`` with ``F_tot = n_shards * f_cap``."""
    lanes, ns, f_cap = gids.shape
    return (gids.reshape(lanes, ns * f_cap),
            tab.reshape(lanes, ns * f_cap, *tab.shape[3:]),
            overflow.any(dim=1))


def relax_shard_edges(graph: FrontierGraph, all_gids: torch.Tensor,
                      all_tab: torch.Tensor) -> torch.Tensor:
    """Every shard's receive half: relax the shard's own edges against the
    gathered frontier and keep each local destination's top-K.  A source
    is found by binary search in the sorted gathered ids (left side, as
    ``jnp.searchsorted``).  Returns R [L, V_pad, 2^m, K]."""
    lanes, f_tot = all_gids.shape
    order = torch.argsort(all_gids, dim=1, stable=True)
    sg = torch.gather(all_gids, 1, order)
    src_g = graph.edge_src.reshape(1, -1).expand(lanes, -1).contiguous()
    pos = torch.clamp(torch.searchsorted(sg, src_g), 0, f_tot - 1)
    hit = (torch.gather(sg, 1, pos) == src_g) & (src_g >= 0)
    # The table row of each edge's source: sorted position -> gathered slot.
    slot = torch.gather(order, 1, pos)
    lane = torch.arange(lanes, device=all_tab.device)[:, None]
    cand = all_tab[lane, slot] + graph.edge_w.reshape(1, -1, 1, 1)
    cand = torch.where(hit[:, :, None, None], cand,
                       torch.full_like(cand, INF))
    cand = semiring.bump_to_inf(cand)
    # Shard s's local destination d is global node s * n_loc + d: the
    # shards' segments are disjoint, so one reduce serves them all.
    base = torch.arange(graph.n_shards, dtype=torch.int32,
                        device=all_tab.device)[:, None] * graph.n_loc
    dst = (graph.edge_dst_l + base).reshape(-1)
    return receive_candidates(cand, dst, graph.v_pad)


def relax_frontier_lanes(graph: FrontierGraph, S: torch.Tensor,
                         changed: torch.Tensor, cfg: DKSConfig,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lane-batched frontier-compressed relax: pack, one exchange, relax.
    ``S``: [L, V_pad, 2^m, K]; ``changed``: bool[L, V_pad].  Returns
    ``(R [L, V_pad, 2^m, K], overflow bool[L])``."""
    f_cap = frontier_cap(graph, cfg)
    all_gids, all_tab, overflow = all_gather_frontier(
        *pack_frontiers(graph, S, changed, f_cap))
    return relax_shard_edges(graph, all_gids, all_tab), overflow


def relax_frontier(graph: FrontierGraph, S: torch.Tensor,
                   changed: torch.Tensor, cfg: DKSConfig,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Frontier-compressed relax of one query (``S``: [V_pad, 2^m, K]):
    the 1-lane case of :func:`relax_frontier_lanes`.  Returns
    ``(R [V_pad, 2^m, K], overflow bool[])``."""
    R, overflow = relax_frontier_lanes(graph, S[None], changed[None], cfg)
    return R[0], overflow[0]


def frontier_tail(graph: FrontierGraph, state: DKSState, R: torch.Tensor,
                  overflow: torch.Tensor, cfg: DKSConfig) -> DKSState:
    """Everything after the frontier relax, for every lane: message
    accounting, top-K merge, subset combine and the shared superstep
    finish (node-local: no exchange)."""
    S0 = state.S
    n_bfs, n_deep = message_counts(graph, state)
    S1 = combine(semiring.topk_merge(S0, R), cfg)
    nxt = dataclasses.replace(
        state, S=S1,
        msgs_bfs=state.msgs_bfs + n_bfs, msgs_deep=state.msgs_deep + n_deep,
        step=state.step + 1,
    )
    return finish_superstep(graph, S0, nxt, cfg, overflow=overflow)


def superstep_frontier(graph: FrontierGraph, state: DKSState,
                       cfg: DKSConfig) -> DKSState:
    """One superstep with frontier-compressed communication, for every
    lane, without the freeze select (the driver applies it)."""
    R, overflow = relax_frontier_lanes(graph, state.S, state.changed, cfg)
    return frontier_tail(graph, state, R, overflow, cfg)


def run_dks_frontier(graph: FrontierGraph, kw_masks: torch.Tensor,
                     cfg: DKSConfig) -> DKSState:
    """Full frontier-sharded DKS run of one query (``kw_masks``: bool[m,
    V_pad]): the 1-lane case of the lane driver, which takes the sharded
    superstep on a :class:`FrontierGraph`.  The state keeps its lane axis
    of 1."""
    from repro_torch.core.driver import run_lanes

    return run_lanes(graph, kw_masks[None], cfg)


def run_dks_frontier_instrumented(
    graph: FrontierGraph,
    kw_masks: torch.Tensor,
    cfg: DKSConfig,
    exit_hook: Callable[[DKSState], bool] | None = None,
) -> tuple[DKSState, dict[str, Any]]:
    """Host-driven frontier-sharded loop with per-phase wall times — the
    sharded counterpart of :func:`repro_torch.core.dks.run_dks_instrumented`
    (same ``timings`` keys, history rows and ``exit_hook`` contract).

    The pack, the exchange and the edge relax land together in
    "send_bfs", as in ``repro``, whose ``shard_map`` fuses them; "receive"
    is the top-K merge of what arrived; "evaluate" (subset combine) and
    "send_agg" (aggregators, exit check, overflow) match the dense
    buckets."""
    return host_instrumented_loop(
        graph, kw_masks, cfg, exit_hook,
        phase_relax=lambda S, changed: relax_frontier_lanes(
            graph, S, changed, cfg),
        phase_receive=lambda S, aux: semiring.topk_merge(S, aux[0]),
        phase_combine=lambda S: combine(S, cfg),
        phase_agg=lambda S0, state, aux: finish_superstep(
            graph, S0, state, cfg, overflow=aux[1]))
