"""The lane-batched superstep driver — one step function for every surface.

The twin of ``repro.core.driver``: a :class:`DKSState` whose every field
carries a leading lane axis (``L`` concurrent queries) and one
``lane_superstep(graph, state, cfg)`` that advances all lanes, on both
partitionings — a dense :class:`DeviceGraph` or a sharded
:class:`~repro_torch.core.dks_sharded.FrontierGraph`, whose lanes share
one frontier exchange per superstep.
``repro`` runs the loop as one ``lax.while_loop``; torch has none, so
:func:`run_lanes` is a host loop that reads ``done`` after every superstep
and freezes finished lanes every time, one lane or many (a finished lane's
counters must stop with it).  :func:`run_lanes_telemetry` is the same loop
with a per-superstep counter row written into a device buffer.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.dks import (
    STATE_FIELDS,
    DKSConfig,
    DKSState,
    freeze_finished,
    init_state,
    superstep,
)
from repro_torch.obs.telemetry import (
    N_COLS as TELEMETRY_COLS,
    TELEMETRY_MAX_SUPERSTEPS,
)


def is_frontier_graph(graph: Any) -> bool:
    """Sharded (FrontierGraph) vs dense (DeviceGraph) residency, without
    importing dks_sharded at module load (it imports from dks)."""
    return hasattr(graph, "edge_dst_l")


def lane_view(state: DKSState, i: int) -> DKSState:
    """One lane of a lane-batched state, keeping a lane axis of 1."""
    return DKSState(**{f: getattr(state, f)[i:i + 1] for f in STATE_FIELDS})


def lane_init(graph: Any, kw_masks: torch.Tensor, cfg: DKSConfig
              ) -> DKSState:
    """Superstep 0 for a batch of lanes.  ``kw_masks``: bool[L, m, V]."""
    return init_state(graph, kw_masks, cfg)


# Per-lane freeze: lanes whose exit criterion fired keep their state and
# counters while the driver steps the rest.
freeze_lanes = freeze_finished


def lane_superstep(graph: Any, state: DKSState, cfg: DKSConfig
                   ) -> DKSState:
    """One Pregel superstep for every lane at once, finished lanes frozen.

    A :class:`~repro_torch.core.dks_sharded.FrontierGraph`: relax every
    lane's frontier through one exchange, then the node-local tail (the
    shard body stays stock torch, as ``repro``'s stays jnp).  Otherwise
    ``cfg.backend == "cuda"``: the whole inner loop (relax + receive +
    combine + per-lane freeze) is ONE kernel launch over the lane axis;
    "torch": the stock torch superstep.
    """
    if is_frontier_graph(graph):
        from repro_torch.core.dks_sharded import superstep_frontier

        nxt = superstep_frontier(graph, state, cfg)
    elif cfg.backend == "cuda":
        from repro_torch.kernels.lane_superstep import fused_lane_superstep

        nxt = fused_lane_superstep(graph, state, cfg)
    else:
        nxt = superstep(graph, state, cfg)
    return freeze_lanes(state, nxt)


def run_lanes(graph: Any, kw_masks: torch.Tensor, cfg: DKSConfig
              ) -> DKSState:
    """Full lane-batched DKS run: steps until every lane's exit criterion
    fires, checking ``done`` on the host after every superstep."""
    state = lane_init(graph, kw_masks, cfg)
    while not bool(state.done.all()):
        state = lane_superstep(graph, state, cfg)
    return state


# --------------------------------------------------------------------------
# Superstep telemetry (paper §6's per-superstep curves, from the driver's
# own loop)
# --------------------------------------------------------------------------


def telemetry_capacity(cfg: DKSConfig) -> int:
    """Device-buffer row count for a config: one row per superstep, capped
    at TELEMETRY_MAX_SUPERSTEPS (a capped run sets ``done`` anyway, so the
    cap only matters for configs with a larger max_supersteps)."""
    return max(1, min(int(cfg.max_supersteps), TELEMETRY_MAX_SUPERSTEPS))


def telemetry_row(state: DKSState) -> torch.Tensor:
    """One lane-summed counter row for the post-step state: ``[frontier,
    msgs_bfs (cumulative), msgs_deep (cumulative), frozen lanes]`` — the
    column order repro_torch.obs.telemetry decodes.  Pure reads, so
    telemetry-on is bit-identical to telemetry-off."""
    return torch.stack([
        state.changed.sum().to(torch.float32),
        state.msgs_bfs.sum(),
        state.msgs_deep.sum(),
        state.done.sum().to(torch.float32),
    ])


def run_lanes_telemetry(graph: Any, kw_masks: torch.Tensor,
                        cfg: DKSConfig) -> tuple[DKSState, torch.Tensor, int]:
    """:func:`run_lanes` with a telemetry carry: one :func:`telemetry_row`
    per superstep written into a bounded ``[T, 4]`` f32 device buffer
    (rows past T overwrite the last slot — the decoder flags truncation),
    with no host sync beyond the loop's own ``done`` check.  Returns
    ``(final state, buffer, supersteps run)``; the state trajectory is
    exactly :func:`run_lanes`'s."""
    T = telemetry_capacity(cfg)
    state = lane_init(graph, kw_masks, cfg)
    buf = torch.zeros((T, TELEMETRY_COLS), dtype=torch.float32,
                      device=state.S.device)
    i = 0
    while not bool(state.done.all()):
        state = lane_superstep(graph, state, cfg)
        buf[min(i, T - 1)] = telemetry_row(state)
        i += 1
    return state, buf, i
