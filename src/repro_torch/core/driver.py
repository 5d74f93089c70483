"""The lane-batched superstep driver — one step function for every surface.

The twin of ``repro.core.driver`` on dense graphs: a :class:`DKSState`
whose every field carries a leading lane axis (``L`` concurrent queries)
and one ``lane_superstep(graph, state, cfg)`` that advances all lanes.
``repro`` runs the loop as one ``lax.while_loop``; torch has none, so
:func:`run_lanes` is a host loop that reads ``done`` after every superstep
and freezes finished lanes every time, one lane or many (a finished lane's
counters must stop with it).
"""

from __future__ import annotations

import torch

from repro_torch.core.dks import (
    STATE_FIELDS,
    DKSConfig,
    DKSState,
    freeze_finished,
    init_state,
    superstep,
)
from repro_torch.graph.structure import DeviceGraph


def lane_view(state: DKSState, i: int) -> DKSState:
    """One lane of a lane-batched state, keeping a lane axis of 1."""
    return DKSState(**{f: getattr(state, f)[i:i + 1] for f in STATE_FIELDS})


def lane_init(graph: DeviceGraph, kw_masks: torch.Tensor, cfg: DKSConfig
              ) -> DKSState:
    """Superstep 0 for a batch of lanes.  ``kw_masks``: bool[L, m, V]."""
    return init_state(graph, kw_masks, cfg)


# Per-lane freeze: lanes whose exit criterion fired keep their state and
# counters while the driver steps the rest.
freeze_lanes = freeze_finished


def lane_superstep(graph: DeviceGraph, state: DKSState, cfg: DKSConfig
                   ) -> DKSState:
    """One Pregel superstep for every lane at once, finished lanes frozen.

    ``cfg.backend == "cuda"``: the whole inner loop (relax + receive +
    combine + per-lane freeze) is ONE kernel launch over the lane axis;
    "torch": the stock torch superstep.
    """
    if cfg.backend == "cuda":
        from repro_torch.kernels.lane_superstep import fused_lane_superstep

        nxt = fused_lane_superstep(graph, state, cfg)
    else:
        nxt = superstep(graph, state, cfg)
    return freeze_lanes(state, nxt)


def run_lanes(graph: DeviceGraph, kw_masks: torch.Tensor, cfg: DKSConfig
              ) -> DKSState:
    """Full lane-batched DKS run: steps until every lane's exit criterion
    fires, checking ``done`` on the host after every superstep."""
    state = lane_init(graph, kw_masks, cfg)
    while not bool(state.done.all()):
        state = lane_superstep(graph, state, cfg)
    return state
