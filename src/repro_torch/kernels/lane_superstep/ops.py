"""Host-facing wrapper of the lane-superstep kernel
(``csrc/lane_superstep.cu``).

The kernel reads the dst-sorted :class:`DeviceGraph` edge list directly,
through the per-node ranges ``DeviceGraph.in_offsets`` that
``Graph.to_device`` builds once per graph (where ``repro`` builds its
block-aligned ``LaneCSR``), so no padded per-row layout exists.  A node
with more than ``HUB_IN_DEGREE`` in-edges is a hub: the kernel gives each
(lane, hub) a warp, from the list ``DeviceGraph.hub_nodes`` (or
``hub_nodes(offsets)``, re-exported here, for any other edge list), where
``repro`` splits a hub into virtual rows.

- :func:`fused_lane_step` — the kernel call: one launch per superstep for
  every lane (plain version on a CPU tensor).
- :func:`fused_lane_superstep` — the drop-in replacement of the lane
  driver's torch superstep: counters, the kernel, and the shared torch
  tail (:func:`~repro_torch.core.dks.finish_superstep`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dks import (DKSConfig, DKSState, finish_superstep,
                                  message_counts)
from repro_torch.graph.structure import (
    HUB_IN_DEGREE, DeviceGraph, hub_nodes)
from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
from repro_torch.kernels.subset_combine.ops import check_range

counter = LaunchCounter()


def fused_lane_step(S0: torch.Tensor, changed: torch.Tensor,
                    done: torch.Tensor, offsets: torch.Tensor,
                    src: torch.Tensor, w: torch.Tensor, m: int,
                    hubs: torch.Tensor | None = None) -> torch.Tensor:
    """The superstep's inner loop for every lane (relax, receive, combine,
    per-lane freeze).  Shapes as :func:`.ref.fused_lane_step_ref`; ``hubs``
    is :func:`hub_nodes` of ``offsets`` (computed here when omitted): the
    kernel gives a warp to each (lane, node in it) and skips every node
    past ``HUB_IN_DEGREE`` in-edges on its one-thread-per-node path, so a
    hub left out of the list keeps an unwritten row (entries that are not
    hubs are skipped).  The plain version needs no list."""
    if hubs is None:
        hubs = hub_nodes(offsets)
    if S0.dtype != torch.float32 or S0.dim() != 4 or S0.shape[2] != 1 << m:
        raise ValueError(f"fused_lane_step wants S0 f32[L, V, {1 << m}, K], "
                         f"got {S0.dtype}{list(S0.shape)}")
    lanes, v, _, k = S0.shape
    want = {"changed": (changed, torch.bool, (lanes, v)),
            "done": (done, torch.bool, (lanes,)),
            "offsets": (offsets, torch.int64, (v + 1,)),
            "src": (src, torch.int32, None),
            "w": (w, torch.float32, src.shape),
            "hubs": (hubs, torch.int32, (hubs.numel(),))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or (shape is not None and t.shape != shape):
            raise ValueError(f"fused_lane_step: {name} must be {dtype} of "
                             f"shape {shape}, got {t.dtype}{list(t.shape)}")
        if t.device != S0.device:
            raise ValueError(f"fused_lane_step: {name} is on {t.device}, "
                             f"S0 on {S0.device}")
    tensors = (S0, changed, done, offsets, src, w)
    if not all(t.is_contiguous() for t in (*tensors, hubs)):
        raise ValueError("fused_lane_step wants contiguous tensors")
    if S0.device.type == "cpu":
        return fused_lane_step_ref(*tensors, m)
    check_range(m, k, "fused_lane_step")
    if S0.device.type != "cuda":
        raise ValueError(f"fused_lane_step: unsupported device {S0.device}")
    fn = cuda_build.library("lane_superstep").dks_lane_superstep
    out = torch.empty_like(S0)
    err = fn(*(t.data_ptr() for t in (*tensors, hubs)), out.data_ptr(),
             lanes, v, hubs.shape[0], HUB_IN_DEGREE, m, k,
             torch.cuda.current_stream(S0.device).cuda_stream)
    counter.add()
    cuda_build.check(err, "fused_lane_step")
    return out


def fused_lane_superstep(graph: DeviceGraph, state: DKSState,
                         cfg: DKSConfig) -> DKSState:
    """One superstep for every lane, inner loop as ONE kernel launch.
    Returns the stepped state without the driver's freeze select (the
    kernel keeps a finished lane's table; the driver keeps its counters)."""
    S0 = state.S
    n_bfs, n_deep = message_counts(graph, state)
    S1 = fused_lane_step(S0.contiguous(), state.changed.contiguous(),
                         state.done, graph.in_offsets, graph.src, graph.w,
                         cfg.m, graph.hub_nodes)
    nxt = dataclasses.replace(
        state,
        S=S1,
        msgs_bfs=state.msgs_bfs + n_bfs,
        msgs_deep=state.msgs_deep + n_deep,
        step=state.step + 1,
    )
    return finish_superstep(graph, S0, nxt, cfg)


def __getattr__(name: str):
    # ``ops.launches``: the total of ``counter`` over every thread (and,
    # for flash, ``ops.launches_by_route``), read like a plain attribute.
    if name == "launches":
        return counter.total
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
