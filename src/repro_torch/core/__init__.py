"""DKS — distributed keyword search (top-K Group Steiner Trees) in the
Pregel model, as dense torch tensor algebra with an explicit lane axis.

Public API:
  DKSConfig, DKSState                       — static config / superstep state
  init_state, superstep, freeze_finished    — the loop's building blocks
  run_dks, run_dks_batched                  — whole runs (1 lane, a batch)
  run_dks_instrumented, extract_answer_weights — per-phase times, weights
  run_lanes, lane_init, lane_superstep      — the lane-batched host driver
  run_lanes_telemetry, telemetry_row         — the telemetry carry
  lane_view, freeze_lanes                   — lane-batch helpers
  collect_answers, extract_answers, AnswerTree — host answer trees
  dreyfus_wagner, brute_force_topk          — exact oracles (tests)
"""

from repro_torch.core.dks import (  # noqa: F401
    DKSConfig,
    DKSState,
    extract_answer_weights,
    freeze_finished,
    init_state,
    run_dks,
    run_dks_batched,
    run_dks_instrumented,
    superstep,
)
from repro_torch.core.driver import (  # noqa: F401
    freeze_lanes,
    lane_init,
    lane_superstep,
    lane_view,
    run_lanes,
    run_lanes_telemetry,
    telemetry_capacity,
    telemetry_row,
)
from repro_torch.core.reconstruct import (  # noqa: F401
    AnswerTree,
    collect_answers,
    extract_answers,
    finish_tree,
)
from repro_torch.core.steiner_ref import (  # noqa: F401
    brute_force_topk,
    dreyfus_wagner,
)
