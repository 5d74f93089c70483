"""DKS — distributed keyword search (top-K Group Steiner Trees) in the
Pregel model, as dense torch tensor algebra with an explicit lane axis.

Public API:
  DKSConfig, DKSState                       — static config / superstep state
  init_state, superstep, freeze_finished    — the loop's building blocks
  run_lanes, lane_init, lane_superstep      — the lane-batched host driver
  lane_view, freeze_lanes                   — lane-batch helpers
  collect_answers, extract_answers, AnswerTree — host answer trees
  dreyfus_wagner, brute_force_topk          — exact oracles (tests)
"""

from repro_torch.core.dks import (  # noqa: F401
    DKSConfig,
    DKSState,
    freeze_finished,
    init_state,
    superstep,
)
from repro_torch.core.driver import (  # noqa: F401
    freeze_lanes,
    lane_init,
    lane_superstep,
    lane_view,
    run_lanes,
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
