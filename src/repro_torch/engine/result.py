"""Query results: ranked answer trees plus the run statistics and
approximation bounds the paper reports (supersteps, BFS/deep messages,
explored fraction, SPA ratio on forced early exit — Sec. 5.4 / Fig. 12).
The same fields as ``repro.engine.result.QueryResult``."""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import INF
from repro_torch.core.dks import DKSState
from repro_torch.core.reconstruct import AnswerTree
from repro_torch.obs.telemetry import SuperstepTelemetry


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One answered relationship query.

    Attributes:
      query:         the tokens as given to the engine.
      m, k:          query shape (keywords, answers requested).
      answers:       ranked minimal answer trees (host-reconstructed; empty
                     when extraction was skipped or nothing was found).
      weights:       f32[k] global top-k distinct answer weights (INF pad).
      roots:         i32[k] their root nodes (-1 pad).
      kw_nodes:      total keyword-node count of the query.
      supersteps:    Pregel supersteps executed.
      msgs_bfs / msgs_deep: cumulative message counts (paper Fig. 11/14).
      explored_frac: fraction of real nodes ever activated (paper Fig. 13).
      done:          the run stopped (for any reason, forced stops too).
      budget_hit:    stopped by the message budget (paper Sec. 5.4).
      capped:        stopped only by the ``max_supersteps`` cap.
      spa:           smallest-possible-answer bound on forced stops, else
                     None.
      spa_ratio:     paper Fig. 12 degree of approximation (0 = certified).
      wall_time_s:   wall time of the superstep loop, ended by a device
                     synchronisation (for batched queries: the bucket's).
      own_time_s:    this query's own time (None inside a batch bucket).
      state:         the raw final :class:`DKSState` (lane axis of 1) when
                     the query was made with ``keep_state=True``.
      unmatched:     tokens that matched no node (``strict=False`` only).
      answers_exhausted: the table holds fewer than ``k`` distinct trees.
      answer_pool / pool_exhausted: the wider ranked list when
                     ``extract_pool > k`` was asked for.
      telemetry:     per-superstep counters
                     (:class:`repro_torch.obs.SuperstepTelemetry`) under
                     ``ExecutionPolicy(telemetry=True)`` or from
                     ``query_instrumented``; None otherwise.
    """

    query: tuple
    m: int
    k: int
    answers: list[AnswerTree]
    weights: np.ndarray
    roots: np.ndarray
    kw_nodes: int
    supersteps: int
    msgs_bfs: float
    msgs_deep: float
    explored_frac: float
    done: bool
    budget_hit: bool
    capped: bool
    spa: float | None
    spa_ratio: float
    wall_time_s: float
    state: DKSState | None
    unmatched: tuple = ()
    own_time_s: float | None = None
    answers_exhausted: bool = False
    answer_pool: list[AnswerTree] | None = None
    pool_exhausted: bool = False
    telemetry: SuperstepTelemetry | None = None

    @property
    def found(self) -> bool:
        return bool(self.weights[0] < INF)

    @property
    def best(self) -> AnswerTree | None:
        return self.answers[0] if self.answers else None

    @property
    def best_weight(self) -> float:
        return float(self.weights[0])

    @property
    def msgs_total(self) -> float:
        return self.msgs_bfs + self.msgs_deep


@dataclasses.dataclass(frozen=True)
class StreamUpdate:
    """One superstep of a streaming query (``engine.query_stream``): the
    current best answers with a lower bound on the optimum (paper Sec. 5.4
    SPA estimate combined with the provably sound ``nu`` bound).  The same
    fields as ``repro.engine.result.StreamUpdate``.

    Attributes:
      step:          superstep index (the init superstep is 0).
      weights:       f32[k] current global top-k distinct answer weights.
      roots:         i32[k] their roots.
      frontier:      active vertices entering the next superstep.
      msgs_bfs / msgs_deep: cumulative message counts.
      nu_full:       sound lower bound on any newly appearing full-set
                     value in a future superstep (``spa.nu_lower_bound``).
      spa:           cover-DP smallest-possible-answer estimate from the
                     current frontier minima.
      opt_lower_bound: running reported bound: max over supersteps of
                     min(best, spa) and min(best, nu_full).
      sound_opt_lower_bound: running bound from sound facts only (``nu``,
                     an exhausted frontier, a non-forced exit).
      spa_ratio:     inf while no answer is known; then best /
                     opt_lower_bound, non-increasing; 0 once the best
                     cannot be improved per the reported bound.
      done:          the run's exit criterion has fired (final update).
      unmatched:     tokens that matched no node (``strict=False`` only).
    """

    step: int
    weights: np.ndarray
    roots: np.ndarray
    frontier: int
    msgs_bfs: float
    msgs_deep: float
    nu_full: float
    spa: float
    opt_lower_bound: float
    sound_opt_lower_bound: float
    spa_ratio: float
    done: bool
    unmatched: tuple = ()

    @property
    def best_weight(self) -> float:
        return float(self.weights[0])

    @property
    def proven_optimal(self) -> bool:
        """Sound claim: no future superstep can beat the current best."""
        return self.best_weight < INF and \
            self.best_weight <= self.sound_opt_lower_bound
