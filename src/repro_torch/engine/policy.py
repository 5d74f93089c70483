"""Execution policy: every backend and partitioning knob of a DKS run in
one place, chosen once at engine build (the twin of
``repro.engine.policy.ExecutionPolicy``), and the serve layer's adaptive
lane-occupancy policy (:class:`AdaptiveLanePolicy`)."""

from __future__ import annotations

import dataclasses
import threading

from repro_torch.core.dks import BACKENDS, DKSConfig
from repro_torch.graph.weights import WeightPolicy


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How a :class:`~repro_torch.engine.QueryEngine` executes queries.

    Attributes:
      backend:   "torch" (stock torch ops, the twin of ``repro``'s "jnp") or
                 "cuda" (the hand-written Hopper kernels, the twin of
                 "pallas": one fused kernel launch per superstep and the
                 subset-combine kernel at superstep 0).
      exit_mode: "sound" (stop once no better answer can appear, Sec. 6) or
                 "none" (run to frontier exhaustion).
      partition: "single" (dense residency) or "sharded" (the
                 frontier-compressed partition,
                 :mod:`repro_torch.core.dks_sharded`: ``n_shards`` shards
                 of the node axis, all on the engine's device, exchanging
                 only their frontiers).  "sharded" runs on "torch" only.
      n_shards:  shard count for "sharded"; ``None`` is the number of
                 CUDA devices on a CUDA engine and 1 on the CPU.
      weights:   :class:`~repro_torch.graph.weights.WeightPolicy`, applied
                 once at build; it cannot be overridden per query.
      telemetry: carry per-superstep counters (frontier size, message
                 totals, frozen-lane count) through the driver's loop in a
                 bounded ``[T, 4]`` f32 device buffer, surfaced as
                 ``QueryResult.telemetry``
                 (:class:`repro_torch.obs.SuperstepTelemetry`).  Answers
                 are bit-identical with it on or off; it is excluded from
                 ``cache_token`` and fixed at build.
      max_supersteps / message_budget / frontier_frac / combine_passes:
                 forwarded to :class:`DKSConfig` (``frontier_frac``: the
                 per-shard frontier cap; overflow is a forced stop with
                 the SPA bound, paper Sec. 5.4).
    """

    backend: str = "torch"          # "torch" | "cuda"
    partition: str = "single"       # "single" | "sharded"
    n_shards: int | None = None
    exit_mode: str = "sound"        # "sound" | "none"
    max_supersteps: int = 64
    message_budget: float = float("inf")
    frontier_frac: float = 0.25
    combine_passes: int | None = None
    weights: WeightPolicy = WeightPolicy()
    telemetry: bool = False

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.partition not in ("single", "sharded"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if self.backend == "cuda" and self.partition == "sharded":
            # Refuse up front rather than silently running torch: the
            # fused lane-superstep kernel is dense-only, and the sharded
            # shard body keeps stock torch ops (as repro's keeps jnp).
            raise NotImplementedError(
                'backend="cuda" with partition="sharded" is not '
                "implemented: the frontier-compressed shard body still "
                'runs the torch relax/combine ops.  Use backend="torch" '
                'for sharded engines, or partition="single" for the '
                "fused CUDA kernel.")
        if self.exit_mode not in ("sound", "none"):
            raise ValueError(f"unknown exit_mode {self.exit_mode!r}")
        if not isinstance(self.weights, WeightPolicy):
            raise ValueError(
                f"weights must be a WeightPolicy, got {self.weights!r}")

    def dks_config(self, m: int, k: int) -> DKSConfig:
        """Materialize the per-query static config for an (m, k) shape."""
        return DKSConfig(
            m=m,
            k=k,
            max_supersteps=self.max_supersteps,
            message_budget=self.message_budget,
            exit_mode=self.exit_mode,
            backend=self.backend,
            combine_passes=self.combine_passes,
            frontier_frac=self.frontier_frac,
        )


# --------------------------------------------------------------------------
# Adaptive lane occupancy
# --------------------------------------------------------------------------


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class LaneDecision:
    """One padding decision: the lane count a bucket dispatches at, why,
    and (when measurements exist) the estimated device cost."""

    lanes: int
    reason: str                  # "exact" | "warm" | "pow2" | "cap"
    est_ms: float | None = None


class AdaptiveLanePolicy:
    """Pick bucket lane counts from MEASURED per-dispatch device cost and
    the serve layer's observed shape histogram, instead of blind pow2/max
    padding (a copy of ``repro.engine.AdaptiveLanePolicy``).

    Padding a bucket of ``n`` real requests up to ``c > n`` lanes wastes
    ``(c - n)`` lanes of device time every dispatch; dispatching at a lane
    count never measured costs ``retrace_cost_ms`` more (in ``repro`` a
    jit retrace; here the first dispatch at a new table shape — allocator
    growth and cold caches).  Scores::

        score(c) = measured_ms(c)            if c was dispatched before
                   per_lane_ms * c + retrace if c is cold

    and picks the cheapest count >= n (capped at ``max_lanes``).  Until
    the first measurement arrives it degrades to exactly pow2 padding.
    ``ServeStats.hot_shapes`` lane counts join the candidate set.

    Thread-safe; the serve layer exports :meth:`snapshot` through the
    metrics registry (``dks_lane_policy_*``).
    """

    def __init__(self, max_lanes: int, retrace_cost_ms: float = 200.0,
                 ema: float = 0.3) -> None:
        if max_lanes < 1:
            raise ValueError("max_lanes must be >= 1")
        self.max_lanes = int(max_lanes)
        self.retrace_cost_ms = float(retrace_cost_ms)
        self._ema = float(ema)
        self._lock = threading.Lock()
        self._cost_ms: dict[int, float] = {}     # lanes -> EMA device ms
        self._uses: dict[int, int] = {}          # lanes -> dispatch count
        self._decisions: dict[str, int] = {}     # reason -> count
        self._last: LaneDecision | None = None

    def observe(self, lanes: int, device_ms: float) -> None:
        """Record one dispatch's device time at a lane count."""
        if lanes < 1 or device_ms < 0:
            return
        with self._lock:
            prev = self._cost_ms.get(lanes)
            self._cost_ms[lanes] = (
                device_ms if prev is None
                else (1 - self._ema) * prev + self._ema * device_ms)
            self._uses[lanes] = self._uses.get(lanes, 0) + 1

    def per_lane_ms(self) -> float | None:
        """Use-weighted mean device cost per lane (None until measured)."""
        with self._lock:
            tot_ms = sum(self._cost_ms[c] / c * self._uses[c]
                         for c in self._cost_ms)
            tot_uses = sum(self._uses.values())
        return tot_ms / tot_uses if tot_uses else None

    def lanes_for(self, n_real: int, hot_shapes: tuple = ()) -> LaneDecision:
        """The lane count a bucket of ``n_real`` requests should dispatch
        at.  ``hot_shapes``: ``ServeStats.hot_shapes`` (``(((m, k,
        lanes), count), ...)``) — its lane counts are candidates even
        without a measurement here."""
        n = max(1, min(int(n_real), self.max_lanes))
        pow2 = min(_pow2_ceil(n), self.max_lanes)
        with self._lock:
            warm = dict(self._cost_ms)
        per_lane = self.per_lane_ms()

        if per_lane is None:
            decision = LaneDecision(lanes=pow2, reason="pow2")
        else:
            hot = {lanes for (_m, _k, lanes), _cnt in hot_shapes
                   if isinstance(lanes, int)}
            cands = {n, pow2, self.max_lanes}
            cands |= {c for c in warm if c >= n}
            cands |= {c for c in hot if n <= c <= self.max_lanes}
            best, best_score = None, None
            for c in sorted(c for c in cands if n <= c <= self.max_lanes):
                if c in warm:
                    score = warm[c]
                else:
                    score = per_lane * c + self.retrace_cost_ms
                if best_score is None or score < best_score:
                    best, best_score = c, score
            reason = ("exact" if best == n
                      else "warm" if best in warm
                      else "pow2" if best == pow2
                      else "cap")
            decision = LaneDecision(lanes=best, reason=reason,
                                    est_ms=round(best_score, 3))
        with self._lock:
            self._decisions[decision.reason] = (
                self._decisions.get(decision.reason, 0) + 1)
            self._last = decision
        return decision

    def target_fill(self) -> int:
        """The bucket size worth waiting for: the most-dispatched warm
        lane count, or ``max_lanes`` before any traffic."""
        with self._lock:
            if not self._uses:
                return self.max_lanes
            return max(self._uses, key=lambda c: (self._uses[c], c))

    def snapshot(self) -> dict:
        """Point-in-time view for metrics/debugging."""
        with self._lock:
            return {
                "decisions": dict(self._decisions),
                "last_lanes": self._last.lanes if self._last else 0,
                "last_reason": self._last.reason if self._last else "",
                "observed_counts": dict(self._uses),
                "cost_ms": {c: round(v, 3)
                            for c, v in self._cost_ms.items()},
            }
