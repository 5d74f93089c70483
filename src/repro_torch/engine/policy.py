"""Execution policy: every backend knob of a DKS run in one place, chosen
once at engine build (the twin of ``repro.engine.policy.ExecutionPolicy``
for the dense single-device partition)."""

from __future__ import annotations

import dataclasses

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
      weights:   :class:`~repro_torch.graph.weights.WeightPolicy`, applied
                 once at build; it cannot be overridden per query.
      max_supersteps / message_budget / combine_passes: forwarded to
                 :class:`DKSConfig`.
    """

    backend: str = "torch"          # "torch" | "cuda"
    exit_mode: str = "sound"        # "sound" | "none"
    max_supersteps: int = 64
    message_budget: float = float("inf")
    combine_passes: int | None = None
    weights: WeightPolicy = WeightPolicy()

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
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
        )
