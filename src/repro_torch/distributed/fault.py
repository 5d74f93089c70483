"""Fault tolerance and straggler detection for the step loop
(``repro.distributed.fault``).

- :class:`StepGuard` runs one step with retry and straggler accounting.  A
  step that raises is retried from the SAME input state, up to
  ``max_retries`` times: the train steps of :mod:`repro_torch.models.lm`
  and :mod:`repro_torch.launch.train` update the state in place only after
  the loss, the backward pass and the clip have finished, so a fault
  raised before the update leaves the state as it was.  A fault inside
  the update, with some leaves already written, raises
  :class:`UnreplayableStepError`, which the guard raises at once.
- :class:`StragglerPolicy` keeps an EMA of step times and flags a step
  slower than ``threshold`` x the EMA; ``patience`` consecutive flags ask
  for a checkpoint now.

A step's time is taken on the host clock and ends with a
``torch.cuda.synchronize`` of every card its outputs live on (``repro``'s
``jax.block_until_ready``); outputs on the CPU need none.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch


class UnreplayableStepError(RuntimeError):
    """A step failed after it began to update its state in place: that
    state is no longer the step's input, so the step cannot be replayed."""


@dataclasses.dataclass
class StragglerPolicy:
    threshold: float = 2.0
    ema_decay: float = 0.9
    patience: int = 3
    _ema: float | None = None
    _consecutive: int = 0

    def observe(self, step_time: float) -> bool:
        """Returns True if this step is a straggler event."""
        if self._ema is None:
            self._ema = step_time
            return False
        is_straggler = step_time > self.threshold * self._ema
        # Slow steps do not move the baseline.
        if not is_straggler:
            self._ema = (self.ema_decay * self._ema
                         + (1 - self.ema_decay) * step_time)
            self._consecutive = 0
        else:
            self._consecutive += 1
        return is_straggler

    @property
    def should_escalate(self) -> bool:
        return self._consecutive >= self.patience


def _cuda_devices(out: Any, found: set) -> set:
    """The CUDA devices of every tensor in ``out`` (dicts, lists, tuples
    and dataclasses are searched; modules are not)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for sub in out.values():
            _cuda_devices(sub, found)
    elif isinstance(out, (list, tuple)):
        for sub in out:
            _cuda_devices(sub, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    return found


def block_until_ready(out: Any) -> Any:
    """Wait for the cards ``out``'s tensors live on; returns ``out``."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)
    return out


@dataclasses.dataclass
class StepGuard:
    """Runs a step with retry and straggler accounting."""

    max_retries: int = 2
    straggler: StragglerPolicy = dataclasses.field(
        default_factory=StragglerPolicy)
    on_retry: Callable[[int, BaseException], None] | None = None
    events: list = dataclasses.field(default_factory=list)

    def run(self, step_fn: Callable, state: Any, *args) -> tuple[Any, Any, dict]:
        """``step_fn(state, *args) -> (new_state, aux)``; returns
        (new_state, aux, info).  On an exception the step is run again from
        the same ``state`` (the Pregel superstep-recovery model the paper
        inherits from Giraph, applied to training); an
        :class:`UnreplayableStepError` is raised at once."""
        last_exc: BaseException | None = None
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                new_state, aux = block_until_ready(step_fn(state, *args))
                dt = time.perf_counter() - t0
                info = {
                    "step_time_s": dt,
                    "straggler": self.straggler.observe(dt),
                    "escalate_checkpoint": self.straggler.should_escalate,
                    "retries": attempt,
                }
                if info["straggler"]:
                    self.events.append(("straggler", dt))
                return new_state, aux, info
            except UnreplayableStepError:
                raise
            except Exception as e:  # noqa: BLE001 -- runtime faults retried
                last_exc = e
                self.events.append(("retry", repr(e)))
                if self.on_retry is not None:
                    self.on_retry(attempt, e)
        raise RuntimeError(
            f"step failed after {self.max_retries + 1} attempts"
        ) from last_exc
