"""Per-superstep telemetry: one decoded form for both collection paths.

The paper's experimental section (§6) reads the run through
per-superstep curves — frontier sizes, message counts, convergence.
Two collectors feed the same decoded record:

- the **fused device path**: `ExecutionPolicy(telemetry=True)` makes
  the driver's superstep loop carry a small ``[T, 4]`` f32 device buffer
  and write one row per superstep (``core/driver.py`` owns the torch
  side; this module decodes the buffer on the host), and
- the **host stepwise path**: `HostTelemetryCollector` accumulates rows
  inside ``core/dks.py``'s ``run_dks_instrumented`` (the
  `query_instrumented` surface),
  which also tracks the per-step best weight the device buffer omits.

Both produce a :class:`SuperstepTelemetry`; ``rows()`` reproduces the
legacy instrumented ``history`` dicts, so the instrumented surface is a
compatibility wrapper over this collector rather than a second source
of per-superstep truth.

Buffer layout (column order is load-bearing — the device loop writes
it positionally): ``[frontier, msgs_bfs, msgs_deep, frozen]`` where
``frontier`` sums active vertices over all lanes, the message columns
are *cumulative* lane-summed totals (deltas are derived properties),
and ``frozen`` counts lanes already done after the superstep.  The
buffer is bounded at :data:`TELEMETRY_MAX_SUPERSTEPS` rows; runs past
that overwrite the last row and set ``truncated``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Device-buffer row cap.  DKS supersteps are bounded by the graph
# diameter (tens, not hundreds); 512 rows is 8 KiB of f32 per query —
# big enough to never truncate a real run, small enough to be free.
TELEMETRY_MAX_SUPERSTEPS = 512

# Column indices in the device buffer / collector rows.
COL_FRONTIER, COL_MSGS_BFS, COL_MSGS_DEEP, COL_FROZEN = 0, 1, 2, 3
N_COLS = 4


@dataclass(frozen=True)
class SuperstepTelemetry:
    """Decoded per-superstep counters for one query (or one lane bucket,
    with lane-summed columns).  All arrays have length ``n_steps``.

    - ``frontier[i]``: active (changed) vertices entering superstep
      ``i+1``'s send phase, summed over lanes.
    - ``msgs_bfs[i]`` / ``msgs_deep[i]``: *cumulative* message totals
      after superstep ``i+1`` (lane-summed); per-step deltas via
      :attr:`msgs_bfs_delta` / :attr:`msgs_deep_delta`.
    - ``frozen[i]``: lanes whose exit condition held after superstep
      ``i+1`` (0 or 1 for single queries).
    - ``best``: best answer weight per step — host collector only;
      ``None`` from the device buffer.
    """

    n_steps: int
    frontier: np.ndarray
    msgs_bfs: np.ndarray
    msgs_deep: np.ndarray
    frozen: np.ndarray
    best: np.ndarray | None = None
    truncated: bool = False

    @classmethod
    def from_buffer(cls, buf, n_steps: int) -> "SuperstepTelemetry":
        """Decode the device carry buffer (``[T, 4]``, any array type
        np.asarray accepts).  Rows past ``n_steps`` are padding."""
        arr = np.asarray(buf, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[1] != N_COLS:
            raise ValueError(f"telemetry buffer must be [T, {N_COLS}], "
                             f"got {arr.shape}")
        n = int(n_steps)
        truncated = n > arr.shape[0]
        rows = arr[:min(n, arr.shape[0])]
        return cls(
            n_steps=n,
            frontier=rows[:, COL_FRONTIER].astype(np.int64),
            msgs_bfs=rows[:, COL_MSGS_BFS].copy(),
            msgs_deep=rows[:, COL_MSGS_DEEP].copy(),
            frozen=rows[:, COL_FROZEN].astype(np.int64),
            truncated=truncated,
        )

    @property
    def msgs_bfs_delta(self) -> np.ndarray:
        return np.diff(self.msgs_bfs, prepend=0.0)

    @property
    def msgs_deep_delta(self) -> np.ndarray:
        return np.diff(self.msgs_deep, prepend=0.0)

    def rows(self) -> list[dict]:
        """Legacy instrumented ``history`` rows: one dict per superstep
        with keys ``step/frontier/msgs_bfs/msgs_deep`` (+ ``best`` when
        tracked), message columns cumulative — exactly what
        ``repro``'s ``host_instrumented_loop`` used to build inline."""
        out = []
        for i in range(len(self.frontier)):
            row = {
                "step": i + 1,
                "frontier": int(self.frontier[i]),
                "msgs_bfs": float(self.msgs_bfs[i]),
                "msgs_deep": float(self.msgs_deep[i]),
            }
            if self.best is not None:
                row["best"] = float(self.best[i])
            out.append(row)
        return out

    def summary(self) -> dict:
        """Scalar digest for logs/benchmarks."""
        if len(self.frontier) == 0:
            return {"n_steps": self.n_steps, "peak_frontier": 0,
                    "msgs_total": 0.0, "truncated": self.truncated}
        return {
            "n_steps": self.n_steps,
            "peak_frontier": int(self.frontier.max()),
            "peak_frontier_step": int(self.frontier.argmax()) + 1,
            "msgs_total": float(self.msgs_bfs[-1] + self.msgs_deep[-1]),
            "truncated": self.truncated,
        }


@dataclass
class HostTelemetryCollector:
    """Row-at-a-time accumulator for host-looped drivers.

    ``run_dks_instrumented`` calls :meth:`record` once per superstep
    with lane-summed scalars; :meth:`build` freezes the result.  This is
    the single place the instrumented history format is defined.
    """

    _rows: list[tuple] = field(default_factory=list)
    _best: list[float] = field(default_factory=list)
    _has_best: bool = False

    def record(self, frontier: int, msgs_bfs: float, msgs_deep: float,
               frozen: int, best: float | None = None) -> None:
        self._rows.append((int(frontier), float(msgs_bfs),
                           float(msgs_deep), int(frozen)))
        if best is not None:
            self._has_best = True
            self._best.append(float(best))

    def __len__(self) -> int:
        return len(self._rows)

    def build(self) -> SuperstepTelemetry:
        arr = np.asarray(self._rows, dtype=np.float64).reshape(-1, N_COLS)
        best = None
        if self._has_best:
            if len(self._best) != len(self._rows):
                raise ValueError("best recorded for only some supersteps")
            best = np.asarray(self._best, dtype=np.float64)
        return SuperstepTelemetry(
            n_steps=len(self._rows),
            frontier=arr[:, COL_FRONTIER].astype(np.int64),
            msgs_bfs=arr[:, COL_MSGS_BFS].copy(),
            msgs_deep=arr[:, COL_MSGS_DEEP].copy(),
            frozen=arr[:, COL_FROZEN].astype(np.int64),
            best=best,
        )
