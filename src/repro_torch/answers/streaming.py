"""Streaming extraction: overlap host-side tree reconstruction with the
remaining device supersteps.

The stepwise driver freezes finished lanes while the rest of the bucket
keeps iterating.  A frozen lane's table is final — its answer trees can be
reconstructed *now*, on a host worker thread, while the device runs the
next supersteps for the unfinished lanes.  By the time the loop exits,
most extractions are already done; deadline queries get best-so-far trees
for interrupted lanes the same way.

:class:`ExtractionOverlap` is the single-use helper a deadline loop
drives: ``submit(lane, S, masks)`` as lanes freeze (snapshotting the
lane's table on the caller's thread — the device buffer may keep
mutating), then ``result(lane, ...)`` at the end (collects the overlap
result, or extracts inline for lanes never submitted — e.g. interrupted
ones, whose best-so-far table is only known at deadline).  A copy of
``repro.answers.streaming``; a table may be a numpy array or a torch
tensor on any device.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from repro_torch.core.reconstruct import AnswerTree, collect_answers
from repro_torch.graph.structure import Graph


def _host(a) -> np.ndarray:
    """A host numpy copy of a table or mask (torch tensors leave their
    device here)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class ExtractionOverlap:
    """One query-batch's worth of overlapped host extractions.

    Not thread-safe for concurrent ``submit``; the intended caller is a
    (single-threaded) stepwise loop, with the actual numpy reconstruction
    running on ``workers`` background threads (pure numpy — the GIL is
    released in the argsort/array ops and the device is never touched, so
    the overlap is real).
    """

    def __init__(self, graph: Graph, k: int, candidate_factor: int = 4,
                 workers: int = 2) -> None:
        self.graph = graph
        self.k = k
        self.candidate_factor = candidate_factor
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix="extract")
        self._futures: dict[int, concurrent.futures.Future] = {}
        self.overlapped = 0   # extractions that ran during device steps
        self.inline = 0       # extractions that ran at collection time

    def submit(self, lane: int, S_lane, masks) -> None:
        """Queue extraction for a lane that just froze.  ``S_lane`` is the
        lane's final table (snapshotted to host numpy here, synchronously,
        so later device writes can't race); ``masks`` is ``[m, V_real]``
        bool."""
        if lane in self._futures:
            return
        S = _host(S_lane)
        masks = _host(masks)
        self.overlapped += 1
        self._futures[lane] = self._pool.submit(
            collect_answers, S, self.graph, masks, self.k,
            self.candidate_factor)

    def pending(self, lane: int) -> bool:
        return lane in self._futures

    def result(self, lane: int, S_lane=None,
               masks=None) -> tuple[list[AnswerTree], bool]:
        """Collect a lane's ``(answers, exhausted)``.  Lanes never
        submitted (interrupted at deadline, or overlap disabled) extract
        inline from the provided table."""
        fut = self._futures.get(lane)
        if fut is not None:
            return fut.result()
        if S_lane is None or masks is None:
            raise ValueError(f"lane {lane} was never submitted and no "
                             "table was provided for inline extraction")
        self.inline += 1
        return collect_answers(
            _host(S_lane), self.graph, _host(masks), self.k,
            self.candidate_factor)

    def stats(self) -> dict[str, int]:
        """``{overlapped, inline}`` extraction counts — how much of the
        bucket's tree reconstruction actually hid behind device steps."""
        return {"overlapped": self.overlapped, "inline": self.inline}

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ExtractionOverlap":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
