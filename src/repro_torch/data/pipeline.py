"""Deterministic synthetic LM and recsys batches and a background
prefetcher, numpy copies of ``repro.data.pipeline``: the same seed, step
and shard give the same arrays, batch for batch.

Each stream is seeded per step and shard (``shard_id`` / ``n_shards`` skip
pattern), so shards read disjoint data without coordination and a reader
resumes at an exact batch index with ``skip`` (a restarted training run
re-seeks to its checkpoint's step).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def lm_synthetic_stream(
    vocab: int, batch: int, seq: int, seed: int = 0,
    shard_id: int = 0, n_shards: int = 1, skip: int = 0,
) -> Iterator[dict]:
    """Zipf-ish token batches with next-token labels: ``{"tokens":
    i32[B, seq], "labels": i32[B, seq]}``, the labels the tokens shifted by
    one."""
    step = skip
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    while True:
        rng = np.random.default_rng(
            (seed * 1_000_003 + step * n_shards + shard_id) % (2**63))
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step += 1


def recsys_synthetic_stream(
    cfg, batch: int, seed: int = 0, shard_id: int = 0, n_shards: int = 1,
    skip: int = 0,
) -> Iterator[dict]:
    """Criteo-like batches: log-normal dense features (``log1p``-scaled),
    Zipf(1.3) sparse ids capped at each field's vocabulary, and CTR labels
    from a hidden linear model.  Yields ``{"dense": f32[B, n_dense],
    "sparse": i32[B, n_sparse], "label": i32[B]}``."""
    step = skip
    while True:
        rng = np.random.default_rng(
            (seed * 999_983 + step * n_shards + shard_id) % (2**63))
        dense = rng.lognormal(0.0, 1.0, (batch, cfg.n_dense)).astype(np.float32)
        sparse = np.stack(
            [np.minimum(rng.zipf(1.3, batch), cfg.vocab_sizes[i]) - 1
             for i in range(cfg.n_sparse)], axis=1).astype(np.int32)
        w = np.linspace(-1, 1, cfg.n_dense)
        logit = dense @ w * 0.1 + rng.normal(0, 1, batch)
        label = (logit > 0).astype(np.int32)
        yield {"dense": np.log1p(dense), "sparse": sparse, "label": label}
        step += 1


class PrefetchIterator:
    """Iterates ``it`` on a background thread through a queue of ``depth``
    items, so host batch synthesis overlaps the device's steps.  An error
    raised by ``it`` is raised again by ``next`` after the items before
    it."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 -- raised by __next__
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
