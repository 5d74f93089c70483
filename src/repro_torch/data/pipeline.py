"""Deterministic synthetic recsys batches, a numpy copy of
``repro.data.pipeline.recsys_synthetic_stream``: the same seed, step and
shard give the same arrays, batch for batch.

The stream is seeded per step and shard (``shard_id`` / ``n_shards`` skip
pattern), so a reader resumes at an exact batch index with ``skip``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


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
