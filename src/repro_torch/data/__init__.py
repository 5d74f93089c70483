"""Synthetic data streams (numpy, seeded; the same batches as ``repro.data``)
and the background prefetcher."""

from repro_torch.data.pipeline import (  # noqa: F401
    PrefetchIterator, lm_synthetic_stream, recsys_synthetic_stream,
)
