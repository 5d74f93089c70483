"""Synthetic data streams (numpy, seeded; the same batches as ``repro.data``)."""

from repro_torch.data.pipeline import recsys_synthetic_stream  # noqa: F401
