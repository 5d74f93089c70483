"""Registers the ``cuda`` marker: tests of the PyTorch port's CUDA kernels,
which need a CUDA card and skip (through the ``cuda_device`` fixture of
their module) where there is none."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips on a CPU-only machine")
