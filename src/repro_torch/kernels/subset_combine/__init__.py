from repro_torch.kernels.subset_combine.ops import subset_combine  # noqa: F401
