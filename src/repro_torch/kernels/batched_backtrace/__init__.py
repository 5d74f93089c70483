from repro_torch.kernels.batched_backtrace.ops import batched_backtrace  # noqa: F401
