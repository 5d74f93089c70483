"""Wrapper of the subset-combine kernel (``csrc/subset_combine.cu``):
engine layout ``S[..., V, 2^m, K]`` in and out.

On a CPU tensor it takes the plain version (:mod:`.ref`), for any (m, K);
on a CUDA tensor it launches the kernel or raises, also outside the
kernels' (m, K) range (:func:`check_range`).  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import count, roofline
from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.subset_combine.ref import subset_combine_ref

MAX_M = 6   # keyword count: 2^m tables of K floats per node in the slab
MAX_K = 8   # top-K width: the kernels are instantiated for K = 1..8

counter = LaunchCounter()


def check_range(m: int, k: int, what: str) -> None:
    """The (m, K) range the DKS CUDA kernels are built for (checked before
    a launch; the plain versions take any)."""
    if not (1 <= m <= MAX_M and 1 <= k <= MAX_K):
        raise ValueError(
            f"{what}: the CUDA kernels support 1 <= m <= {MAX_M} keywords "
            f"and 1 <= k <= {MAX_K} answers, got m={m}, k={k}")


@count.reports("subset_combine", roofline.combine_work)
def subset_combine(S: torch.Tensor, m: int) -> torch.Tensor:
    """Closed table of ``S`` (f32[..., 2^m, K]): one popcount-ordered
    sweep over ``split_pairs(m)``, top-K distinct, saturated at INF."""
    if S.dtype != torch.float32 or S.dim() < 2 or S.shape[-2] != 1 << m:
        raise ValueError(f"subset_combine wants f32[..., {1 << m}, K], "
                         f"got {S.dtype}{list(S.shape)}")
    k = S.shape[-1]
    if not S.is_contiguous():
        raise ValueError("subset_combine wants a contiguous table")
    if S.device.type == "cpu":
        return subset_combine_ref(S, m)
    check_range(m, k, "subset_combine")
    if S.device.type == "meta":
        return torch.empty_like(S)
    if S.device.type != "cuda":
        raise ValueError(f"subset_combine: unsupported device {S.device}")
    fn = cuda_build.library("subset_combine").dks_subset_combine
    out = torch.empty_like(S)
    n_rows = S.numel() // ((1 << m) * k)
    err = fn(S.data_ptr(), out.data_ptr(), n_rows, m, k,
             torch.cuda.current_stream(S.device).cuda_stream)
    counter.add()
    cuda_build.check(err, "subset_combine")
    return out


def __getattr__(name: str):
    # ``ops.launches``: the total of ``counter`` over every thread (and,
    # for flash, ``ops.launches_by_route``), read like a plain attribute.
    if name == "launches":
        return counter.total
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
