"""Wrapper of the subset-combine kernel (``csrc/subset_combine.cu``):
engine layout ``S[..., V, 2^m, K]`` in and out.

On a CPU tensor it takes the plain version (:mod:`.ref`), for any (m, K);
on a CUDA tensor it launches the kernel or raises, also past the rows the
kernels take (:func:`check_range`).  Two routes (:func:`route`): the
templated kernel for 1 <= m <= 6 and 1 <= K <= 8 (K a template
parameter, one thread a row), the wide kernel for every other (m, K)
(run-time m and K, one warp a row).  ``launches`` counts kernel launches
and ``launches_by_route`` splits them by route.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import count, roofline
from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.subset_combine.ref import subset_combine_ref

MAX_M = 6   # the templated route: 2^m tables of K floats a thread's row
MAX_K = 8   # in the slab, K = 1..8 instantiated
# The wide route: a row of 2^m * K floats whole in one warp's shared
# memory, at most 64 KB (m <= 10 at K <= 16).
ROW_FLOATS = 16384

counter = LaunchCounter()
route_counters = {"templated": LaunchCounter(), "wide": LaunchCounter()}


def route(m: int, k: int) -> str:
    """The DKS kernels' route for (m, K): ``"templated"`` inside
    1 <= m <= 6, 1 <= K <= 8, else ``"wide"`` (``bt_batched_backtrace``
    picks its instantiation by the same rule)."""
    return "templated" if 1 <= m <= MAX_M and 1 <= k <= MAX_K else "wide"


def check_range(m: int, k: int, what: str) -> None:
    """The rows the DKS CUDA kernels take, 2^m * K <= ROW_FLOATS (checked
    before a launch; the plain versions take any)."""
    if m < 1 or k < 1 or (1 << m) * k > ROW_FLOATS:
        raise ValueError(
            f"{what}: the CUDA kernels take rows of 2^m * k <= {ROW_FLOATS} "
            f"floats (one row in a block's shared memory), with m >= 1 "
            f"keywords and k >= 1 answers, got m={m}, k={k}")


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
    way = route(m, k)
    lib = cuda_build.library("subset_combine")
    fn = (lib.dks_subset_combine if way == "templated"
          else lib.dks_subset_combine_wide)
    out = torch.empty_like(S)
    n_rows = S.numel() // ((1 << m) * k)
    err = fn(S.data_ptr(), out.data_ptr(), n_rows, m, k,
             torch.cuda.current_stream(S.device).cuda_stream)
    counter.add()
    route_counters[way].add()
    cuda_build.check(err, "subset_combine")
    return out


def __getattr__(name: str):
    # ``ops.launches``: the total of ``counter`` over every thread, and
    # ``ops.launches_by_route``, read like plain attributes.
    if name == "launches":
        return counter.total
    if name == "launches_by_route":
        return {r: c.total for r, c in route_counters.items()}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
