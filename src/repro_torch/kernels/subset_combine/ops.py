"""Wrapper of the subset-combine kernel (``csrc/subset_combine.cu``):
engine layout ``S[..., V, 2^m, K]`` in and out.

On a CPU tensor it takes the plain version (:mod:`.ref`), for any (m, K);
on a CUDA tensor it launches the kernel or raises, also past the rows the
kernels take (:func:`check_range`).  Two routes (:func:`route`): the
templated kernel for 1 <= m <= 6 and 1 <= K <= 8 (K a template
parameter, one thread a row), the wide kernel for every other (m, K)
(run-time m and K, on the plan of :func:`wide_plan`).  ``launches`` counts
kernel launches and ``launches_by_route`` splits them by route.
"""

from __future__ import annotations

import dataclasses

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
SMEM_MAX = 227 * 1024   # bytes of shared memory a block may have on sm_90
WIDE_WARPS = 4          # the most warps a wide block has
# In-edges past which lane_superstep's wide route gives a row a block of
# its own (a hub block) instead of a warp (past HUB_IN_DEGREE) or one team
# of a warp (the rest).
WIDE_HUB_DEGREE = 256

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


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """How the wide kernels cut their work (``csrc/dks_lattice.cuh``): a
    warp's share of shared memory holds ``rows`` tables of 2^m sets ``ks``
    floats apart and, if ``spread``, 32 private lists of ``ks`` floats for
    the combine."""

    m: int
    k: int
    ks: int          # K rounded up to an odd number: sets on other banks
    rows: int        # rows a warp takes, one a team of 32 // rows lanes
    warps: int       # warps a block
    spread: bool     # a popcount's targets spread over more lanes than one
    hub_degree: int  # lane_superstep: rows of more in-edges get a block

    @property
    def team(self) -> int:
        """Lanes a light row has, and a partial table of a hub block's or
        medium row's warp."""
        return 32 // self.rows

    @property
    def row_floats(self) -> int:
        return self.ks << self.m

    @property
    def warp_floats(self) -> int:
        return self.rows * self.row_floats + (32 * self.ks
                                              if self.spread else 0)

    @property
    def smem_bytes(self) -> int:
        return self.warps * self.warp_floats * 4

    @property
    def rows_per_block(self) -> int:
        """Light rows a block takes."""
        return self.warps * self.rows

    @property
    def partials(self) -> int:
        """A hub block's partial tables: one a team of each warp (a
        medium row's warp keeps ``rows``)."""
        return self.warps * self.rows


def wide_plan(m: int, k: int) -> WidePlan:
    """The wide kernels' plan for (m, K) (any 2^m * K <= ``ROW_FLOATS``).
    A team has as many lanes as the row has keyword sets, up to the whole
    warp, so a warp takes 32 / 2^m rows at m < 5; fewer where they do not
    fit ``SMEM_MAX``.  The combine spreads a popcount's targets over
    private lists where teams have at most 8 lanes (m <= 3) and lists
    K >= 8 slots, and one row and the lists fit: on the H100 that was
    faster at the bucket's m = 3, K = 10 and slower at m = 4, K = 10 and
    m = 7, K = 3 (PERF.md §6).  As many warps a block as fit, up to
    ``WIDE_WARPS``: at the row limit (64 KB) three, so a hub block keeps
    three partial tables.  (Blocks of four warps ran the bucket's
    superstep faster than of eight on the H100.)"""
    check_range(m, k, "wide_plan")
    ks = k | 1
    row, priv = ks << m, 32 * ks
    spread = 2 <= m <= 3 and k >= 8 and (row + priv) * 4 <= SMEM_MAX
    extra = priv if spread else 0
    rows = 32 // min(1 << m, 32)
    while rows > 1 and (rows * row + extra) * 4 > SMEM_MAX:
        rows //= 2
    warps = min(WIDE_WARPS, SMEM_MAX // ((rows * row + extra) * 4))
    return WidePlan(m=m, k=k, ks=ks, rows=rows, warps=warps, spread=spread,
                    hub_degree=WIDE_HUB_DEGREE)


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
    out = torch.empty_like(S)
    n_rows = S.numel() // ((1 << m) * k)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    if way == "templated":
        err = lib.dks_subset_combine(S.data_ptr(), out.data_ptr(), n_rows, m,
                                     k, stream)
    else:
        plan = wide_plan(m, k)
        err = lib.dks_subset_combine_wide(
            S.data_ptr(), out.data_ptr(), n_rows, m, k, plan.rows,
            plan.warps, int(plan.spread), stream)
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
