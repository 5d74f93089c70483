"""Wrapper of the batched backtrace kernel (``csrc/batched_backtrace.cu``):
the obligation walk of every candidate of a lane bucket in one launch.

On a CPU tensor it takes the plain version (:mod:`.ref`); on a CUDA tensor
it launches the kernel or raises.  Two routes, as the DKS kernels'
(:func:`~repro_torch.kernels.subset_combine.ops.route`): K a template
parameter inside 1 <= m <= 6, 1 <= K <= 8, a run-time value past it, for
tables of 2^m * K <= ``ROW_FLOATS`` floats a row.  Each walk is a block of
:func:`walk_plan`'s warps.  ``launches`` counts kernel launches and
``launches_by_route`` splits them by route.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis import count, roofline
from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.batched_backtrace.ref import batched_backtrace_ref
from repro_torch.kernels.subset_combine.ops import check_range, route

MAX_BUFFER = 2048  # obligations per candidate
SMS = 132              # the H100's streaming multiprocessors
WALK_WARPS = 8         # warps a walk at most (BT_MAX_WARPS)
EDGES = 4              # neighbours a thread tests a round (BT_EDGES)
SMEM_MAX = 227 * 1024  # shared memory a block may have (sm_90)
SM_SMEM = 228 * 1024   # an SM's, with 1 KB reserved for each block on it
SM_THREADS, SM_BLOCKS = 2048, 32   # resident threads and blocks an SM


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """How the walk kernel lays out one launch: ``warps`` a walk (a block
    each), ``smem_bytes`` of queue and split prefix lengths a block, and
    ``resident`` blocks an SM can hold at once."""
    warps: int
    smem_bytes: int
    resident: int


def walk_plan(n_walks: int, buffer: int, n_pairs: int) -> WalkPlan:
    """The most warps a walk (8, 4, 2 or 1) under which all ``n_walks``
    walks of a bucket are resident at once on the card's ``SMS`` SMs, so
    that more threads share each walk's scans without a second wave; one
    warp a walk where even that takes waves.  The block keeps the queue
    (7 words a slot, ``buffer + 1`` slots) and 2 prefix lengths a split
    pair; raises ``ValueError`` past ``SMEM_MAX``."""
    smem = (7 * (buffer + 1) + 2 * n_pairs) * 4
    if smem > SMEM_MAX:
        raise ValueError(f"batched_backtrace: buffer {buffer} and {n_pairs} "
                         f"split pairs need {smem} B of shared memory, past "
                         f"{SMEM_MAX}")

    def resident(warps):
        return min(SM_BLOCKS, SM_THREADS // (32 * warps),
                   SM_SMEM // (smem + 1024))

    warps = next((w for w in (WALK_WARPS, 4, 2)
                  if n_walks <= SMS * resident(w)), 1)
    return WalkPlan(warps=warps, smem_bytes=smem, resident=resident(warps))

counter = LaunchCounter()
route_counters = {"templated": LaunchCounter(), "wide": LaunchCounter()}

RECORDS = ("node", "kind", "child0", "child1", "edge_u")


@count.reports("batched_backtrace", roofline.backtrace_work)
def batched_backtrace(S: torch.Tensor, kw: torch.Tensor,
                      cand_idx: torch.Tensor, cand_val: torch.Tensor,
                      indptr: torch.Tensor, esrc: torch.Tensor,
                      ew: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                      buffer: int, degree_cap: int) -> dict[str, torch.Tensor]:
    """Decomposition records of every candidate (shapes and meaning as
    :func:`.ref.batched_backtrace_ref`): ``node``, ``kind``, ``child0``,
    ``child1``, ``edge_u`` int32[L, C, buffer] and ``fail`` bool[L, C]."""
    if S.dtype != torch.float32 or S.dim() != 4:
        raise ValueError(f"batched_backtrace wants S f32[L, V, 2^m, K], got "
                         f"{S.dtype}{list(S.shape)}")
    lanes, vp, n_sets, k = S.shape
    m = n_sets.bit_length() - 1
    if n_sets != 1 << m or m < 1:
        raise ValueError(f"batched_backtrace: {n_sets} keyword sets is not "
                         f"2^m")
    c = cand_idx.shape[-1]
    want = {"kw": (kw, torch.bool, (lanes, m, vp)),
            "cand_idx": (cand_idx, torch.int32, (lanes, c)),
            "cand_val": (cand_val, torch.float32, (lanes, c)),
            "indptr": (indptr, torch.int64, None),
            "esrc": (esrc, torch.int32, None),
            "ew": (ew, torch.float32, esrc.shape),
            "pa": (pa, torch.int32, (n_sets, pa.shape[-1])),
            "pb": (pb, torch.int32, pa.shape)}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or (shape is not None and t.shape != shape):
            raise ValueError(f"batched_backtrace: {name} must be {dtype} of "
                             f"shape {shape}, got {t.dtype}{list(t.shape)}")
        if t.device != S.device:
            raise ValueError(f"batched_backtrace: {name} is on {t.device}, "
                             f"S on {S.device}")
    if esrc.numel() == 0 or indptr.dim() != 1 or indptr.numel() < 1:
        raise ValueError("batched_backtrace wants a CSR with at least one "
                         "entry (an edgeless graph passes a sentinel)")
    if buffer < 1 or degree_cap < 1:
        raise ValueError(f"batched_backtrace: buffer={buffer} and "
                         f"degree_cap={degree_cap} must be >= 1")
    tensors = (S, kw, cand_idx, cand_val, indptr, esrc, ew, pa, pb)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("batched_backtrace wants contiguous tensors")
    if S.device.type == "cpu":
        return batched_backtrace_ref(*tensors, buffer, degree_cap)
    check_range(m, k, "batched_backtrace")
    if buffer > MAX_BUFFER:
        raise ValueError(f"batched_backtrace: the CUDA kernel takes buffer "
                         f"<= {MAX_BUFFER}, got {buffer}")
    if S.device.type not in ("cuda", "meta"):
        raise ValueError(f"batched_backtrace: unsupported device {S.device}")
    out = {name: torch.empty(lanes, c, buffer, dtype=torch.int32,
                             device=S.device) for name in RECORDS}
    out["fail"] = torch.empty(lanes, c, dtype=torch.bool, device=S.device)
    if lanes * c == 0 or S.device.type == "meta":
        return out
    plan = walk_plan(lanes * c, buffer, pa.shape[1])
    fn = cuda_build.library("batched_backtrace").bt_batched_backtrace
    err = fn(*(t.data_ptr() for t in tensors),
             *(out[name].data_ptr() for name in (*RECORDS, "fail")),
             lanes, c, vp, m, k, pa.shape[1], buffer, degree_cap,
             indptr.numel() - 1, esrc.numel(), plan.warps,
             torch.cuda.current_stream(S.device).cuda_stream)
    counter.add()
    route_counters[route(m, k)].add()
    cuda_build.check(err, "batched_backtrace")
    return out


def __getattr__(name: str):
    # ``ops.launches``: the total of ``counter`` over every thread, and
    # ``ops.launches_by_route``, read like plain attributes.
    if name == "launches":
        return counter.total
    if name == "launches_by_route":
        return {r: c.total for r, c in route_counters.items()}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
