"""Wrapper of the batched backtrace kernel (``csrc/batched_backtrace.cu``):
the obligation walk of every candidate of a lane bucket in one launch.

On a CPU tensor it takes the plain version (:mod:`.ref`); on a CUDA tensor
it launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.batched_backtrace.ref import batched_backtrace_ref

MAX_M = 6          # keyword count: the leaf test gives a warp lane to each
MAX_K = 8          # top-K width: the kernel is instantiated for K = 1..8
MAX_BUFFER = 2048  # obligations per candidate: 4 queues in 227 KB

counter = LaunchCounter()

RECORDS = ("node", "kind", "child0", "child1", "edge_u")


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
    if not (m <= MAX_M and 1 <= k <= MAX_K and buffer <= MAX_BUFFER):
        raise ValueError(
            f"batched_backtrace: the CUDA kernel supports 1 <= m <= {MAX_M} "
            f"keywords, 1 <= k <= {MAX_K} slots and buffer <= {MAX_BUFFER}, "
            f"got m={m}, k={k}, buffer={buffer}")
    if S.device.type != "cuda":
        raise ValueError(f"batched_backtrace: unsupported device {S.device}")
    out = {name: torch.empty(lanes, c, buffer, dtype=torch.int32,
                             device=S.device) for name in RECORDS}
    out["fail"] = torch.empty(lanes, c, dtype=torch.bool, device=S.device)
    if lanes * c == 0:
        return out
    fn = cuda_build.library("batched_backtrace").bt_batched_backtrace
    err = fn(*(t.data_ptr() for t in tensors),
             *(out[name].data_ptr() for name in (*RECORDS, "fail")),
             lanes, c, vp, m, k, pa.shape[1], buffer, degree_cap,
             indptr.numel() - 1, esrc.numel(),
             torch.cuda.current_stream(S.device).cuda_stream)
    counter.add()
    cuda_build.check(err, "batched_backtrace")
    return out


def __getattr__(name: str):
    # ``ops.launches``: the total of ``counter`` over every thread (and,
    # for flash, ``ops.launches_by_route``), read like a plain attribute.
    if name == "launches":
        return counter.total
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
