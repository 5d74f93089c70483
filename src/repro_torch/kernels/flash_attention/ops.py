"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``):
the model's ``[B, S, H, Dh]`` layout in and out, no transpose, no padding.

On a CPU tensor it takes the plain version (:mod:`.ref`); on a CUDA tensor
it launches the kernel or raises.  The C entry point picks one of two
routes by dtype and head dim (:func:`route`): ``"wgmma"`` (bf16 at head dims
64 and 128, the Hopper design: TMA, a K/V ring, wgmma) or ``"wmma"`` (f32,
and bf16 at 16 and 32).  ``launches`` counts kernel launches and
``launches_by_route`` splits them by route.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.analysis import count, roofline
from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)   # the kernel is instantiated for these
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

counter = LaunchCounter()
route_counters = {"wgmma": LaunchCounter(), "wmma": LaunchCounter()}


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel route ``flash_attention_fwd`` takes for q's dtype and head
    dim (the same static rule as the C entry point)."""
    return "wgmma" if dtype == torch.bfloat16 and dh in (64, 128) else "wmma"


@count.reports("flash_attention", roofline.flash_work)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal GQA attention forward with an online softmax.

    q [B, Sq, Hq, Dh]; k/v [B, Skv, Hkv, Dh] with Hq a multiple of Hkv, all
    one dtype (f32 or bf16), contiguous -> [B, Sq, Hq, Dh] in q's dtype.
    Query row ``i`` sits at position ``q_offset + i`` and sees the keys at
    positions ``<=`` its own.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention wants q [B, Sq, Hq, Dh] and k, v "
            f"[B, Skv, Hkv, Dh], got {list(q.shape)}, {list(k.shape)}, "
            f"{list(v.shape)}")
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: k/v {list(k.shape)} do not fit "
                         f"q {list(q.shape)} (Hq must be a multiple of Hkv)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel supports head "
                         f"dims {HEAD_DIMS}, got {dh}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention wants q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if skv == 0 or int(q_offset) < 0:
        raise ValueError(f"flash_attention wants Skv >= 1 and q_offset >= 0, "
                         f"got Skv={skv}, q_offset={q_offset}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k, v")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, q_offset=int(q_offset))
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention wants 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    if sq == 0 or b == 0:
        return out
    fn = cuda_build.library("flash_attention").flash_attention_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
             skv, hq, hkv, dh, DTYPES[q.dtype], int(q_offset),
             ctypes.c_float(1.0 / math.sqrt(dh)),
             torch.cuda.current_stream(q.device).cuda_stream)
    counter.add()
    route_counters[route(q.dtype, dh)].add()
    cuda_build.check(err, "flash_attention")
    return out


def __getattr__(name: str):
    # ``ops.launches``: the total of ``counter`` over every thread (and,
    # for flash, ``ops.launches_by_route``), read like a plain attribute.
    if name == "launches":
        return counter.total
    if name == "launches_by_route":
        return {r: c.total for r, c in route_counters.items()}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
