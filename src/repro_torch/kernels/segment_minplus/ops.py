"""The padded-CSR DKS relax: ``repro``'s ``kernels/segment_minplus/ops.py``
with the padded top-K reduce on the CUDA kernel (``csrc/padded_topk.cu``).

``padded_csr_from_graph`` (host, numpy) builds the degree-decomposed layout
once per graph; ``segment_minplus_padded`` runs one relax step: a torch
gather of the source tables plus the edge length
(:func:`padded_candidates`), the padded top-K reduce (:func:`padded_topk`),
and a torch second-level merge of split hubs (:func:`merge_virtual_rows`).

``padded_topk`` takes the plain version (:mod:`.ref`) on a CPU tensor; on a
CUDA tensor it launches the kernel or raises: the templated route for
K <= 8, the wide one (run-time K, a warp's lanes over a virtual row's
keyword sets, on :func:`topk_wide_plan`) past it, both for rows of
F * K <= ``ROW_FLOATS``.  ``launches`` counts kernel launches and
``launches_by_route`` splits them by route.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import INF
from repro_torch.analysis import count, roofline
from repro_torch.core import semiring
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.segment_minplus.ref import padded_topk_ref
from repro_torch.kernels.subset_combine.ops import MAX_K, ROW_FLOATS

counter = LaunchCounter()
route_counters = {"templated": LaunchCounter(), "wide": LaunchCounter()}

TOPK_CHUNK_FLOATS = 2048   # candidates' floats a wide warp stages a step
TOPK_WARPS = 4             # warps a wide block at most (DKS_TOPK_WARPS)
SMEM_MAX = 227 * 1024      # shared memory a block may have (sm_90)
SM_SMEM = 228 * 1024       # an SM's, with 1 KB reserved for each block
SMS, SM_THREADS, SM_BLOCKS = 132, 2048, 32   # the H100


@dataclasses.dataclass(frozen=True)
class TopkWidePlan:
    """The wide ``padded_topk``'s layout for cand [Vv, C, F] at K:
    ``team`` lanes a keyword set where F < 32 (each a partial list of
    ``ks`` = K | 1 floats; 1 where F >= 32, a list a set), ``chunk``
    candidates staged a step into each of two buffers of ``stage``
    floats, ``warp_floats`` a warp's share of shared memory, ``warps`` a
    block and ``resident`` blocks an SM."""
    team: int
    ks: int
    chunk: int
    stage: int
    warp_floats: int
    warps: int
    resident: int

    @property
    def smem_bytes(self) -> int:
        return self.warps * self.warp_floats * 4

    def blocks(self, rows: int) -> int:
        """The grid: one row a warp, up to a wave of resident blocks (a
        warp then walks rows ``SMS * resident * warps`` apart)."""
        return max(1, min(-(-rows // self.warps), SMS * self.resident))


def topk_wide_plan(c: int, f: int, k: int) -> TopkWidePlan:
    """The wide route's plan: teams of 32 // F lanes a set (halved while
    the lists and staging overflow ``SMEM_MAX``), chunks of about
    ``TOPK_CHUNK_FLOATS`` floats whose starts keep 16-byte alignment
    (a multiple of 4 // gcd(F, 4) candidates), as many warps a block as
    fit, up to ``TOPK_WARPS``."""
    if f < 1 or k < 1 or f * k > ROW_FLOATS or c < k:
        raise ValueError(f"topk_wide_plan: wants F * k <= {ROW_FLOATS} and "
                         f"C >= k, got C={c}, F={f}, k={k}")
    ks = k | 1
    step = 4 // math.gcd(f, 4)
    n_chunks = -(-c * f // TOPK_CHUNK_FLOATS)
    chunk = min(c, -(-(-(-c // n_chunks)) // step) * step)
    stage = -(-chunk * f // 4) * 4
    team = 32 // f if f < 32 else 1

    def floats(team):
        lists = f * team if f < 32 else f
        return 2 * stage + -(-lists * ks // 4) * 4

    while team > 1 and floats(team) * 4 > SMEM_MAX:
        team //= 2
    warp_floats = floats(team)
    warps = min(TOPK_WARPS, SMEM_MAX // (warp_floats * 4))
    if warps < 1:
        raise ValueError(f"topk_wide_plan: a warp's {warp_floats * 4} B "
                         f"pass {SMEM_MAX} B (C={c}, F={f}, k={k})")
    resident = min(SM_BLOCKS, SM_THREADS // (32 * warps),
                   SM_SMEM // (warps * warp_floats * 4 + 1024))
    return TopkWidePlan(team=team, ks=ks, chunk=chunk, stage=stage,
                        warp_floats=warp_floats, warps=warps,
                        resident=resident)


@dataclasses.dataclass(frozen=True)
class PaddedCSR:
    """Degree-decomposed incoming-edge layout.

    src_pad:  int32[Vv, dmax]   source node per candidate slot (0 on padding)
    w_pad:    float32[Vv, dmax] edge length (INF on padding)
    real_of:  int32[Vv]         owning real node of each virtual row
    dmax:     int
    n_virtual: int (Vv, padded to a multiple of ``pad_rows_to``)
    """

    src_pad: torch.Tensor
    w_pad: torch.Tensor
    real_of: torch.Tensor
    dmax: int
    n_virtual: int


def padded_csr_from_graph(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                          n_nodes: int, dmax: int = 64, pad_rows_to: int = 8,
                          device: str | torch.device | None = None
                          ) -> PaddedCSR:
    """Per-destination padded rows of at most ``dmax`` in-edges, a node of
    in-degree d taking ``max(1, ceil(d / dmax))`` rows (hubs split), rows
    padded to a multiple of ``pad_rows_to``: the arrays of ``repro``'s
    builder, bit for bit, without its Python loop over nodes and edges."""
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    if len(dst) and (dst[0] < 0 or dst[-1] >= n_nodes):
        raise ValueError(f"padded_csr_from_graph: dst outside [0, {n_nodes})")
    deg = np.bincount(dst, minlength=n_nodes)
    rows_per = np.maximum(1, -(-deg // dmax))
    n_virt = int(rows_per.sum())
    n_virt_pad = int(-(-n_virt // pad_rows_to) * pad_rows_to)
    row_start = np.concatenate([[0], np.cumsum(rows_per)])
    edge_start = np.concatenate([[0], np.cumsum(deg)])
    # Edge e (sorted by dst) is the j-th in-edge of its node: row j // dmax
    # of that node's rows, column j % dmax.
    r, c = np.divmod(np.arange(len(dst)) - edge_start[dst], dmax)
    rows = row_start[dst] + r
    src_pad = np.zeros((n_virt_pad, dmax), np.int32)
    w_pad = np.full((n_virt_pad, dmax), INF, np.float32)
    src_pad[rows, c] = src
    w_pad[rows, c] = w
    real_of = np.zeros(n_virt_pad, np.int32)
    real_of[:n_virt] = np.repeat(np.arange(n_nodes, dtype=np.int32), rows_per)
    dev = resolve_device(device)
    return PaddedCSR(
        src_pad=torch.from_numpy(src_pad).to(dev),
        w_pad=torch.from_numpy(w_pad).to(dev),
        real_of=torch.from_numpy(real_of).to(dev), dmax=dmax,
        n_virtual=n_virt_pad)


@count.reports("padded_topk", roofline.topk_work)
def padded_topk(cand: torch.Tensor, k: int) -> torch.Tensor:
    """cand f32[Vv, C, F] (candidates <= INF, as ``bump_to_inf`` leaves
    them; C >= k) -> f32[Vv, F, K]: per row and keyword set the K smallest
    distinct candidates, ascending, INF-padded."""
    if cand.dtype != torch.float32 or cand.dim() != 3:
        raise ValueError(f"padded_topk wants f32[Vv, C, F], got "
                         f"{cand.dtype}{list(cand.shape)}")
    vv, c, f = cand.shape
    if k < 1 or c < k:
        raise ValueError(f"padded_topk wants 1 <= k and C >= k, got k={k}, "
                         f"C={c}")
    if not cand.is_contiguous():
        raise ValueError("padded_topk wants a contiguous candidate tensor")
    if cand.device.type == "cpu":
        return padded_topk_ref(cand, k)
    if f * k > ROW_FLOATS:
        raise ValueError(f"padded_topk: the CUDA kernel takes rows of "
                         f"F * k <= {ROW_FLOATS} floats (one row in a "
                         f"block's shared memory), got F={f}, k={k}")
    if cand.device.type not in ("cuda", "meta"):
        raise ValueError(f"padded_topk: unsupported device {cand.device}")
    out = torch.empty(vv, f, k, dtype=torch.float32, device=cand.device)
    if cand.device.type == "meta":
        return out
    if vv == 0 or f == 0:
        return out
    way = "templated" if k <= MAX_K else "wide"
    lib = cuda_build.library("padded_topk")
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    if way == "templated":
        err = lib.dks_padded_topk(cand.data_ptr(), out.data_ptr(), vv, c, f,
                                  k, stream)
    else:
        plan = topk_wide_plan(c, f, k)
        err = lib.dks_padded_topk_wide(
            cand.data_ptr(), out.data_ptr(), vv, c, f, k, plan.team,
            plan.chunk, plan.stage, plan.warp_floats, plan.warps,
            plan.blocks(vv), stream)
    counter.add()
    route_counters[way].add()
    cuda_build.check(err, "padded_topk")
    return out


def padded_candidates(S: torch.Tensor, csr: PaddedCSR,
                      changed: torch.Tensor) -> torch.Tensor:
    """The reduce's input: S f32[V, F, K], changed bool[V] ->
    cand f32[Vv, dmax * K, F], slot (edge, k) with keyword sets innermost:
    ``S[src] + w`` where the source fired, else INF, saturated at INF."""
    _, f, k = S.shape
    vv, dmax = csr.src_pad.shape
    src_flat = csr.src_pad.reshape(-1).long()
    cand = S[src_flat] + csr.w_pad.reshape(-1)[:, None, None]
    cand = torch.where(changed[src_flat][:, None, None], cand,
                       torch.full_like(cand, INF))
    cand = semiring.bump_to_inf(cand)
    return cand.reshape(vv, dmax, f, k).transpose(2, 3).reshape(
        vv, dmax * k, f)


def merge_virtual_rows(red: torch.Tensor, csr: PaddedCSR,
                       n_nodes: int) -> torch.Tensor:
    """Second-level merge of split hubs: red f32[Vv, F, K] per virtual row
    -> f32[n_nodes, F, K] per real node (few rows per node)."""
    vv, f, k = red.shape
    flat = red.transpose(1, 2).reshape(vv * k, f)     # rows (virtual, slot)
    seg = csr.real_of.repeat_interleave(k)
    return semiring.segment_topk_min(flat, seg, n_nodes, k)


def segment_minplus_padded(S: torch.Tensor, csr: PaddedCSR,
                           changed: torch.Tensor, k: int,
                           n_nodes: int) -> torch.Tensor:
    """One relax step on the padded layout: S[V, F, K] tables ->
    R[n_nodes, F, K] received tables (INF where nothing arrived)."""
    if S.dim() != 3 or S.shape[-1] != k:
        raise ValueError(f"segment_minplus_padded wants S [V, F, {k}], got "
                         f"{list(S.shape)}")
    red = padded_topk(padded_candidates(S, csr, changed), k)
    return merge_virtual_rows(red, csr, n_nodes)


def __getattr__(name: str):
    # ``ops.launches``: the total of ``counter`` over every thread, and
    # ``ops.launches_by_route``, read like plain attributes.
    if name == "launches":
        return counter.total
    if name == "launches_by_route":
        return {r: c.total for r, c in route_counters.items()}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
