"""The padded-CSR DKS relax: ``repro``'s ``kernels/segment_minplus/ops.py``
with the padded top-K reduce on the CUDA kernel (``csrc/padded_topk.cu``).

``padded_csr_from_graph`` (host, numpy) builds the degree-decomposed layout
once per graph; ``segment_minplus_padded`` runs one relax step: a torch
gather of the source tables plus the edge length
(:func:`padded_candidates`), the padded top-K reduce (:func:`padded_topk`),
and a torch second-level merge of split hubs (:func:`merge_virtual_rows`).

``padded_topk`` takes the plain version (:mod:`.ref`) on a CPU tensor; on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import INF
from repro_torch.core import semiring
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_build
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.kernels.segment_minplus.ref import padded_topk_ref
from repro_torch.kernels.subset_combine.ops import MAX_K

counter = LaunchCounter()


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
    if k > MAX_K:
        raise ValueError(f"padded_topk: the CUDA kernel supports 1 <= k <= "
                         f"{MAX_K}, got k={k}")
    if cand.device.type != "cuda":
        raise ValueError(f"padded_topk: unsupported device {cand.device}")
    out = torch.empty(vv, f, k, dtype=torch.float32, device=cand.device)
    if vv == 0 or f == 0:
        return out
    fn = cuda_build.library("padded_topk").dks_padded_topk
    err = fn(cand.data_ptr(), out.data_ptr(), vv, c, f, k,
             torch.cuda.current_stream(cand.device).cuda_stream)
    counter.add()
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
    # ``ops.launches``: the total of ``counter`` over every thread (and,
    # for flash, ``ops.launches_by_route``), read like a plain attribute.
    if name == "launches":
        return counter.total
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
