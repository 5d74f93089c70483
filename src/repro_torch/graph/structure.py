"""Graph storage.

Two views of a graph:

- :class:`Graph` — host-side container (numpy): CSR over the symmetrized
  graph for the inverted index and answer reconstruction, node text labels,
  raw directed edges.  A copy of ``repro.graph.structure.Graph``.
- :class:`DeviceGraph` — a plain dataclass of torch tensors: the
  symmetrized, padded edge list sorted by destination, exactly what the DKS
  relaxation consumes (the same layout as ``repro``'s ``DeviceGraph``).

Edge weights follow the paper (Sec. 7.1): ``w(e) = int(log10(d_in(dst)))``
clipped to >= 1 below a degree threshold tau, and "infinite" (the INF
sentinel) above it — high-degree hub nodes are effectively disconnected.

Both views optionally carry a *typed channel*: per-edge ``(pred, conf)``.
A :class:`repro_torch.graph.weights.WeightPolicy` folds it into the
effective weight vector before device packing.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import INF
from repro_torch.device import host_tensor, resolve_device

# Floor for effective edge weights (Theorem 1 needs w > 0): weights in
# [0, MIN_EDGE_WEIGHT) clamp up to it; negative weights raise.
MIN_EDGE_WEIGHT = 1e-3

# A node with more in-edges than this is a hub: the lane-superstep kernel
# walks its in-edges with a warp instead of one thread.
HUB_IN_DEGREE = 32


def hub_nodes(offsets: torch.Tensor) -> torch.Tensor:
    """int32 ids of the nodes with more than ``HUB_IN_DEGREE`` in-edges
    under ``offsets`` (int64[V + 1], node v's in-edges at ``offsets[v]`` to
    ``offsets[v + 1]``), most in-edges first (ties by id), on ``offsets``'
    device."""
    deg = offsets.diff()
    hubs = (deg > HUB_IN_DEGREE).nonzero().flatten()
    order = torch.sort(deg[hubs], descending=True, stable=True).indices
    return hubs[order].int()


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Symmetrized padded edge-list graph living on one torch device.

    Attributes:
      src, dst: int32[E_pad] endpoints (padded entries point at node 0).
      w:        float32[E_pad] edge lengths (INF on padded entries).
      valid:    bool[E_pad] real-edge mask.
      out_degree: int32[V_pad] symmetric degree (0 on padded nodes).
      node_valid: bool[V_pad].
      in_offsets: int64[V_pad + 1]; node v's real in-edges are entries
        ``in_offsets[v]`` to ``in_offsets[v + 1]`` (the ranges the
        lane-superstep kernel walks).
      hub_nodes: int32[H], :func:`hub_nodes` of ``in_offsets``: the
        nodes the lane-superstep kernel gives a warp.
      n_nodes / n_edges: true counts (pre-padding).  Real edges are the
        first ``n_edges`` entries, sorted by ``dst``.
      pred / conf: optional typed channel (int32 / float32[E_pad]).
    """

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    valid: torch.Tensor
    out_degree: torch.Tensor
    node_valid: torch.Tensor
    in_offsets: torch.Tensor
    hub_nodes: torch.Tensor
    n_nodes: int
    n_edges: int
    pred: torch.Tensor | None = None
    conf: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def v_pad(self) -> int:
        return self.out_degree.shape[0]

    @property
    def e_pad(self) -> int:
        return self.src.shape[0]

    def e_min(self) -> torch.Tensor:
        """Smallest real edge length (the paper's ``e_min``), f32[]."""
        return torch.where(self.valid, self.w,
                           torch.full_like(self.w, INF)).min()


@dataclasses.dataclass
class Graph:
    """Host-side graph: directed raw edges + CSR over the symmetrized graph."""

    n_nodes: int
    # Raw directed edges.
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    # Symmetrized CSR (host): indptr[V+1], indices[E_sym], ew[E_sym].
    indptr: np.ndarray
    indices: np.ndarray
    ew: np.ndarray
    labels: list[str] | None = None
    # Optional dst-sorted symmetric edge list (src, dst, w) — the exact
    # device layout; None on in-memory graphs (computed on demand).
    sym_sorted: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
    # Optional typed channel: pred/conf align with src/dst/w; csr_pred /
    # csr_conf with indices/ew; sym_typed with sym_sorted.
    pred: np.ndarray | None = None
    conf: np.ndarray | None = None
    csr_pred: np.ndarray | None = None
    csr_conf: np.ndarray | None = None
    sym_typed: tuple[np.ndarray, np.ndarray] | None = None
    pred_names: list[str] | None = None

    @property
    def n_edges_directed(self) -> int:
        return len(self.src)

    @property
    def n_edges_sym(self) -> int:
        return len(self.indices)

    @property
    def typed(self) -> bool:
        return self.csr_pred is not None

    def neighbors(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[v], self.indptr[v + 1]
        return self.indices[s:e], self.ew[s:e]

    def edge_channel(self, u: int, v: int) -> tuple[str | None, float] | None:
        """``(predicate_name, confidence)`` of the *cheapest* parallel
        edge between ``u`` and ``v`` — the entry ``_edge_weight`` (and so
        backtrace / rendering) resolves to.  None on untyped graphs or
        when no such edge exists."""
        if self.csr_pred is None:
            return None
        s, e = self.indptr[u], self.indptr[u + 1]
        hits = np.nonzero(self.indices[s:e] == v)[0]
        if not len(hits):
            return None
        j = int(hits[int(np.argmin(self.ew[s:e][hits]))])
        pid = int(self.csr_pred[s:e][j])
        name = None
        if self.pred_names is not None and 0 <= pid < len(self.pred_names):
            name = self.pred_names[pid]
        return name, float(self.csr_conf[s:e][j])

    def sym_sorted_edges(
        self, cache: bool = False,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dst-sorted symmetric edge list ``(src, dst, w)`` — the device
        layout.  ``cache=True`` keeps the triple on ``sym_sorted``."""
        if self.sym_sorted is not None:
            return self.sym_sorted
        deg = np.diff(self.indptr)
        src = np.repeat(np.arange(self.n_nodes, dtype=np.int32), deg)
        dst = self.indices.astype(np.int32)
        w = self.ew.astype(np.float32)
        order = np.argsort(dst, kind="stable")
        triple = (src[order], dst[order], w[order])
        if cache:
            self.sym_sorted = triple
        return triple

    def sym_typed_edges(
        self, cache: bool = False,
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Typed channel aligned with :meth:`sym_sorted_edges`; None on
        untyped graphs."""
        if self.csr_pred is None:
            return None
        if self.sym_typed is not None:
            return self.sym_typed
        order = np.argsort(self.indices.astype(np.int32), kind="stable")
        typed = (self.csr_pred[order].astype(np.int32, copy=False),
                 self.csr_conf[order].astype(np.float32, copy=False))
        if cache:
            self.sym_typed = typed
        return typed

    def to_device(
        self,
        device: str | torch.device | None = None,
        pad_nodes_to: int | None = None,
        pad_edges_to: int | None = None,
    ) -> DeviceGraph:
        """Build the padded, dst-sorted device edge list on ``device``
        (``None``: the card — see :func:`repro_torch.device.resolve_device`)."""
        dev = resolve_device(device)
        v = self.n_nodes
        deg = np.diff(self.indptr)
        src, dst, w = self.sym_sorted_edges()
        src = src.astype(np.int32, copy=False)
        dst = dst.astype(np.int32, copy=False)
        w = w.astype(np.float32, copy=False)

        e = len(src)
        v_pad = pad_nodes_to or v
        e_pad = pad_edges_to or e
        if v_pad < v or e_pad < e:
            raise ValueError("padding smaller than graph")
        pad_e = e_pad - e
        src = np.concatenate([src, np.zeros(pad_e, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad_e, np.int32)])
        w = np.concatenate([w, np.full(pad_e, INF, np.float32)])
        valid = np.concatenate([np.ones(e, bool), np.zeros(pad_e, bool)])
        out_degree = np.zeros(v_pad, np.int32)
        out_degree[:v] = deg
        node_valid = np.zeros(v_pad, bool)
        node_valid[:v] = True
        in_offsets = np.zeros(v_pad + 1, np.int64)
        np.cumsum(np.bincount(dst[:e], minlength=v_pad), out=in_offsets[1:])

        def put(a: np.ndarray) -> torch.Tensor:
            return host_tensor(a, dev)

        pred = conf = None
        typed = self.sym_typed_edges()
        if typed is not None:
            pred = put(np.concatenate([typed[0],
                                       np.full(pad_e, -1, np.int32)]))
            conf = put(np.concatenate([typed[1],
                                       np.ones(pad_e, np.float32)]))
        offsets = put(in_offsets)
        return DeviceGraph(
            src=put(src), dst=put(dst), w=put(w), valid=put(valid),
            out_degree=put(out_degree), node_valid=put(node_valid),
            in_offsets=offsets, hub_nodes=hub_nodes(offsets), n_nodes=v,
            n_edges=e, pred=pred, conf=conf,
        )


def degree_weights(
    dst: np.ndarray, n_nodes: int, tau: int = 1001
) -> np.ndarray:
    """Paper Sec. 7.1 edge-length model: step function of target in-degree.

    ``w = max(1, int(log10 d_in(dst)))`` for ``d_in < tau``; INF otherwise.
    """
    d_in = np.bincount(dst, minlength=n_nodes)
    wd = np.maximum(1, np.log10(np.maximum(d_in, 1)).astype(np.int64))
    wd = np.where(d_in >= tau, np.int64(INF), wd)
    return wd[dst].astype(np.float32)


def build_graph(
    src: Sequence[int] | np.ndarray,
    dst: Sequence[int] | np.ndarray,
    n_nodes: int,
    w: np.ndarray | None = None,
    labels: list[str] | None = None,
    tau: int = 1001,
    pred: np.ndarray | None = None,
    conf: np.ndarray | None = None,
    pred_names: list[str] | None = None,
) -> Graph:
    """Build a host Graph from directed edges; symmetrize; CSR-index.

    If ``w`` is None, weights follow the paper's degree model.  Reverse
    edges get the forward edge's weight.  With ``pred``/``conf`` dedup is
    type-aware (per ``(u, v, pred)`` the min-weight, then max-confidence
    entry wins); otherwise the min weight per ``(u, v)`` wins.
    """
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if w is None:
        w = degree_weights(dst, n_nodes, tau=tau)
    w = np.asarray(w, np.float32)
    if len(src) and (w < 0).any():
        raise ValueError("edge weights must be non-negative (paper requires w>0)")
    w = np.where(w < MIN_EDGE_WEIGHT, np.float32(MIN_EDGE_WEIGHT), w)
    if conf is not None and pred is None:
        raise ValueError("conf requires pred (readers synthesize a "
                         "predicate id when only confidences exist)")
    typed = pred is not None
    if typed:
        pred = np.asarray(pred, np.int32)
        conf = (np.ones(len(src), np.float32) if conf is None
                else np.asarray(conf, np.float32))
        if len(src) and (conf <= 0).any():
            raise ValueError("edge confidences must be positive")

    # Symmetrize: forward + reverse with equal weight; drop exact duplicates.
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    ww = np.concatenate([w, w])
    pp = np.concatenate([pred, pred]) if typed else None
    cc = np.concatenate([conf, conf]) if typed else None
    keep = u != v  # self loops contribute nothing to trees
    u, v, ww = u[keep], v[keep], ww[keep]
    if typed:
        pp, cc = pp[keep], cc[keep]
    if len(u):
        key = u.astype(np.int64) * n_nodes + v.astype(np.int64)
        if typed:
            order = np.lexsort((-cc, ww, pp, key))
            key, u, v, ww = key[order], u[order], v[order], ww[order]
            pp, cc = pp[order], cc[order]
            first = np.ones(len(key), bool)
            first[1:] = (key[1:] != key[:-1]) | (pp[1:] != pp[:-1])
            u, v, ww, pp, cc = u[first], v[first], ww[first], pp[first], cc[first]
        else:
            order = np.lexsort((ww, key))
            key, u, v, ww = key[order], u[order], v[order], ww[order]
            first = np.ones(len(key), bool)
            first[1:] = key[1:] != key[:-1]
            u, v, ww = u[first], v[first], ww[first]

    order = np.argsort(u, kind="stable")
    u, v, ww = u[order], v[order], ww[order]
    if typed:
        pp, cc = pp[order], cc[order]
    counts = np.bincount(u, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(
        n_nodes=n_nodes, src=src, dst=dst, w=w.astype(np.float32, copy=False),
        indptr=indptr, indices=v.astype(np.int32), ew=ww.astype(np.float32),
        labels=labels,
        pred=pred, conf=conf,
        csr_pred=pp.astype(np.int32, copy=False) if typed else None,
        csr_conf=cc.astype(np.float32, copy=False) if typed else None,
        pred_names=list(pred_names) if pred_names is not None else None,
    )
