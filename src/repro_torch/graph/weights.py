"""Weight policies: fold the typed edge channel into effective weights.

A :class:`WeightPolicy` names a ranking semantics, and
:func:`apply_weight_policy` rewrites a typed :class:`Graph`'s weight vectors
once, on the host, before device packing — the relax kernels never know a
policy existed.  A numpy copy of ``repro.graph.weights``.

- ``degree`` (default): the stored weights as-is (the identity).
- ``confidence``: ``w_eff = w / conf**blend`` clamped to ``MIN_EDGE_WEIGHT``.
- either may carry ``predicates``, an allow-list of predicate names; edges
  with any other predicate get INF weight (disconnected).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import INF
from repro_torch.graph.structure import MIN_EDGE_WEIGHT, Graph

_KINDS = ("degree", "confidence")


@dataclasses.dataclass(frozen=True)
class WeightPolicy:
    """How per-edge provenance becomes the semiring's edge length."""

    kind: str = "degree"
    blend: float = 1.0
    predicates: tuple[str, ...] | None = None

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if not self.blend > 0:
            raise ValueError(f"blend must be > 0, got {self.blend!r}")
        if self.predicates is not None:
            preds = tuple(str(p) for p in self.predicates)
            if not preds:
                raise ValueError("predicates allow-list must be non-empty "
                                 "(use None for no filter)")
            object.__setattr__(self, "predicates", preds)

    @property
    def is_default(self) -> bool:
        """True iff applying this policy is the identity."""
        return self.kind == "degree" and self.predicates is None


def effective_weights(
    w: np.ndarray,
    pred: np.ndarray,
    conf: np.ndarray,
    policy: WeightPolicy,
    name_to_id: dict[str, int],
) -> np.ndarray:
    """Effective weight vector for one edge array whose ``pred``/``conf``
    align with ``w``.  INF stays INF; finite results clamp to
    ``MIN_EDGE_WEIGHT``."""
    w = np.asarray(w, np.float32)
    eff = w.copy()
    if policy.kind == "confidence":
        scaled = w / np.asarray(conf, np.float32) ** np.float32(policy.blend)
        eff = np.where(w >= INF, np.float32(INF),
                       np.maximum(scaled, np.float32(MIN_EDGE_WEIGHT)))
    if policy.predicates is not None:
        unknown = [p for p in policy.predicates if p not in name_to_id]
        if unknown:
            known = sorted(name_to_id)
            raise ValueError(
                f"unknown predicate(s) {unknown} in filter; "
                f"graph has {known}")
        ids = np.asarray(sorted(name_to_id[p] for p in policy.predicates),
                         np.int32)
        allowed = np.isin(np.asarray(pred, np.int32), ids)
        eff = np.where(allowed, eff, np.float32(INF))
    return eff.astype(np.float32, copy=False)


def apply_weight_policy(graph: Graph, policy: WeightPolicy | None) -> Graph:
    """Rewrite every weight vector of ``graph`` under ``policy``; the same
    object for the default policy.  Non-default policies need a typed
    graph."""
    if policy is None or policy.is_default:
        return graph
    if not graph.typed:
        raise ValueError(
            f"weight policy {policy!r} needs a typed graph; this graph "
            "has no predicate channel (re-ingest with a typed reader)")
    name_to_id = {n: i for i, n in enumerate(graph.pred_names or [])}
    new_ew = effective_weights(
        graph.ew, graph.csr_pred, graph.csr_conf, policy, name_to_id)
    new_w = graph.w
    if graph.pred is not None:
        new_w = effective_weights(
            graph.w, graph.pred, graph.conf, policy, name_to_id)
    sym_sorted = None
    sym_typed = graph.sym_typed
    if graph.sym_sorted is not None:
        typed = graph.sym_typed_edges()
        if typed is not None:
            s_src, s_dst, s_w = graph.sym_sorted
            sym_sorted = (s_src, s_dst, effective_weights(
                s_w, typed[0], typed[1], policy, name_to_id))
            sym_typed = typed
    return dataclasses.replace(
        graph, w=new_w, ew=new_ew,
        sym_sorted=sym_sorted, sym_typed=sym_typed)
