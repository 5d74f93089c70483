"""Graph substrate: host storage, device edge list, text index, weights,
generators."""

from repro_torch.graph.structure import (  # noqa: F401
    MIN_EDGE_WEIGHT, DeviceGraph, Graph, build_graph, degree_weights,
)
from repro_torch.graph.weights import (  # noqa: F401
    WeightPolicy, apply_weight_policy, effective_weights,
)
