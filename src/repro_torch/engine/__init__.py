"""One front door for DKS relationship queries on the card.

    from repro_torch.engine import ExecutionPolicy, QueryEngine

    engine = QueryEngine.build(graph, tokens=tokens,
                               policy=ExecutionPolicy(backend="cuda"))
    result = engine.query([17, 42], k=3)

Public API:
  QueryEngine      — graph device residency, the inverted index, the lane
                     driver; ``query`` / ``query_batch`` / ``query_stream``
                     / ``query_streamed`` / ``query_deadline(_batch)`` /
                     ``query_instrumented``.
  ExecutionPolicy  — backend ("torch" | "cuda"), WeightPolicy and
                     telemetry, chosen once at build.
  AdaptiveLanePolicy / LaneDecision — the serve layer's measured lane
                     padding.
  WeightPolicy     — degree | confidence-blended | predicate-filtered.
  QueryResult      — ranked AnswerTrees + superstep/message stats + SPA
                     bounds.
  StreamUpdate     — per-superstep answers with tightening bounds.
"""

from repro_torch.engine.engine import QueryEngine  # noqa: F401
from repro_torch.engine.policy import (  # noqa: F401
    AdaptiveLanePolicy,
    ExecutionPolicy,
    LaneDecision,
)
from repro_torch.engine.result import QueryResult, StreamUpdate  # noqa: F401
from repro_torch.graph.weights import WeightPolicy  # noqa: F401
