"""One front door for DKS relationship queries on the card.

    from repro_torch.engine import ExecutionPolicy, QueryEngine

    engine = QueryEngine.build(graph, tokens=tokens,
                               policy=ExecutionPolicy(backend="cuda"))
    result = engine.query([17, 42], k=3)

Public API:
  QueryEngine      — graph device residency, the inverted index, the lane
                     driver; ``query`` / ``query_batch``.
  ExecutionPolicy  — backend ("torch" | "cuda") and WeightPolicy, chosen
                     once at build.
  WeightPolicy     — degree | confidence-blended | predicate-filtered.
  QueryResult      — ranked AnswerTrees + superstep/message stats + SPA
                     bounds.
"""

from repro_torch.engine.engine import QueryEngine  # noqa: F401
from repro_torch.engine.policy import ExecutionPolicy  # noqa: F401
from repro_torch.engine.result import QueryResult  # noqa: F401
from repro_torch.graph.weights import WeightPolicy  # noqa: F401
