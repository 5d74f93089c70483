"""repro_torch.answers — the answer subsystem: from the final DP table to
servable, ranked, diversified answer trees (the port of ``repro.answers``).

Layers:

  batched    — device-batched lane-parallel backtrace over a whole bucket
               (a stable device sort picks the candidates, one CUDA launch
               walks them; bit-for-bit host parity; ragged stragglers fall
               back to the host search)
  diversify  — Jaccard tree distance, MMR diversified ordering, greedy
               clustering (duplication-free top-K)
  render     — label-rendered trees (RenderedTree) and cursor pagination
               (TreePage)
  streaming  — ExtractionOverlap: reconstruct frozen lanes' trees on host
               threads while the device finishes the bucket

Public API:
  BatchedBacktracer, BatchedBacktrace, split_pair_table
  tree_distance, diversified_order, top_k_diverse, cluster_trees
  RenderedTree, RenderedEdge, TreePage, render_tree, paginate
  ExtractionOverlap
"""

from repro_torch.answers.batched import (  # noqa: F401
    BatchedBacktrace,
    BatchedBacktracer,
    split_pair_table,
)
from repro_torch.answers.diversify import (  # noqa: F401
    cluster_trees,
    diversified_order,
    top_k_diverse,
    tree_distance,
)
from repro_torch.answers.render import (  # noqa: F401
    RenderedEdge,
    RenderedTree,
    TreePage,
    default_label,
    paginate,
    render_tree,
)
from repro_torch.answers.streaming import ExtractionOverlap  # noqa: F401
