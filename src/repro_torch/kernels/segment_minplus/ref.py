"""Plain torch version of the padded top-K reduce (the CPU path and the
card-side oracle of ``csrc/padded_topk.cu``): ``repro``'s
``kernels/segment_minplus/ref.py::padded_topk_ref``.

Per virtual row and keyword set, the K smallest *distinct* candidates,
ascending, INF-padded: the DKS "receive messages" reduce on the
degree-decomposed layout.
"""

from __future__ import annotations

import torch

from repro_torch.core.semiring import sorted_unique_k


def padded_topk_ref(cand: torch.Tensor, k: int) -> torch.Tensor:
    """cand: [Vv, C, F] (C >= k) -> [Vv, F, K]."""
    return sorted_unique_k(cand.transpose(1, 2), k)
