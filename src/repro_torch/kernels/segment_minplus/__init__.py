from repro_torch.kernels.segment_minplus.ops import (  # noqa: F401
    PaddedCSR, padded_csr_from_graph, padded_topk, segment_minplus_padded,
)
