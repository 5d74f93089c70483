"""Hand-written CUDA kernels for Hopper (sources under ``../csrc``), each
beside its plain torch version:

- ``subset_combine`` — the per-node subset-convolution closure (replaces
  ``repro.kernels.subset_combine``'s ``subset_combine_t``);
- ``lane_superstep`` — one whole superstep's inner loop for every lane
  (replaces ``repro.kernels.lane_superstep``'s ``fused_lane_step``);
- ``flash_attention`` — causal GQA attention forward with an online
  softmax (replaces ``repro.kernels.flash_attention``'s
  ``flash_attention_bhsd``);
- ``embedding_bag`` — multi-hot weighted gather-sum (replaces
  ``repro.kernels.embedding_bag``'s ``embedding_bag_kernel``);
- ``segment_minplus`` — the padded-CSR relax reduce ``padded_topk``
  (replaces ``repro.kernels.segment_minplus``'s ``padded_topk``);
- ``batched_backtrace`` — the answer-tree obligation walk of a lane bucket
  (no Pallas kernel: ``repro.answers.batched``'s jitted ``while_loop``).
"""
