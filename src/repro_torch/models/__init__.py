"""The LM path, dense or MoE (prefill and greedy decode against a bf16 or
an int8 KV cache, and training), whose prefill attention runs the
hand-written flash-attention kernel on the card; and DCN-v2.

  ``common``      — init helpers.
  ``attention``   — rotary, naive / chunked / flash_jax attention, the
                    impl dispatch.
  ``moe``         — the MoE FFN on one device (router, capacity dispatch).
  ``kvcache``     — the int8 KV cache and its chunk-dequantized attention.
  ``transformer`` — the ``LM`` module, ``init_lm``, the cache.
  ``lm``          — the loss and the train step (``TrainState``,
                    ``make_train_step``), the serving heads
                    ``make_prefill_step`` / ``make_decode_step``.
  ``recsys``      — DCN-v2: serving and ``dcn_loss``.
"""
