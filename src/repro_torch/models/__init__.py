"""The LM serving path: a decoder-only transformer, dense or MoE (prefill
and greedy decode against a bf16 or an int8 KV cache) whose prefill
attention runs the hand-written flash-attention kernel on the card.

  ``common``      — init helpers.
  ``attention``   — rotary, naive / chunked attention, the impl dispatch.
  ``moe``         — the MoE FFN on one device (router, capacity dispatch).
  ``kvcache``     — the int8 KV cache and its chunk-dequantized attention.
  ``transformer`` — the ``LM`` module, ``init_lm``, the cache.
  ``lm``          — the serving heads ``make_prefill_step`` /
                    ``make_decode_step``.
"""
