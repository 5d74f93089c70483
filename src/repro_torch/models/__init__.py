"""The LM serving path: a dense decoder-only transformer (prefill and
greedy decode against a KV cache) whose prefill attention runs the
hand-written flash-attention kernel on the card.

  ``common``      — init helpers.
  ``attention``   — rotary, naive / chunked attention, the impl dispatch.
  ``transformer`` — the ``LM`` module, ``init_lm``, the cache.
  ``lm``          — the serving heads ``make_prefill_step`` /
                    ``make_decode_step``.
"""
