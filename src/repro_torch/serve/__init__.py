"""LM serving: over Aion's tiered KV cache, ``TieredKVCache`` (device page
pool + host tier, proactive staging, predictive cleanup) and the
``ContinuousBatcher`` that decodes through the paged-attention kernel
(K4); and the model-level step factories ``make_decode_step`` /
``make_prefill_step`` (greedy, tokens in and tokens out) over a model's
own decode cache.
"""
from repro_torch.serve.kvcache import TieredKVCache
from repro_torch.serve.scheduler import ContinuousBatcher, Request
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

__all__ = ["TieredKVCache", "ContinuousBatcher", "Request",
           "make_decode_step", "make_prefill_step"]
