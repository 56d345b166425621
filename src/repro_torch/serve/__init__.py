"""LM serving over Aion's tiered KV cache: ``TieredKVCache`` (device page
pool + host tier, proactive staging, predictive cleanup) and the
``ContinuousBatcher`` that decodes through the paged-attention kernel
(K4).

The JAX package's ``make_decode_step`` / ``make_prefill_step``
(``serve/serve_step.py``) run a model, and wait for the slice that ports
``models/``.
"""
from repro_torch.serve.kvcache import TieredKVCache
from repro_torch.serve.scheduler import ContinuousBatcher, Request

__all__ = ["TieredKVCache", "ContinuousBatcher", "Request"]
