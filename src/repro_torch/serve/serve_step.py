"""Serving step factories, as the JAX package's ``serve/serve_step.py``.

``decode_step``: one new token against an existing KV/SSM cache. Greedy
sampling keeps the step closed over integer tokens (tokens in -> tokens
out), which is what a production decode loop ships between hosts.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import Model


def make_decode_step(model: Model):
    def decode_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, cache
    return decode_step


def make_prefill_step(model: Model, max_len: int = 0):
    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch, max_len=max_len or None)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, cache
    return prefill_step
