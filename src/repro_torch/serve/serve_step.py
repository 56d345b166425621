"""Serving step factories, as the JAX package's ``serve/serve_step.py``.

``decode_step``: one new token against an existing KV/SSM cache. Greedy
sampling keeps the step closed over integer tokens (tokens in -> tokens
out), which is what a production decode loop ships between hosts.

Under a mesh whose rules split the vocabulary, each rank holds its shard
of the logits; ``vocab_argmax`` gives every rank of a data shard the same
next tokens, the first index of the global max as ``jnp.argmax`` picks
it: each shard's max and the global index of its first occurrence, a MAX
over ``model``, then a MIN over the indices of the shards that hold the
max. The padded columns are masked to -1e30 by the unembedding and never
win.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import Model


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last dim of the logits, int32: over this rank's
    vocab shard merged across the ``VOCAB`` axis under a mesh."""
    ctx = shd.mesh_ctx()
    axis = None if ctx is None else ctx.axis(shd.VOCAB)
    if axis is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    mesh = ctx.mesh
    vp = logits.shape[-1]
    best = logits.amax(dim=-1)
    cols = torch.arange(vp, device=logits.device) + mesh.index(axis) * vp
    none = vp * mesh.size(axis)
    # this shard's first column of its max, by its global index
    first = torch.where(logits == best[..., None], cols, none).amin(dim=-1)
    top = col.all_reduce(best, mesh, axis, op="max")
    return col.all_reduce(torch.where(best == top, first, none), mesh, axis,
                          op="min").to(torch.int32)


def make_decode_step(model: Model):
    def decode_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache)
        return vocab_argmax(logits), cache
    return decode_step


def make_prefill_step(model: Model, max_len: int = 0):
    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch, max_len=max_len or None)
        return vocab_argmax(logits), cache
    return prefill_step
