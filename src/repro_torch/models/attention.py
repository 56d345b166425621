"""Attention for the train/prefill path: qkv -> RoPE -> attend -> o, as the
JAX package's ``models/attention.py`` ``attn_forward`` computes it.

The JAX package attends with ``blocked_attention``, a ``lax.scan`` with
online softmax that its autodiff differentiates. Here the attention is one
``torch.autograd.Function`` through ``ops.flash_attention_vjp``: the
forward is K5 and the backward K6 on the card, their plain versions on the
CPU. It computes the function ``blocked_attention`` computes; one rounding
differs in bf16: ``blocked_attention`` rounds ``q * scale`` to bf16 before
the score product, while K5 and K6 scale the fp32 scores.

Not ported here: ``kv_repeat != 1`` (K/V repeated for tensor-parallel
sharding) and ``xattn_kv`` / ``kv_valid_len`` (the encoder-decoder
family) raise; ``attn_decode`` and the int8 cache come with the serving
half of ``Model``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_apply, dense_init


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype, device) -> dict:
    """The attention block's parameters in the JAX layout: q [d, h, dh],
    k/v [d, hkv, dh], o [h, dh, d] (fan-in normal), biases when
    ``use_bias``."""
    d = cfg.d_model
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {}
    for name, heads in (("q", h), ("k", hkv), ("v", hkv)):
        out[name] = dense_init(generator, (d,), (heads, dh), dtype, device,
                               cfg.use_bias)
    out["o"] = dense_init(generator, (h, dh), (d,), dtype, device,
                          cfg.use_bias)
    return out


def attn_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, kv_repeat: int = 1,
                 causal: bool = True, window: int = 0,
                 return_kv: bool = False,
                 xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 kv_valid_len=None, causal_skip: bool = False):
    """Train/prefill attention. x: [B, S, D]. positions: [B, S].

    Returns (out, (k, v)): (k, v) are the post-RoPE heads when
    ``return_kv``, else None. ``causal_skip`` is accepted and has nothing
    to switch: K5 and K6 always skip the tiles that the mask empties."""
    if kv_repeat != 1:
        raise NotImplementedError("kv_repeat != 1 (K/V repeated for "
                                  "tensor-parallel sharding) is not ported")
    if xattn_kv is not None or kv_valid_len is not None:
        raise NotImplementedError("cross-attention (xattn_kv, "
                                  "kv_valid_len) is not ported")
    cd = x.dtype
    q = dense_apply(params["q"], x, cd)                      # [B,S,H,dh]
    k = dense_apply(params["k"], x, cd)
    v = dense_apply(params["v"], x, cd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention_vjp(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)
    y = dense_apply(params["o"], out, cd, contract_dims=2)
    return y, ((k, v) if return_kv else None)
