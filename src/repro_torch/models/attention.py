"""Attention for the train/prefill path: qkv -> RoPE -> attend -> o, as the
JAX package's ``models/attention.py`` ``attn_forward`` computes it.

The JAX package attends with ``blocked_attention``, a ``lax.scan`` with
online softmax that its autodiff differentiates. Here the attention is one
``torch.autograd.Function`` through ``ops.flash_attention_vjp``: the
forward is K5 and the backward K6 on the card, their plain versions on the
CPU. It computes the function ``blocked_attention`` computes; one rounding
differs in bf16: ``blocked_attention`` rounds ``q * scale`` to bf16 before
the score product, while K5 and K6 scale the fp32 scores.

Decode (``attn_decode``) attends one new token against a cache in plain
torch (``decode_attention``: a matmul and a softmax), as the JAX package
computes it outside any Pallas kernel; the paged kernel K4 serves the
tiered batcher of ``serve/``, not this cache. A window arch keeps a ring
of ``window`` slots (position ``pos`` at slot ``pos % window``), and an
int8 cache keeps a scale per vector, quantized on write and dequantized
for the two products.

Not ported here: ``kv_repeat != 1`` (K/V repeated for tensor-parallel
sharding) and ``xattn_kv`` / ``kv_valid_len`` (the encoder-decoder
family) raise. ``dus_write`` (the JAX per-shard write into a
sequence-sharded cache) is accepted and has nothing to switch on one
card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_apply, dense_init

NEG_INF = -1e30


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid_mask: torch.Tensor) -> torch.Tensor:
    """Single-step attention against a cache, as the JAX function: the
    scores in fp32 from the cache's type, masked to -1e30, a softmax, the
    probabilities rounded to the cache's type and the readout summed in
    fp32.

    q: [B, 1, Hq, D]; caches: [B, S, Hs, D]; valid_mask: [B, S] bool."""
    b, _, hq, dh = q.shape
    _, s, hs, _ = k_cache.shape
    g = hq // hs
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, hs, g, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k_cache.float()) * scale
    scores = torch.where(valid_mask[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def _quantize_kv(x: torch.Tensor):
    """[..., dh] -> (int8 values, per-vector scale in x's type)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-9
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127) \
        .to(torch.int8)
    return q, scale.to(x.dtype)


def attn_decode(params, x: torch.Tensor, cfg: ModelConfig, *,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                cache_pos: int, kv_repeat: int = 1, window: int = 0,
                xattn_kv=None, xattn_len=None, kv_scales=None,
                dus_write: bool = False):
    """Decode one token. x: [B, 1, D]; caches [B, S_cache, Hs, dh];
    ``cache_pos``: the new token's absolute position (an int).

    Window archs use a ring of S_cache == window slots: the token goes to
    slot ``cache_pos % S_cache``. ``kv_scales``: (k_scale, v_scale)
    [B, S_cache, Hs] of an int8 cache: the new K/V are quantized on
    write, and the cache is dequantized in the compute type for the score
    and readout products. The first ``min(cache_pos + 1, S_cache)`` slots
    are attended.

    The caches (and scales) are written in place at the slot, where the
    JAX function returns updated copies; they are returned all the same.
    Returns (out, cache_k, cache_v, scales_or_None)."""
    if kv_repeat != 1:
        raise NotImplementedError("kv_repeat != 1 (tensor-parallel K/V "
                                  "repeat) is not ported")
    if xattn_kv is not None or xattn_len is not None:
        raise NotImplementedError("cross-attention decode (xattn_kv) is "
                                  "not ported")
    cd = x.dtype
    b = x.shape[0]
    pos = torch.full((b, 1), cache_pos, dtype=torch.int32, device=x.device)
    q = dense_apply(params["q"], x, cd)
    k_new = dense_apply(params["k"], x, cd)
    v_new = dense_apply(params["v"], x, cd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    s_cache = cache_k.shape[1]
    # past the last slot, a full-attention cache overwrites that slot, as
    # the JAX dynamic_update_slice clamps its index
    slot = cache_pos % s_cache if window > 0 else min(cache_pos, s_cache - 1)
    if kv_scales is not None:
        k_new, k_scale_new = _quantize_kv(k_new)
        v_new, v_scale_new = _quantize_kv(v_new)
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)

    new_scales = None
    if kv_scales is not None:
        k_scale, v_scale = kv_scales
        k_scale[:, slot] = k_scale_new[:, 0].to(k_scale.dtype)
        v_scale[:, slot] = v_scale_new[:, 0].to(v_scale.dtype)
        new_scales = (k_scale, v_scale)
        k_att = cache_k.to(cd) * k_scale[..., None].to(cd)
        v_att = cache_v.to(cd) * v_scale[..., None].to(cd)
    else:
        k_att, v_att = cache_k, cache_v

    n_written = min(cache_pos + 1, s_cache)
    valid = (torch.arange(s_cache, device=x.device) < n_written)[None, :] \
        .expand(b, s_cache)
    out = decode_attention(q, k_att, v_att, valid)
    y = dense_apply(params["o"], out, cd, contract_dims=2)
    return y, cache_k, cache_v, new_scales
