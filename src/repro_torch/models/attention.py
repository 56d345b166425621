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

Cross-attention (the encoder-decoder and audio families): ``xattn_kv``
hands ``attn_forward`` the decoder layer's K/V of the encoder output
(RoPE'd at the encoder's positions by the caller, the model's
``_cross_kv``); q is RoPE'd at the decoder's positions and attends every
frame, non-causal, through the same K5/K6 call (Sq != Sk). Decode
attends them with ``decode_attention`` under ``xattn_len``'s mask of the
valid frames (``_cross_decode``; under a mesh each rank's q heads attend
the stored heads their global indices map to, and ``o`` is reduced over
``model``). ``kv_repeat`` (K/V heads repeated so that a
tensor-parallel head axis shards evenly) is ``_repeat_kv``, a
``repeat_interleave`` on the head axis, as ``jnp.repeat``.

Under a mesh of more than one rank with ``attn_tp`` (the ambient
``ShardCtx``), each rank keeps its query heads (``q`` is column-parallel,
its input through ``copy_to``) and its slice of the *stored* K/V heads,
as ``KV_HEADS -> model`` says: where the parameter heads shard
(``KV_PARAM_HEADS -> model``, ``num_kv_heads % model == 0``) it projects
its own; where they do not (``kv_repeat > 1``), every rank projects all
of them, repeats them, and takes its slice of the repeated heads behind
``copy_to``, so that the gradient of the replicated K/V weights is the
sum of every slice's share. K5 and K6 run unchanged on the local heads;
``o`` is row-parallel (summed over ``model``, its bias added once).
Without ``attn_tp`` attention is replicated over ``model``, the DP-only
fallback. ``kv_heads`` is that projection, for self-attention and for
the model's cross K/V of the encoder output. Under the decode rules
(``KV_HEADS`` whole, a prefill into the decode layout) it gives every
stored head, the parameter heads' shards gathered over ``model``, and
each rank's query heads attend the stored heads that their global
indices map to (``stored_for_q``), sliced before K5: K5 groups its query
heads by the *local* counts.

``kv_valid_len`` [B] is a per-row count of valid keys, the padding mask
of JAX's ``blocked_attention``, ANDed with the causal and window masks
in K5 and K6 (they end a row's key tiles at its length); the
cross-attention of ``_layer_forward`` takes ``xattn_len`` as it. A row
with no key left is NaN here, where JAX's finite -1e30 mask gives a
weighting of V over the blocks it scanned (ROADMAP Queue 3, item 27).

``attn_decode`` under a mesh (the decode rules of ``sharding_profile``:
``KV_HEADS`` unsplit, ``KV_SEQ -> model`` where the profile shards the
cache's sequence) is context-parallel: q is head-sharded over
``model``, and the cache holds every stored KV head over this rank's
slice of the slots (all of them where ``KV_SEQ`` does not split, and
then the merge is over one slice). Where JAX lets SPMD insert the
cross-shard softmax reductions, the port moves the data itself: the
step's q heads (and the new token's K/V heads, where their projection
is head-sharded) are gathered over ``model``; each rank scores every q
head against its own slots
(``decode_partials``: the partial max, sum of exponentials and
unnormalised readout) and the partials are merged across ``KV_SEQ``'s
axis by the log-sum-exp rule (``merge_partials``: a MAX, then one SUM of
the rescaled sums and readouts); each rank keeps its q heads for the
row-parallel ``o``. JAX rounds the *normalised* probabilities to the
cache's type before the readout; a partial rounds its unnormalised ones
(as K5 rounds P), so a bf16 merge cannot match JAX bit for bit, and a
float32 one meets it at float32's rounding. Only the rank whose slice
holds the slot writes the token (``shard_write``, the counterpart of
JAX's ``_shard_map_dus_write`` and of its masked write, whose results
are equal, so ``dus_write`` selects nothing); past the last slot of a
sequence-sharded cache no rank writes, as no JAX shard is in range,
where one device clamps the slot and overwrites the last one. Under the
train/prefill rules (``KV_HEADS`` split, every slot on each rank) the
decode is head-parallel (``_attn_decode_heads``, one device's decode on
each rank's q heads and stored heads): the token written at the slot on
every rank, nothing merged, ``o`` row-parallel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_apply, dense_init, \
    row_parallel, tp

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


def attn_specs(cfg: ModelConfig) -> dict:
    """Logical axes of ``attn_init``'s parameters, as JAX's
    ``attn_init`` gives them."""
    def dense(*logical):
        out = {"w": logical}
        if cfg.use_bias:
            out["b"] = logical[1:]
        return out
    o = {"w": (shd.HEADS, None, shd.FSDP)}
    if cfg.use_bias:
        o["b"] = (None,)
    return {"q": dense(shd.FSDP, shd.HEADS, None),
            "k": dense(shd.FSDP, shd.KV_PARAM_HEADS, None),
            "v": dense(shd.FSDP, shd.KV_PARAM_HEADS, None), "o": o}


def _repeat_kv(kv: torch.Tensor, repeat: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv * repeat, D], each head repeated in
    place (``jnp.repeat`` on the head axis), so groups stay contiguous."""
    if repeat == 1:
        return kv
    return torch.repeat_interleave(kv, repeat, dim=2)


def kv_heads(params, x: torch.Tensor, cfg: ModelConfig, *,
             positions: torch.Tensor, kv_repeat: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, v) [B, S, Hs, dh] projected from x [B, S, D]: K RoPE'd at
    ``positions``, both repeated by ``kv_repeat``; under a mesh with
    ``attn_tp``, the stored heads that ``KV_HEADS`` gives this rank
    (module docstring). Under the train/prefill rules (``KV_HEADS``
    split) that is this rank's slice: its own parameter heads behind
    ``copy_to`` on x, or, where the parameter heads do not shard, all of
    them repeated and sliced behind ``copy_to`` on the heads. Under the
    decode rules (``KV_HEADS`` whole) it is every stored head: the
    parameter heads' shards gathered over ``model`` (each rank's gradient
    reduce-scattered back), or all of them behind ``copy_to``.
    Self-attention's K/V, and the model's cross K/V of the encoder
    output."""
    cd = x.dtype
    mesh, axis = tp(shd.HEADS)
    hs = cfg.num_kv_heads * kv_repeat
    pa = tp(shd.KV_PARAM_HEADS)[1]
    split = axis is not None and tp(shd.KV_HEADS)[1] is not None
    whole = axis is not None and pa is None
    xk = x if whole else col.copy_to(x, mesh, axis)
    k = dense_apply(params["k"], xk, cd)
    v = dense_apply(params["v"], xk, cd)
    if cfg.rope_theta > 0:
        k = apply_rope(k, positions, cfg.rope_theta)
    k, v = _repeat_kv(k, kv_repeat), _repeat_kv(v, kv_repeat)
    if whole:
        k, v = col.copy_to(k, mesh, axis), col.copy_to(v, mesh, axis)
        if split:
            n = hs // mesh.size(axis)
            lo = mesh.index(axis) * n
            k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    elif axis is not None and not split:
        k, v = col.gather(k, mesh, pa, 2), col.gather(v, mesh, pa, 2)
    k = shd.constrain(k, shd.BATCH, None, shd.KV_HEADS, None,
                      full=(None, None, hs, None))
    v = shd.constrain(v, shd.BATCH, None, shd.KV_HEADS, None,
                      full=(None, None, hs, None))
    return k, v


def stored_for_q(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                 hq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stored heads of (k, v) [B, S, Hs, dh] (this rank's, by
    ``KV_HEADS``) that this rank's ``hq`` query heads (by ``HEADS``)
    attend, by the *global* head counts: each query head's group is
    ``num_heads / (Hs x the KV_HEADS shards)`` heads. Where the local
    query heads' groups are whole (or all within one group), the stored
    heads they map to, in place; else one stored head per query head.
    On one device, or where both axes split alike, (k, v) as given."""
    ctx = shd.mesh_ctx()
    if ctx is None:
        return k, v
    mesh = ctx.mesh
    qa, ka = ctx.axis(shd.HEADS), ctx.axis(shd.KV_HEADS)
    hs = k.shape[2]
    g = cfg.num_heads // (hs * (mesh.size(ka) if ka else 1))
    first = mesh.index(qa) * hq if qa else 0
    base = mesh.index(ka) * hs if ka else 0
    if hq % g == 0 or g % hq == 0:
        lo, n = first // g - base, max(hq // g, 1)
        if lo == 0 and n == hs:
            return k, v
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = (torch.arange(first, first + hq, device=k.device) // g) - base
    return k.index_select(2, idx), v.index_select(2, idx)


def attn_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, kv_repeat: int = 1,
                 causal: bool = True, window: int = 0,
                 return_kv: bool = False,
                 xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 kv_valid_len=None, causal_skip: bool = False):
    """Train/prefill attention. x: [B, S, D]. positions: [B, S].

    ``xattn_kv``: the precomputed (k, v) [B, F, Hs, dh] of
    cross-attention, attended as they come (no K/V of x is computed).
    ``kv_valid_len`` [B]: each row's count of valid keys (frames), a
    padding mask ANDed with the causal and window masks through K5/K6
    (under a mesh, this data shard's rows); it gets no gradient. Returns
    (out, (k, v)): (k, v) are the stored heads (post-RoPE, repeated by
    ``kv_repeat``) when ``return_kv`` or for cross-attention, else None.
    Under the decode rules (``KV_HEADS`` whole, ``HEADS`` split: a prefill
    into the decode layout) they are every stored head, and this rank's
    query heads attend the ones they map to (``stored_for_q``).
    ``causal_skip`` is accepted and has nothing to switch: K5 and K6
    always skip the tiles that the mask empties."""
    cd = x.dtype
    mesh, axis = tp(shd.HEADS)
    q = dense_apply(params["q"], col.copy_to(x, mesh, axis), cd)
    q = shd.constrain(q, shd.BATCH, None, shd.HEADS, None,
                      full=(None, None, cfg.num_heads, None))
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
    if xattn_kv is None:
        k, v = kv_heads(params, x, cfg, positions=positions,
                        kv_repeat=kv_repeat)
    else:
        k, v = xattn_kv
    ka, va = stored_for_q(k, v, cfg, q.shape[2])
    out = ops.flash_attention_vjp(q.contiguous(), ka.contiguous(),
                                  va.contiguous(), causal=causal,
                                  window=window, kv_valid_len=kv_valid_len)
    out = shd.constrain(out, shd.BATCH, None, shd.HEADS, None,
                        full=(None, None, cfg.num_heads, None))
    y = row_parallel(params["o"], out, cd, 2, mesh, axis)
    y = shd.constrain(y, shd.BATCH, None, None)
    return y, ((k, v) if return_kv or xattn_kv is not None else None)


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


def decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, valid_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``decode_attention`` over a slice of the slots, unnormalised: (the
    max of the valid scores [B, Hs, G], the sum of their exponentials
    [B, Hs, G], the readout [B, Hs, G, D]), all float32. The
    exponentials are rounded to the cache's type for the readout, and a
    slice with no valid slot gives (-1e30, 0, 0).

    q: [B, 1, Hq, D]; caches: [B, S, Hs, D]; valid_mask: [B, S] bool."""
    b, _, hq, dh = q.shape
    hs = k_cache.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, hs, hq // hs, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k_cache.float()) * scale
    mask = valid_mask[:, None, None, :]
    scores = torch.where(mask, scores,
                         torch.full((), NEG_INF, device=q.device))
    m = scores.amax(dim=-1)
    p = torch.where(mask, torch.exp(scores - m[..., None]),
                    torch.zeros((), device=q.device))
    acc = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return m, p.sum(dim=-1), acc


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   reduce_max, reduce_sum) -> torch.Tensor:
    """The attention output [B, Hs, G, D] from the partials of the slices,
    by the log-sum-exp rule: ``reduce_max`` gives the max over the slices,
    and one ``reduce_sum`` the sums of the rescaled exponential sums and
    readouts (each reducer maps this slice's tensor to the reduction over
    every slice: a collective across ranks, or a reduction over a stacked
    leading dim)."""
    top = reduce_max(m)
    w = torch.exp(m - top)
    both = reduce_sum(torch.cat([(l * w)[..., None], acc * w[..., None]],
                                dim=-1))
    return both[..., 1:] / both[..., :1]


def shard_write(cache: torch.Tensor, new: torch.Tensor, slot: int,
                lo: int) -> None:
    """Write ``new`` [B, 1, ...] at the global ``slot`` of a cache
    [B, S_local, ...] whose slots start at ``lo``, in place, if the slot
    lies in this slice; else nothing."""
    local = slot - lo
    if 0 <= local < cache.shape[1]:
        cache[:, local] = new[:, 0].to(cache.dtype)


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

    Cross-attention: ``xattn_kv`` (k, v) [B, F, Hs, dh] are attended
    under the mask of the first ``xattn_len`` [B] frames (all where
    None), q RoPE'd at ``cache_pos``; the caches are not read and are
    returned as given.

    Window archs use a ring of S_cache == window slots: the token goes to
    slot ``cache_pos % S_cache``. ``kv_scales``: (k_scale, v_scale)
    [B, S_cache, Hs] of an int8 cache: the new K/V are quantized on
    write, and the cache is dequantized in the compute type for the score
    and readout products. The first ``min(cache_pos + 1, S_cache)`` slots
    are attended.

    The caches (and scales) are written in place at the slot, where the
    JAX function returns updated copies; they are returned all the same.
    Under a mesh: the context-parallel decode of the module docstring
    (``cache_k``/``cache_v`` this rank's slice, ``x`` this data shard's
    rows); ``dus_write`` selects nothing.

    Returns (out, cache_k, cache_v, scales_or_None)."""
    if xattn_kv is not None:
        return _cross_decode(params, x, cfg, cache_pos=cache_pos,
                             xattn_kv=xattn_kv, xattn_len=xattn_len), \
            cache_k, cache_v, None
    kw = dict(cache_k=cache_k, cache_v=cache_v, cache_pos=cache_pos,
              kv_repeat=kv_repeat, window=window, kv_scales=kv_scales)
    ctx = shd.mesh_ctx()
    if ctx is not None and ctx.axis(shd.KV_HEADS) is None:
        return _attn_decode_mesh(params, x, cfg, **kw)
    return _attn_decode_heads(params, x, cfg, **kw)


def _write_and_attend(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, cfg: ModelConfig, *,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      cache_pos: int, window: int, kv_scales):
    """The decode of one token against a cache that holds every slot:
    the new K/V [B, 1, Hs, dh] written at the slot (quantized with their
    scales for an int8 cache), then q [B, 1, Hq, dh] against the first
    ``min(cache_pos + 1, S_cache)`` slots, each query head against the
    stored head it maps to (``stored_for_q``). Returns (out, the scales or
    None)."""
    cd = q.dtype
    b = q.shape[0]
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
    valid = (torch.arange(s_cache, device=q.device) < n_written)[None, :] \
        .expand(b, s_cache)
    k_att, v_att = stored_for_q(k_att, v_att, cfg, q.shape[2])
    return decode_attention(q, k_att, v_att, valid), new_scales


def _cross_decode(params, x: torch.Tensor, cfg: ModelConfig, *,
                  cache_pos: int, xattn_kv, xattn_len) -> torch.Tensor:
    """Cross-attention's decode: q RoPE'd at ``cache_pos`` against the
    cross (k, v) [B, F, Hs, dh] under ``xattn_len``'s mask. Under a mesh
    q holds this rank's heads (``HEADS``) and the cross heads are every
    stored head (the decode rules: ``KV_HEADS`` unsplit) or this rank's
    (the prefill rules): each local q head attends the stored head that
    its global index maps to, and ``o`` is row-parallel over ``model``.
    On one device that is every q head against its group's head."""
    mesh, qa = tp(shd.HEADS)
    cd = x.dtype
    b = x.shape[0]
    pos = torch.full((b, 1), cache_pos, dtype=torch.int32, device=x.device)
    q = dense_apply(params["q"], x, cd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
    k_all, v_all = xattn_kv
    f = k_all.shape[1]
    lens = torch.full((b,), f, device=x.device) if xattn_len is None \
        else torch.as_tensor(xattn_len, device=x.device)
    valid = torch.arange(f, device=x.device)[None, :] < lens[:, None]
    out = decode_attention(q, *stored_for_q(k_all, v_all, cfg, q.shape[2]),
                           valid)
    return row_parallel(params["o"], out, cd, 2, mesh, qa)


def _attn_decode_mesh(params, x: torch.Tensor, cfg: ModelConfig, *,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      cache_pos: int, kv_repeat: int, window: int,
                      kv_scales):
    """``attn_decode`` under a mesh whose rules keep the stored KV heads
    whole (the decode rules): the context-parallel decode (module
    docstring)."""
    ctx = shd.mesh_ctx()
    mesh = ctx.mesh
    qa, pa, sa = (ctx.axis(shd.HEADS), ctx.axis(shd.KV_PARAM_HEADS),
                  ctx.axis(shd.KV_SEQ))
    cd = x.dtype
    b = x.shape[0]
    pos = torch.full((b, 1), cache_pos, dtype=torch.int32, device=x.device)
    q = dense_apply(params["q"], x, cd)
    k_new = dense_apply(params["k"], x, cd)
    v_new = dense_apply(params["v"], x, cd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    q_local = q.shape[2]
    # every rank scores every q head against its slots: q, and the new
    # token's K/V where their projection is head-sharded, gathered
    q = col.all_gather(q, mesh, qa, 2)
    if pa is not None:
        k_new = col.all_gather(k_new, mesh, pa, 2)
        v_new = col.all_gather(v_new, mesh, pa, 2)
    k_new, v_new = _repeat_kv(k_new, kv_repeat), _repeat_kv(v_new, kv_repeat)
    if kv_scales is not None:
        k_new, k_scale_new = _quantize_kv(k_new)
        v_new, v_scale_new = _quantize_kv(v_new)

    s_loc = cache_k.shape[1]
    s_cache = s_loc * mesh.size(sa) if sa is not None else s_loc
    lo = mesh.index(sa) * s_loc if sa is not None else 0
    if window > 0:
        slot = cache_pos % s_cache
    elif sa is None:
        # the whole cache on this rank: one device's clamped write
        slot = min(cache_pos, s_cache - 1)
    else:
        # past the last slot no slice holds it, and nothing is written
        slot = cache_pos
    shard_write(cache_k, k_new, slot, lo)
    shard_write(cache_v, v_new, slot, lo)
    new_scales = None
    if kv_scales is not None:
        k_scale, v_scale = kv_scales
        shard_write(k_scale, k_scale_new, slot, lo)
        shard_write(v_scale, v_scale_new, slot, lo)
        new_scales = (k_scale, v_scale)
        k_att = cache_k.to(cd) * k_scale[..., None].to(cd)
        v_att = cache_v.to(cd) * v_scale[..., None].to(cd)
    else:
        k_att, v_att = cache_k, cache_v

    n_written = min(cache_pos + 1, s_cache)
    valid = (torch.arange(lo, lo + s_loc, device=x.device)
             < n_written)[None, :].expand(b, s_loc)
    # with every slot on this rank (sa None) the merge is over one slice
    def rmax(t):
        return t if sa is None else col.all_reduce(t, mesh, sa, op="max")

    def rsum(t):
        return t if sa is None else col.all_reduce(t, mesh, sa)

    out = merge_partials(*decode_partials(q, k_att, v_att, valid), rmax,
                         rsum).reshape(q.shape).to(cd)
    if qa is not None:
        lo_h = mesh.index(qa) * q_local
        out = out[:, :, lo_h:lo_h + q_local]
    y = row_parallel(params["o"], out, cd, 2, mesh, qa)
    return y, cache_k, cache_v, new_scales


def _attn_decode_heads(params, x: torch.Tensor, cfg: ModelConfig, *,
                       cache_k: torch.Tensor, cache_v: torch.Tensor,
                       cache_pos: int, kv_repeat: int, window: int,
                       kv_scales):
    """``attn_decode`` on one device, and under the train/prefill rules
    (``KV_HEADS`` split, no ``KV_SEQ``) head-parallel: each rank projects
    its q heads and the new token's K/V of its stored heads
    (``kv_heads``), writes them at the slot of its cache (its stored
    heads, every slot: nothing to merge, the window ring and the int8
    scales as on one device), attends as one device does, each q head
    against the stored head that its global index maps to, and ``o`` is
    row-parallel over ``model``."""
    mesh, qa = tp(shd.HEADS)
    cd = x.dtype
    pos = torch.full((x.shape[0], 1), cache_pos, dtype=torch.int32,
                     device=x.device)
    q = dense_apply(params["q"], x, cd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
    k_new, v_new = kv_heads(params, x, cfg, positions=pos,
                            kv_repeat=kv_repeat)
    out, new_scales = _write_and_attend(
        q, k_new, v_new, cfg, cache_k=cache_k, cache_v=cache_v,
        cache_pos=cache_pos, window=window, kv_scales=kv_scales)
    y = row_parallel(params["o"], out, cd, 2, mesh, qa)
    return y, cache_k, cache_v, new_scales
