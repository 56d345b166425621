"""Mixture-of-experts FFN, as the JAX package's ``models/moe.py`` computes
it on one device.

Routing runs in float32: router logits, softmax, top-k, the renormalised
weights, Switch's load-balancing aux loss and the router z-loss. Each
expert then keeps at most ``capacity`` tokens, those of the largest
affinity (GShard/Switch capacity, ``_capacity``); the kept tokens are
gathered, run through the expert FFN as batched products, scaled by their
gate and scatter-added into the output. Overflow tokens contribute
nothing (their residual passes through).

Top-k follows ``jax.lax.top_k``: on ties the lower index comes first.
``torch.topk`` makes no such promise, so both choices (the router's top-k
experts and each expert's top-capacity tokens) take a stable descending
``torch.sort`` and slice it. The per-expert choice is full of ties: the
affinities are in the compute type and most of them are exactly 0.

The expert products are plain torch here, as they are einsums outside any
kernel in the JAX package. The JAX ``shard_map`` branch (experts sharded
over the ``model`` mesh axis, partial outputs summed by ``psum``) is
multi-device work and is not ported; on one card it has nothing to
switch. The scatter-add sums up to ``top_k`` contributions per token; on
the card ``index_add_`` adds them by atomics in no fixed order, so in
bf16 the output differs from the CPU's by rounding.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device) -> Dict[str, object]:
    """The router (a float32 dense [d, E], whatever ``dtype`` is) and the
    experts' ``wg``/``wu`` [E, d, f] and ``wd`` [E, f, d] in ``dtype``
    (normal, fan-in scaled), in the JAX layout."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    router = dense_init(generator, (d,), (e,), torch.float32, device)

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return w.mul_(1.0 / math.sqrt(fan_in))

    return {"router": router, "wg": draw((e, d, f), d),
            "wu": draw((e, d, f), d), "wd": draw((e, f, d), f)}


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Tokens an expert keeps: ``ceil(T·k·cf/E)`` rounded up to 64, then
    clamped to ``[64, T]``."""
    e, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    c = int(math.ceil(tokens * k * cf / e))
    c = ((c + 63) // 64) * 64                      # lane-align
    return min(max(c, 64), tokens)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis and their indices, largest
    first and the lower index first on ties, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(x_flat: torch.Tensor, idx: torch.Tensor, wts: torch.Tensor,
                wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                capacity: int, variant: str) -> torch.Tensor:
    """x_flat [T, D]; idx/wts [T, K]; wg/wu/wd [E, ...]. Each expert's
    affinity for each token (its routing weight, else 0), its top
    ``capacity`` tokens gathered through the FFN, gated and
    scatter-added. Returns [T, D] in the compute type."""
    e = wg.shape[0]
    t, d = x_flat.shape
    eids = torch.arange(e, dtype=idx.dtype, device=idx.device)
    hit = idx[None, :, :] == eids[:, None, None]              # [E, T, K]
    aff = torch.where(hit, wts[None], torch.zeros((), dtype=wts.dtype,
                                                  device=wts.device)).sum(-1)
    gate, token_ids = top_k(aff, capacity)                    # [E, C]
    flat_ids = token_ids.reshape(-1)
    xg = x_flat[flat_ids].reshape(e, capacity, d)             # [E, C, D]
    if variant == "swiglu":
        h = F.silu(torch.bmm(xg, wg)) * torch.bmm(xg, wu)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.bmm(xg, wu), approximate="tanh")
    y = torch.bmm(h, wd)
    y = y * gate[..., None].to(y.dtype)
    out = torch.zeros((t, d), dtype=y.dtype, device=y.device)
    return out.index_add(0, flat_ids, y.reshape(-1, d))


def moe_forward(params, x: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux loss, a float32 scalar)."""
    cd = x.dtype
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k

    logits = torch.matmul(x.float(), params["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    wts, idx = top_k(probs, k)                                # [B, S, K]
    wts = wts / wts.sum(-1, keepdim=True).clamp(min=1e-9)

    # Switch aux losses
    me = probs.mean(dim=(0, 1))                               # [E]
    ce_frac = F.one_hot(idx, e).float().sum(2).mean(dim=(0, 1))
    aux = cfg.moe.router_aux_weight * e * (me * ce_frac).sum()
    zloss = cfg.moe.router_z_weight * torch.logsumexp(
        logits, dim=-1).square().mean()
    aux = aux + zloss

    x_flat = x.reshape(b * s, d)
    y = _expert_ffn(x_flat, idx.reshape(b * s, k),
                    wts.reshape(b * s, k).to(cd),
                    params["wg"].to(cd), params["wu"].to(cd),
                    params["wd"].to(cd), _capacity(b * s, cfg),
                    cfg.mlp_variant)
    return y.reshape(b, s, d), aux
