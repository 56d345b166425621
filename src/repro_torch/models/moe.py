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
kernel in the JAX package. The scatter-add sums up to ``top_k``
contributions per token; on the card ``index_add_`` adds them by atomics
in no fixed order, so in bf16 the output differs from the CPU's by
rounding.

The expert-parallel branch (JAX's ``shard_map``, under a mesh of more than
one rank with ``expert_tp``): the experts are sharded over ``model`` while
the tokens stay this data shard's (replicated over ``model``). Routing
runs on every rank alike; each rank's local experts take their top-C
among the data shard's tokens, with C from the *local* token count
(``b / n_batch * s``, JAX's ``t_loc``), and the partial outputs are
summed over ``model`` (``reduce_from``, the ``psum``); the tokens and
their routing weights enter the local experts through ``copy_to``, so
that their gradient sums every rank's experts. The aux loss uses the
*global* means: the router's mean probability, the routed fraction and
the z-loss's mean are sums over the data shards (``reduce_from`` over the
batch axes) over the global token count, as the JAX program computes
them on the global batch.

Under a mesh without ``expert_tp`` (the experts do not divide ``model``)
every rank runs every expert, its weights replicated over ``model``, on
the *global* tokens, as JAX's local branch runs on the global batch: the
data shard's tokens, expert choices and routing weights are gathered
over the batch axes (``collectives.gather``, whose backward
reduce-scatters), the capacity is ``_capacity`` of the global token
count, each expert takes its top-C among every token of the batch, and
the shard keeps its own rows of the output, so that the gradient reaches
only its own tokens.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
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
                capacity: int, variant: str,
                e_offset: int = 0) -> torch.Tensor:
    """x_flat [T, D]; idx/wts [T, K]; wg/wu/wd [E_loc, ...], experts
    ``e_offset`` .. ``e_offset + E_loc - 1``. Each expert's affinity for
    each token (its routing weight, else 0), its top ``capacity`` tokens
    gathered through the FFN, gated and scatter-added. Returns [T, D] in
    the compute type: the local experts' share of the output."""
    e = wg.shape[0]
    t, d = x_flat.shape
    eids = e_offset + torch.arange(e, dtype=idx.dtype, device=idx.device)
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

    ctx = shd.mesh_ctx()
    x_flat = x.reshape(b * s, d)
    idx_flat = idx.reshape(b * s, k)
    wts_flat = wts.reshape(b * s, k).to(cd)
    if ctx is None:
        # Switch aux losses
        me = probs.mean(dim=(0, 1))                           # [E]
        ce_frac = F.one_hot(idx, e).float().sum(2).mean(dim=(0, 1))
        aux = cfg.moe.router_aux_weight * e * (me * ce_frac).sum()
        zloss = cfg.moe.router_z_weight * torch.logsumexp(
            logits, dim=-1).square().mean()
        aux = aux + zloss
        y = _expert_ffn(x_flat, idx_flat, wts_flat,
                        params["wg"].to(cd), params["wu"].to(cd),
                        params["wd"].to(cd), _capacity(b * s, cfg),
                        cfg.mlp_variant)
        return y.reshape(b, s, d), aux

    mesh, batch_axes = ctx.mesh, ctx.profile.batch_axes
    # the global means: sums over the data shards over the global count
    t_all = b * s * ctx.shards(batch_axes)
    me = col.reduce_from(probs.sum(dim=(0, 1)), mesh, batch_axes) / t_all
    ce_frac = col.all_reduce(F.one_hot(idx, e).float().sum(dim=(0, 1, 2)),
                             mesh, batch_axes) / t_all
    aux = cfg.moe.router_aux_weight * e * (me * ce_frac).sum()
    lse2 = torch.logsumexp(logits, dim=-1).square().sum()
    zloss = cfg.moe.router_z_weight * col.reduce_from(
        lse2, mesh, batch_axes) / t_all
    aux = aux + zloss

    if not ctx.profile.expert_tp:
        # every expert on every rank, each taking its top-C among the
        # global tokens; this shard keeps its own rows
        y = _expert_ffn(col.gather(x_flat, mesh, batch_axes, 0),
                        col.gather(idx_flat, mesh, batch_axes, 0),
                        col.gather(wts_flat, mesh, batch_axes, 0),
                        params["wg"].to(cd), params["wu"].to(cd),
                        params["wd"].to(cd), _capacity(t_all, cfg),
                        cfg.mlp_variant)
        rows = shd.shard_slices(y.shape, (batch_axes or None,), mesh)[0]
        return y[rows].reshape(b, s, d), aux

    axis = ctx.axis(shd.EXPERTS)
    wg = params["wg"]
    e_off = 0 if axis is None else mesh.index(axis) * wg.shape[0]
    shd.constrain(wg, shd.EXPERTS, None, None, full=(e, None, None))
    y = _expert_ffn(col.copy_to(x_flat, mesh, axis), idx_flat,
                    col.copy_to(wts_flat, mesh, axis), wg.to(cd),
                    params["wu"].to(cd), params["wd"].to(cd),
                    _capacity(b * s, cfg), cfg.mlp_variant, e_offset=e_off)
    y = _combine(y, mesh, axis)
    return y.reshape(b, s, d), aux


def _combine(y: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The local experts' partial outputs summed over ``model`` (JAX's
    ``psum``)."""
    return col.reduce_from(y, mesh, axis)


def moe_specs(cfg: ModelConfig) -> Dict[str, object]:
    """Logical axes of ``moe_init``'s parameters, as JAX's ``moe_init``
    gives them."""
    return {"router": {"w": (shd.FSDP, None)},
            "wg": (shd.EXPERTS, shd.FSDP, None),
            "wu": (shd.EXPERTS, shd.FSDP, None),
            "wd": (shd.EXPERTS, None, shd.FSDP)}
