"""Model building blocks: norms, RoPE, MLPs, embeddings, as the JAX
package's ``models/layers.py`` computes them.

Conventions
-----------
* Parameters are plain tensors in nested dicts, in the JAX package's
  layout: a dense weight is ``[in, *out]`` (the attention output
  projection ``[heads, head_dim, d_model]``), so carrying weights across
  is a copy. ``models/transformer.py`` keeps them as the parameters of
  its modules and hands these functions the nested dicts.
* Parameters are stored in ``param_dtype`` (fp32); compute casts to
  ``compute_dtype`` (bf16) at use sites.
* Activation tensors are ``[batch, seq, d_model]``.

Under a mesh of more than one rank (the ambient ``ShardCtx``), each
function takes this rank's shard of its parameters, their FSDP dims
already gathered over ``data`` (``Model._split``), and moves the
activations itself where the JAX package's ``shd.constrain`` lets GSPMD
move them: the MLP is column-parallel (``gate``/``up``) then
row-parallel (``down``, summed over ``model``, its bias added once after
the sum); the embedding is vocab-parallel (a masked lookup of this
shard's rows, summed over ``model``); the unembedding keeps this shard's
logits, the pad mask applied to its own columns. Without a mesh nothing
of this runs.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import pad_vocab
from repro_torch.obs import lm


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def param_as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A stored parameter (or the rows of one that a call takes) in
    ``dtype``; the bytes converted count as ``cast_bytes`` while the LM
    tracer is on."""
    if t.dtype != dtype and lm.TRACER.sample_rate > 0.0:
        lm.count("cast_bytes", t.numel() * t.element_size())
    return t.to(dtype)


def dense_init(generator: torch.Generator, in_dims: Tuple[int, ...],
               out_dims: Tuple[int, ...], dtype: torch.dtype, device,
               use_bias: bool = False) -> Dict[str, torch.Tensor]:
    """Dense weight [*in_dims, *out_dims] with fan-in normal init (the JAX
    package's ``dense_init``, whose one multi-dim input is the attention
    output's [heads, head_dim]), and a zero bias [*out_dims]."""
    w = torch.randn((*in_dims, *out_dims), generator=generator,
                    dtype=dtype, device=device) / math.sqrt(
                        math.prod(in_dims))
    params = {"w": w}
    if use_bias:
        params["b"] = torch.zeros(out_dims, dtype=dtype, device=device)
    return params


def dense_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                compute_dtype: torch.dtype,
                contract_dims: int = 1) -> torch.Tensor:
    """x [..., in] @ w [in, *out] (+ b) in ``compute_dtype``.
    ``contract_dims`` leading w dims are contracted against trailing x
    dims."""
    w = param_as(params["w"], compute_dtype)
    y = torch.tensordot(x.to(compute_dtype), w, dims=contract_dims)
    if "b" in params:
        y = y + param_as(params["b"], compute_dtype)
    return y


def tp(logical: str):
    """(mesh, axis) of a logical axis that a mesh of more than one rank
    splits; (mesh or None, None) where nothing is split."""
    ctx = shd.mesh_ctx()
    if ctx is None:
        return None, None
    return ctx.mesh, ctx.axis(logical)


def row_parallel(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 compute_dtype: torch.dtype, contract_dims: int, mesh,
                 axis) -> torch.Tensor:
    """``dense_apply`` over an input dim split on ``axis``: this shard's
    partial product, summed over ``axis``, then the bias once. The
    partial products of a low-precision compute type are taken and
    summed in float32 and rounded once, as one device's product rounds
    its float32 accumulation once (a bf16 partial would round twice)."""
    if axis is None:
        return dense_apply(params, x, compute_dtype, contract_dims)
    w = param_as(params["w"], compute_dtype)
    y = torch.tensordot(x.to(compute_dtype).float(), w.float(),
                        dims=contract_dims)
    y = col.reduce_from(y, mesh, axis).to(compute_dtype)
    if "b" in params:
        y = y + param_as(params["b"], compute_dtype)
    return y


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype: torch.dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float,
                  compute_dtype: torch.dtype) -> torch.Tensor:
    # normalize in fp32 for stability, return compute dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * param_as(params["scale"], torch.float32)).to(compute_dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] int32. Split-halves form."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)    # [D/2]
    angles = positions[..., None].float() * freqs            # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or 2-matrix GELU)
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    names = ("gate", "up") if cfg.mlp_variant == "swiglu" else ("up",)
    params = {n: dense_init(generator, (d,), (f,), dtype, device,
                            cfg.use_bias) for n in names}
    params["down"] = dense_init(generator, (f,), (d,), dtype, device,
                                cfg.use_bias)
    return params


def mlp_specs(cfg: ModelConfig) -> dict:
    """Logical axes of ``mlp_init``'s parameters, as JAX's ``mlp_init``
    gives them (a bias takes its weight's output axes)."""
    def dense(*logical):
        out = {"w": logical}
        if cfg.use_bias:
            out["b"] = logical[1:]
        return out
    names = ("gate", "up") if cfg.mlp_variant == "swiglu" else ("up",)
    specs = {n: dense(shd.FSDP, shd.MLP) for n in names}
    specs["down"] = dense(shd.MLP, shd.FSDP)
    return specs


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig,
              compute_dtype: torch.dtype) -> torch.Tensor:
    mesh, axis = tp(shd.MLP)
    x = col.copy_to(x, mesh, axis)
    if cfg.mlp_variant == "swiglu":
        g = dense_apply(params["gate"], x, compute_dtype)
        u = dense_apply(params["up"], x, compute_dtype)
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense_apply(params["up"], x, compute_dtype),
                   approximate="tanh")
    h = shd.constrain(h, shd.BATCH, None, shd.MLP, full=(None, None,
                                                         cfg.d_ff))
    return row_parallel(params["down"], h, compute_dtype, 1, mesh, axis)


# ---------------------------------------------------------------------------
# Embedding / unembedding (padded vocabulary)
# ---------------------------------------------------------------------------

def embed_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, device):
    vp = pad_vocab(cfg.vocab_size)
    params = {"table": torch.randn((vp, cfg.d_model), generator=generator,
                                   dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = torch.randn(
            (cfg.d_model, vp), generator=generator, dtype=dtype,
            device=device) / math.sqrt(cfg.d_model)
    return params


def embed_specs(cfg: ModelConfig) -> dict:
    specs = {"table": (shd.VOCAB, shd.FSDP)}
    if not cfg.tie_embeddings:
        specs["unembed"] = (shd.FSDP, shd.VOCAB)
    return specs


#: a norm's scale is replicated
NORM_SPECS = {"scale": (None,)}


def embed_apply(params, tokens: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """tokens [B, S] int -> [B, S, D]: the rows, then the cast (the same
    values as the JAX cast-then-take, without a cast copy of the
    table). Vocab-parallel under a mesh: this shard's rows where the
    token falls in its range, zeros elsewhere, summed over ``model``
    (exact: one shard holds each row)."""
    mesh, axis = tp(shd.VOCAB)
    table = params["table"]
    if axis is None:
        return param_as(table[tokens.long()], compute_dtype)
    rows = table.shape[0]
    local = tokens.long() - mesh.index(axis) * rows
    hit = (local >= 0) & (local < rows)
    emb = table[local.clamp(0, rows - 1)] * hit[..., None].to(table.dtype)
    return param_as(col.reduce_from(emb, mesh, axis), compute_dtype)


def unembed_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x [B, S, D] -> fp32 logits [B, S, V_padded] with pad positions
    masked to a large negative value (so CE over padded vocab is exact).
    The weights are cast to x's type and the product is taken in fp32, as
    the JAX ``dot_general(..., preferred_element_type=float32)``. Under a
    vocab-parallel mesh: this shard's columns of the logits."""
    mesh, axis = tp(shd.VOCAB)
    x = col.copy_to(x, mesh, axis)
    if cfg.tie_embeddings:
        w = param_as(params["table"], x.dtype).T / math.sqrt(cfg.d_model)
    else:
        w = param_as(params["unembed"], x.dtype)
    logits = torch.matmul(x.float(), w.float())
    vp = logits.shape[-1]
    lo = 0 if axis is None else mesh.index(axis) * vp
    if lo + vp > cfg.vocab_size:
        keep = torch.arange(lo, lo + vp,
                            device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits,
                             torch.full((), -1e30, device=logits.device))
    return logits


def nest(flat: Dict[str, Any], sep: str = ".") -> Dict[str, Any]:
    """{"attn.q.w": t} -> {"attn": {"q": {"w": t}}}."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        node = out
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out
