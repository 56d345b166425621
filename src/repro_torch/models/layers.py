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

The JAX package's sharding constraints (``shd.constrain``) have no
counterpart on one card and are dropped; ``pad_vocab`` is copied from its
``distributed/sharding.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


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
    w = params["w"].to(compute_dtype)
    y = torch.tensordot(x.to(compute_dtype), w, dims=contract_dims)
    if "b" in params:
        y = y + params["b"].to(compute_dtype)
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
    return (y * params["scale"].float()).to(compute_dtype)


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


def mlp_apply(params, x: torch.Tensor, cfg: ModelConfig,
              compute_dtype: torch.dtype) -> torch.Tensor:
    if cfg.mlp_variant == "swiglu":
        g = dense_apply(params["gate"], x, compute_dtype)
        u = dense_apply(params["up"], x, compute_dtype)
        h = F.silu(g) * u
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense_apply(params["up"], x, compute_dtype),
                   approximate="tanh")
    return dense_apply(params["down"], h, compute_dtype)


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


def embed_apply(params, tokens: torch.Tensor,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """tokens [B, S] int -> [B, S, D]: the rows, then the cast (the same
    values as the JAX cast-then-take, without a cast copy of the
    table)."""
    return params["table"][tokens.long()].to(compute_dtype)


def unembed_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x [B, S, D] -> fp32 logits [B, S, V_padded] with pad positions
    masked to a large negative value (so CE over padded vocab is exact).
    The weights are cast to x's type and the product is taken in fp32, as
    the JAX ``dot_general(..., preferred_element_type=float32)``."""
    if cfg.tie_embeddings:
        w = params["table"].to(x.dtype).T / math.sqrt(cfg.d_model)
    else:
        w = params["unembed"].to(x.dtype)
    logits = torch.matmul(x.float(), w.float())
    vp = logits.shape[-1]
    if vp - cfg.vocab_size:
        keep = torch.arange(vp, device=logits.device) < cfg.vocab_size
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
