"""The dense family's layer (starcoder2-7b), plain float32 PyTorch:
pre-norm grouped-query attention with RoPE, then the MLP (two matrices
with the tanh GELU, or SwiGLU's three), each added to the residual, with
the biases the configuration keeps."""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from bench.reference.common import (Precision, attention, linear, rmsnorm,
                                    rope)
from bench.weights import Leaf, head_dim, projection


def attn_leaves(cfg: dict) -> List[Leaf]:
    d, bias = cfg["d_model"], cfg["use_bias"]
    h, hkv, dh = cfg["num_heads"], cfg["num_kv_heads"], head_dim(cfg)
    return (projection("attn.q", (d,), (h, dh), bias)
            + projection("attn.k", (d,), (hkv, dh), bias)
            + projection("attn.v", (d,), (hkv, dh), bias)
            + projection("attn.o", (h, dh), (d,), bias))


def mlp_leaves(cfg: dict) -> List[Leaf]:
    d, f, bias = cfg["d_model"], cfg["d_ff"], cfg["use_bias"]
    out: List[Leaf] = [("ln2.scale", (d,), ("one", 0.05))]
    if cfg["mlp_variant"] == "swiglu":
        out += projection("mlp.gate", (d,), (f,), bias)
    return (out + projection("mlp.up", (d,), (f,), bias)
            + projection("mlp.down", (f,), (d,), bias))


def leaves(cfg: dict) -> List[Leaf]:
    """One layer's parameters, in the order they are drawn."""
    return ([("ln1.scale", (cfg["d_model"],), ("one", 0.05))]
            + attn_leaves(cfg) + mlp_leaves(cfg))


def attn_branch(cfg: dict, p: dict, h: torch.Tensor,
                positions: torch.Tensor, rnd: Precision) -> torch.Tensor:
    q = rope(linear(h, p["q"], rnd), positions, cfg["rope_theta"])
    k = rope(linear(h, p["k"], rnd), positions, cfg["rope_theta"])
    v = linear(h, p["v"], rnd)
    o = attention(q, k, v, cfg.get("attn_window", 0), rnd)
    return linear(o, p["o"], rnd, contract=2)


def mlp(cfg: dict, p: dict, h: torch.Tensor, rnd: Precision) -> torch.Tensor:
    if cfg["mlp_variant"] == "swiglu":
        u = F.silu(linear(h, p["gate"], rnd)) * linear(h, p["up"], rnd)
    else:
        u = F.gelu(linear(h, p["up"], rnd), approximate="tanh")
    return linear(u, p["down"], rnd)


def layer(cfg: dict, p: dict, x: torch.Tensor, positions: torch.Tensor,
          rnd: Precision) -> torch.Tensor:
    h = rmsnorm(x, p["ln1"]["scale"], cfg["norm_eps"])
    x = x + attn_branch(cfg, p["attn"], h, positions, rnd)
    h = rmsnorm(x, p["ln2"]["scale"], cfg["norm_eps"])
    return x + mlp(cfg, p["mlp"], h, rnd)
