"""The yardstick's arithmetic: each timed op's operations and bytes, each
configuration's model FLOPs, and the card's peaks.

Every count is of the work the inputs need, whatever implements it:

* attention counts the (query, key) pairs the mask keeps: the causal half
  (``S (S + 1) / 2`` pairs a head), and under a window of ``w`` keys
  (key ``j`` kept for query ``i`` when ``0 <= i - j < w``) ``w`` pairs a
  query once the window is full; no recompute of a checkpointed layer;
* bytes count each input read once and each output written once.

A roofline share is the least time (the larger of operations over the
peak rate and bytes over the peak bandwidth) over the measured time.
"""
from __future__ import annotations

from typing import Dict

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAKS = {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes": 3.35e12}


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes"])


def attention_pairs(s_q: int, s_k: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head attends: query i (at position i, keys
    from position 0) keeps key j when j <= i (causal) and i - j < window
    (window > 0)."""
    if not causal:
        return s_q * s_k
    total = 0
    # keys kept by query i: min(i + 1, s_k, window or inf)
    full = min(s_q, s_k)
    w = window if window > 0 else full
    w = min(w, full)
    # queries 0..w-1 keep i + 1 keys; the rest keep w (capped by s_k)
    total += w * (w + 1) // 2
    total += (s_q - w) * w
    return total


def flash_fwd(b: int, s: int, h: int, hkv: int, d: int, *, causal: bool,
              window: int, lse: bool, itemsize: int = 2) -> Dict[str, float]:
    """K5: q [b, s, h, d] against k, v [b, s, hkv, d] -> o [b, s, h, d]
    (and the float32 log-sum-exp [b h, s] where a backward needs it)."""
    pairs = attention_pairs(s, s, causal, window)
    flops = 4.0 * d * pairs * b * h                    # QK^T and PV
    nbytes = itemsize * b * s * d * (2 * h + 2 * hkv)  # q, k, v in, o out
    if lse:
        nbytes += 4 * b * h * s
    return {"flops": flops, "bytes": float(nbytes)}


def flash_bwd(b: int, s: int, h: int, hkv: int, d: int, *, causal: bool,
              window: int, itemsize: int = 2) -> Dict[str, float]:
    """K6: from q, k, v, o, dO and the log-sum-exp to dq, dk, dv: five
    products a kept pair (the scores again, dP, dV, dQ, dK)."""
    pairs = attention_pairs(s, s, causal, window)
    flops = 10.0 * d * pairs * b * h
    nbytes = itemsize * b * s * d * (3 * h + 2 * hkv)  # q, o, dO; k, v
    nbytes += 4 * b * h * s                            # lse
    nbytes += itemsize * b * s * d * (h + 2 * hkv)     # dq; dk, dv
    return {"flops": flops, "bytes": float(nbytes)}


# ------------------------------------------------------------ model FLOPs
def matmul_params(cfg: dict) -> int:
    """Weights a token passes through in matrix products: every layer's
    projections and the unembedding over the real vocabulary (the
    embedding is a lookup, and counts none)."""
    d, hd = cfg["d_model"], cfg["head_dim"] or cfg["d_model"] // cfg[
        "num_heads"]
    per_layer = 0
    if cfg["num_heads"]:
        per_layer += d * hd * (2 * cfg["num_heads"] + 2 * cfg["num_kv_heads"])
    mats = 3 if cfg["mlp_variant"] == "swiglu" else 2
    per_layer += mats * d * cfg["d_ff"]
    return cfg["num_layers"] * per_layer + d * cfg["vocab_size"]


def _mixer_flops(cfg: dict, keys: float) -> float:
    """Attention's non-weight operations for one token that attends
    ``keys`` keys, over the layers."""
    per_layer = 0.0
    if cfg["num_heads"]:
        hd = cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]
        per_layer += 4.0 * hd * cfg["num_heads"] * keys
    return cfg["num_layers"] * per_layer


def forward_flops(cfg: dict, seq_len: int) -> float:
    """Model FLOPs of one forward over a whole sequence of ``seq_len``
    tokens (causal, under the configuration's window)."""
    w = cfg.get("attn_window", 0)
    pairs = attention_pairs(seq_len, seq_len, True, w)
    return 2.0 * matmul_params(cfg) * seq_len + _mixer_flops(cfg, pairs)


def train_flops(cfg: dict, seq_len: int) -> float:
    """A training step's model FLOPs for one sequence: the forward and a
    backward of twice its work, no recompute."""
    return 3.0 * forward_flops(cfg, seq_len)


def prefill_flops(cfg: dict, seq_len: int) -> float:
    """Model FLOPs of a prefill that yields the first token: every layer
    over the prompt, the unembedding at its last position only."""
    unembed = cfg["d_model"] * cfg["vocab_size"]
    w = cfg.get("attn_window", 0)
    pairs = attention_pairs(seq_len, seq_len, True, w)
    return 2.0 * (matmul_params(cfg) - unembed) * seq_len + 2.0 * unembed \
        + _mixer_flops(cfg, pairs)
