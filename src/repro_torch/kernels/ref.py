"""Plain-torch oracles for the attention kernels (the correctness contract
the plain versions and the CUDA kernels are held against), with fp32
math, as ``repro/kernels/ref.py`` computes them.

The oracle of the segment-aggregate folds is the ``*_plain`` family of
``kernels/segment_aggregate.py``: ``backend="ref"`` and every CPU tensor
take it, and the CUDA kernels K1-K3 are held against it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


def _mask(sq: int, sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """[Sq, Sk] attendable positions; q and k both count from 0."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q [B, Sq, H, D]; k, v [B, Sk, Hkv, D] -> [B, Sq, H, D] in q's dtype.
    Plain materialized softmax attention (fp32 math; float64 for float64
    inputs, so that ``torch.autograd.gradcheck`` can hold a backward
    against it), one KV head's group at a time so that the [G, Sq, Sk]
    scores of one group are the largest temporary. A row with nothing to
    attend to is NaN.

    ``return_lse`` also returns the log-sum-exp of each row's scaled,
    masked scores, [B*H, Sq] float32 (float64 for float64 inputs) in
    (b, hkv, g) order: the layout the kernel writes for its backward."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    g = h // hkv
    wide = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(wide).reshape(b, sq, hkv, g, d)
    kf = k.to(wide)
    vf = v.to(wide)
    mask = _mask(sq, sk, causal, window, q.device)
    o = torch.empty((b, sq, hkv, g, d), dtype=wide, device=q.device)
    lse = torch.empty((b, hkv, g, sq), dtype=wide, device=q.device)
    for j in range(hkv):
        s = torch.einsum("bqgd,bkd->bgqk", qf[:, :, j], kf[:, :, j]) \
            / math.sqrt(d)
        s = s.masked_fill(~mask, NEG_INF)
        lse[:, j] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1)
        o[:, :, j] = torch.einsum("bgqk,bkd->bqgd", p, vf[:, :, j])
    out = o.reshape(b, sq, h, d).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b * h, sq)
    return out


def ref_decode_attention_paged(q: torch.Tensor, kv_pages_k: torch.Tensor,
                               kv_pages_v: torch.Tensor,
                               block_table: torch.Tensor,
                               seq_lens: torch.Tensor) -> torch.Tensor:
    """Paged decode attention oracle.

    q            [B, H, D]
    kv_pages_*   [P, page, Hkv, D]   (global page pool)
    block_table  [B, pages_per_seq] i32 (page ids; -1 = unused)
    seq_lens     [B] i32 (valid tokens per sequence)
    -> [B, H, D] in q's dtype

    A -1 page and every position >= seq_len are masked with -inf, so a row
    with nothing to attend to (seq_len 0) is NaN.
    """
    b, h, d = q.shape
    _, page_size, hkv, _ = kv_pages_k.shape
    per_seq = block_table.shape[1]
    g = h // hkv
    dev = q.device
    table = block_table.to(device=dev, dtype=torch.int64)
    lens = seq_lens.to(device=dev, dtype=torch.int64)
    safe = table.clamp(min=0)
    k = kv_pages_k[safe].reshape(b, per_seq * page_size, hkv, d)
    v = kv_pages_v[safe].reshape(b, per_seq * page_size, hkv, d)
    pos = torch.arange(per_seq * page_size, device=dev)
    valid = (pos[None, :] < lens[:, None]) \
        & torch.repeat_interleave(table >= 0, page_size, dim=1)
    qg = q.to(torch.float32).reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.to(torch.float32)) \
        / math.sqrt(d)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.to(torch.float32))
    return o.reshape(b, h, d).to(q.dtype)


def ref_ssd_chunk_scan(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-exact SSD oracle: step the recurrence token by token.

    xdt [b, s, h, p] (x*dt); a [b, s, h] (dt*A); B, C [b, s, n].
    Returns (y [b, s, h, p] in xdt's dtype, final_state [b, h, p, n]
    float32). ``chunk`` is accepted for the JAX signature and not read.
    """
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=xdt.device) if init_state is None \
        else init_state.to(torch.float32)
    ys = []
    for t in range(s):
        decay = torch.exp(a[:, t].float())[:, :, None, None]   # [b,h,1,1]
        upd = torch.einsum("bn,bhp->bhpn", B[:, t].float(),
                           xdt[:, t].float())
        state = decay * state + upd
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t].float(), state))
    y = torch.stack(ys, dim=1) if ys else \
        torch.zeros((b, 0, h, p), dtype=torch.float32, device=xdt.device)
    return y.to(xdt.dtype), state
