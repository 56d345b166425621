"""Paged decode attention over a tiered KV pool (K4): a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

This is the kernel-level realization of Aion's m-bucket for serving: a
long-lived session's KV cache is block-granular (pages); resident pages
live in the device pool this kernel reads, cold pages live on the host
(``serve/kvcache.py`` stages them in before a session's decode). The
kernel consumes a block table and dereferences it on the device, so pages
are gathered without a copy.

``decode_attention_paged_cuda`` launches ``decode_attention_paged``
(``csrc/attention.cu``) for a CUDA tensor and takes the plain version only
for a tensor on the CPU. Masking follows the JAX package's
``ref_decode_attention_paged``: a -1 page inside ``seq_len`` and every
position past it contribute nothing, and a row with nothing to attend to
is NaN. (The JAX Pallas wrapper clamps the table to ``>= 0`` and so reads
a -1 page as page 0.) The wrapper counts its launches in
``decode_attention_paged_cuda.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import ref_decode_attention_paged

#: float types the kernels of ``csrc/attention.cu`` take (code passed to
#: the C entry points)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims those kernels are instantiated for
HEAD_DIMS = (32, 64, 128, 256)


def decode_attention_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 seq_lens: torch.Tensor) -> torch.Tensor:
    """K4's function in plain torch: the oracle's gather, mask and softmax
    in fp32. q [B, H, D]; k/v_pages [P, page, Hkv, D]; block_table
    [B, pages_per_seq]; seq_lens [B] -> [B, H, D] in q's dtype."""
    return ref_decode_attention_paged(q, k_pages, v_pages, block_table,
                                      seq_lens)


def _check(q, k_pages, v_pages, block_table, seq_lens):
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError("q, k_pages and v_pages must share one type of "
                         f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("q must be [B, H, D] and k/v_pages one "
                         f"[P, page, Hkv, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, h, d = q.shape
    _, page, hkv, dk = k_pages.shape
    if dk != d or d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} (pages {dk}) must match and be one "
                         f"of {HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or block_table.shape[1] == 0 or tuple(seq_lens.shape) != (b,):
        raise ValueError("block_table must be [B, pages_per_seq] and "
                         f"seq_lens [B] for B={b}, got "
                         f"{tuple(block_table.shape)}, "
                         f"{tuple(seq_lens.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_table", block_table), ("seq_lens", seq_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")


def decode_attention_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_table: torch.Tensor,
                                seq_lens: torch.Tensor) -> torch.Tensor:
    """K4: paged decode attention. q [B, H, D] (float32 or bfloat16, as
    the pages), k/v_pages [P, page, Hkv, D] contiguous, block_table
    [B, pages_per_seq] (page id, -1 = not resident), seq_lens [B] ->
    [B, H, D] in q's dtype, on the current stream. A CPU tensor takes
    ``decode_attention_paged_plain``."""
    if not q.is_cuda:
        return decode_attention_paged_plain(q, k_pages, v_pages,
                                            block_table, seq_lens)
    _check(q, k_pages, v_pages, block_table, seq_lens)
    b, h, d = q.shape
    p, page, hkv, _ = k_pages.shape
    table = block_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    from repro_torch.kernels._build import library
    library("attention.cu").call(
        "decode_attention_paged", q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, h, hkv, d, p, page, table.shape[1],
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    decode_attention_paged_cuda.launches += 1
    return out


decode_attention_paged_cuda.launches = 0
