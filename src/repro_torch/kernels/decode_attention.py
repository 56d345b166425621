"""Paged decode attention over a tiered KV pool (K4): a hand-written CUDA
kernel for Hopper and its plain PyTorch version.

This is the kernel-level realization of Aion's m-bucket for serving: a
long-lived session's KV cache is block-granular (pages); resident pages
live in the device pool this kernel reads, cold pages live on the host
(``serve/kvcache.py`` stages them in before a session's decode). The
kernel consumes a block table and dereferences it on the device, so pages
are gathered without a copy.

``decode_attention_paged_cuda`` launches a kernel for a CUDA tensor and
takes the plain version only for a tensor on the CPU. The kernel's design
comes from this table (``decode_design``), never from a failure:

    ==========  ==========  ======  =============  ========================
    dtype       head dim    G       design         source
    ==========  ==========  ======  =============  ========================
    bfloat16    64, 128     <= 16   ``split_kv``   ``csrc/decode_hopper.cu``
    bfloat16    64, 128     > 16    ``cuda_core``  ``csrc/attention.cu``
    bfloat16    32, 256     any     ``cuda_core``  ``csrc/attention.cu``
    float32     any         any     ``cuda_core``  ``csrc/attention.cu``
    ==========  ==========  ======  =============  ========================

(G = H / Hkv, the query heads of one KV head.) ``split_kv`` splits each
sequence's pages into runs of ``split_plan``'s length across blocks
(flash-decoding), stages K and V through a shared-memory ring and scores
on the tensor cores; a second launch combines the splits in order.
``cuda_core`` is the fp32 CUDA-core design of PR 12, one block per
(KV head, batch row). Masking follows the JAX package's
``ref_decode_attention_paged``: a -1 page inside ``seq_len``, a page
outside [0, P) and every position past ``seq_len`` contribute nothing,
and a row with nothing to attend to is NaN. (The JAX Pallas wrapper
clamps the table to ``>= 0`` and so reads a -1 page as page 0.) The
wrapper counts its launches in ``decode_attention_paged_cuda.launches``,
and by design in ``decode_attention_paged_cuda.launches_by_design``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import ref_decode_attention_paged

#: float types the kernels of ``csrc/attention.cu`` take (code passed to
#: the C entry points)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims those kernels are instantiated for
HEAD_DIMS = (32, 64, 128, 256)

DESIGNS = ("split_kv", "cuda_core")
#: what ``split_kv`` takes: bf16 at these head dims, at most MAX_GROUP
#: query heads per KV head (the 16 rows of one tensor-core tile)
SPLIT_HEAD_DIMS = (64, 128)
MAX_GROUP = 16
#: tokens of one split: 32 pages of 16, so a [16, 520] table of 4 KV heads
#: gives 17 x 64 = 1,088 blocks for the 132 SMs
SPLIT_TOKENS = 512


def decode_design(dtype: torch.dtype, head_dim: int, group: int,
                  forced: str | None = None) -> str:
    """The design the table gives (dtype, head_dim, G), or ``forced`` (a
    measurement's choice), which must take these inputs."""
    table = "split_kv" if dtype == torch.bfloat16 \
        and head_dim in SPLIT_HEAD_DIMS and group <= MAX_GROUP \
        else "cuda_core"
    if forced is None:
        return table
    if forced not in DESIGNS:
        raise ValueError(f"design {forced!r} is none of {DESIGNS}")
    if forced == "split_kv" and table != "split_kv":
        raise ValueError(f"the split_kv design takes bfloat16 at head dims "
                         f"{SPLIT_HEAD_DIMS} with G <= {MAX_GROUP}, got "
                         f"{dtype} at {head_dim}, G={group}")
    return forced


def split_plan(page: int, pages_per_seq: int,
               pages_per_split: int | None = None) -> tuple:
    """(pages per split, number of splits) of a ``split_kv`` launch: runs
    of SPLIT_TOKENS // page pages (at least one), or ``pages_per_split``
    (a measurement's choice), over the table's width. The lengths are not
    read: the count is fixed by the table's shape, so the host never waits
    for the device."""
    per = max(1, SPLIT_TOKENS // page) if pages_per_split is None \
        else int(pages_per_split)
    if per < 1:
        raise ValueError(f"pages_per_split must be >= 1, got {per}")
    return per, -(-pages_per_seq // per)


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
                                seq_lens: torch.Tensor, *,
                                design: str | None = None,
                                pages_per_split: int | None = None
                                ) -> torch.Tensor:
    """K4: paged decode attention. q [B, H, D] (float32 or bfloat16, as
    the pages), k/v_pages [P, page, Hkv, D] contiguous, block_table
    [B, pages_per_seq] (page id, -1 = not resident), seq_lens [B] ->
    [B, H, D] in q's dtype, on the current stream. A CPU tensor takes
    ``decode_attention_paged_plain``. ``design`` None takes the design of
    the table; a name forces that design, and ``pages_per_split`` the
    length of ``split_kv``'s runs (both for measurements; they raise where
    they do not take the inputs)."""
    if not q.is_cuda:
        return decode_attention_paged_plain(q, k_pages, v_pages,
                                            block_table, seq_lens)
    _check(q, k_pages, v_pages, block_table, seq_lens)
    b, h, d = q.shape
    p, page, hkv, _ = k_pages.shape
    chosen = decode_design(q.dtype, d, h // hkv, design)
    if pages_per_split is not None and chosen != "split_kv":
        raise ValueError("pages_per_split applies to the split_kv design")
    table = block_table if block_table.dtype == torch.int32 \
        and block_table.is_contiguous() \
        else block_table.to(torch.int32).contiguous()
    lens = seq_lens if seq_lens.dtype == torch.int32 \
        and seq_lens.is_contiguous() \
        else seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    from repro_torch.kernels._build import library
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if chosen == "split_kv":
        per, n_split = split_plan(page, table.shape[1], pages_per_split)
        scratch = torch.empty(b * hkv * n_split * (h // hkv) * (d + 2),
                              dtype=torch.float32, device=q.device)
        library("decode_hopper.cu").call(
            "decode_split_kv", q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), lens.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), b, h, hkv, d, p, page,
            table.shape[1], per, n_split, stream)
    else:
        library("attention.cu").call(
            "decode_attention_paged", q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, h, hkv, d, p, page, table.shape[1],
            DTYPES[q.dtype], stream)
    decode_attention_paged_cuda.launches += 1
    decode_attention_paged_cuda.launches_by_design[chosen] += 1
    return out


decode_attention_paged_cuda.launches = 0
decode_attention_paged_cuda.launches_by_design = dict.fromkeys(DESIGNS, 0)
