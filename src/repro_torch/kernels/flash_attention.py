"""Flash attention, forward (K5): hand-written CUDA kernels for Hopper and
their plain PyTorch version. Attention for the prefill path.

``flash_attention_cuda`` launches a kernel for a CUDA tensor and takes the
plain version only for a tensor on the CPU. The kernel's design comes from
the table of ``kernels/flash_tiles.py``: bf16 at head dims 64 and 128 runs
``flash_fwd_wgmma`` (``csrc/flash_fwd_hopper.cu``: wgmma tensor cores fed
by TMA, P rounded to bf16 before P.V as the Pallas kernel rounds it),
everything else ``flash_attention_fwd`` (``csrc/attention.cu``: fp32 on
the CUDA cores). Layouts are the JAX package's: q [B, Sq, H, D],
k/v [B, Sk, Hkv, D] (GQA: H a multiple of Hkv), o [B, Sq, H, D] in q's
dtype, and the optional log-sum-exp [B*H, Sq] float32 flattened in
(b, hkv, g) order, the layout the backward reads. The causal mask counts
q and k positions from 0 (so Sq != Sk works as in JAX); ``window > 0``
keeps keys with ``q - k < window``. ``kv_valid_len`` [B] int32 keeps
the keys ``j < kv_valid_len[b]`` of row b as well (the padding mask of
the JAX package's ``blocked_attention``): both kernels end a row's key
loop at its length, so the key tiles past it are skipped, not masked;
the lengths are clamped in the kernel to [0, Sk], and a row left with no
key is NaN with an lse of -inf.

Both paths go through one ``torch.autograd.Function``, differentiable in
q, k and v: its forward is K5 (keeping the log-sum-exp whenever a gradient
may be asked for) and its backward the flash backward, K6
(``kernels/flash_attention_bwd.py``), on the tensors' device: the CUDA
kernels for CUDA tensors, the plain versions for CPU tensors, or the plain
versions on any device where the caller asks for them (``plain``). The
wrapper counts its launches in ``flash_attention_cuda.launches``, and by
design in ``flash_attention_cuda.launches_by_design``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_tiles
# one source holds K4 and K5, instantiated for the same types and head dims
from repro_torch.kernels.decode_attention import DTYPES, HEAD_DIMS
from repro_torch.kernels.flash_attention_bwd import (
    _ptr, check_lengths, flash_attention_bwd_cuda, flash_attention_bwd_plain,
)
from repro_torch.kernels.ref import ref_flash_attention


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          return_lse: bool = False,
                          kv_valid_len: torch.Tensor | None = None):
    """K5's function in plain torch: the oracle's materialized softmax in
    fp32 (one KV head's group at a time), with its log-sum-exp."""
    return ref_flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=return_lse,
                               kv_valid_len=kv_valid_len)


def _check(q, k, v):
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one type of "
                         f"{sorted(map(str, DTYPES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be [B, Sq, H, D] and k, v one "
                         f"[B, Sk, Hkv, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    bk, sk, hkv, dk = k.shape
    if bk != b or dk != d or d not in HEAD_DIMS:
        raise ValueError(f"batch {b}/{bk} and head dim {d}/{dk} must match, "
                         f"and the head dim be one of {HEAD_DIMS}")
    if hkv == 0 or h % hkv or sk == 0:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}, and "
                         f"Sk={sk} positive")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the grid's 65,535 rows")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def _launch(q, k, v, causal: bool, window: int, return_lse: bool,
            design: str | None, kv_valid_len=None):
    _check(q, k, v)
    check_lengths(kv_valid_len, q.shape[0], q.device)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    design = flash_tiles.design(q.dtype, d, design)
    o = torch.empty_like(q)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if sq == 0 or b == 0:
        return o, lse
    from repro_torch.kernels._build import library
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse_ptr = None if lse is None else lse.data_ptr()
    if design == "wgmma":
        flash_tiles.check_tma(q=q, k=k, v=v)
        sched = flash_tiles.schedule_tensor(sq, sk, bool(causal), int(window),
                                            *flash_tiles.FWD_TILES, False,
                                            q.device)
        library("flash_fwd_hopper.cu").call(
            "flash_fwd_wgmma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse_ptr, _ptr(kv_valid_len), sched.data_ptr(),
            sched.shape[0], b, sq, sk, h, hkv, d, int(bool(causal)),
            int(window), stream)
    else:
        library("attention.cu").call(
            "flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse_ptr, _ptr(kv_valid_len), b, sq, sk, h, hkv, d,
            int(bool(causal)), int(window), DTYPES[q.dtype], stream)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_design[design] += 1
    return o, lse


class _FlashForward(torch.autograd.Function):
    """K5 forward, K6 backward. It saves q, k, v, o, lse and the key
    lengths for the backward; with ``plain`` both passes take the plain
    versions, on whatever device the tensors are. The lengths (the last
    argument, or None) get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, return_lse, plain, design,
                kv_valid_len=None):
        want_lse = return_lse or any(ctx.needs_input_grad[:3])
        if q.is_cuda and not plain:
            o, lse = _launch(q, k, v, causal, window, want_lse, design,
                             kv_valid_len)
        else:
            out = flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=want_lse,
                                        kv_valid_len=kv_valid_len)
            o, lse = out if want_lse else (out, None)
        ctx.causal, ctx.window, ctx.plain = causal, window, plain
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, o, lse, kv_valid_len)
        if not return_lse:
            return o, None
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, kv_valid_len = ctx.saved_tensors
        fn = flash_attention_bwd_plain if ctx.plain \
            else flash_attention_bwd_cuda
        dq, dk, dv = fn(q, k, v, o, do.contiguous(), lse, causal=ctx.causal,
                        window=ctx.window, kv_valid_len=kv_valid_len)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False,
                         design: str | None = None,
                         kv_valid_len: torch.Tensor | None = None):
    """K5: attention forward. q [B, Sq, H, D], k/v [B, Sk, Hkv, D]
    contiguous, float32 or bfloat16 -> o [B, Sq, H, D] in q's dtype (and
    lse [B*H, Sq] float32 with ``return_lse``), on the current stream. A
    CPU tensor takes ``flash_attention_plain``. A row with nothing to
    attend to is NaN (its lse -inf). ``kv_valid_len``: int32 [B] on the
    inputs' device, each row's count of valid keys (None: Sk).
    Differentiable in q, k and v through K6
    (``flash_attention_bwd_cuda``). ``design`` None takes the design of
    ``flash_tiles``' table; a name forces that design (for measurements)
    and raises where it does not take the inputs."""
    o, lse = _FlashForward.apply(q, k, v, bool(causal), int(window),
                                 bool(return_lse), False, design,
                                 kv_valid_len)
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_design = dict.fromkeys(flash_tiles.DESIGNS,
                                                        0)
