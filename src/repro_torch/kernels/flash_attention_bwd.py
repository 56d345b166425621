"""Flash attention, backward (K6): hand-written CUDA kernels for Hopper and
their plain PyTorch version. The gradient of the training path's
attention.

``flash_attention_bwd_cuda`` launches a kernel for a CUDA tensor and takes
the plain version only for a tensor on the CPU. The kernel's design comes
from the table of ``kernels/flash_tiles.py``: bf16 at head dims 64 and 128
runs ``flash_bwd_wgmma`` (``csrc/flash_bwd_hopper.cu``: wgmma tensor
cores fed by TMA, P and dS rounded to bf16 before their products as the
Pallas kernels round them), everything else ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``: fp32 on the CUDA cores). Layouts are
the model's, with GQA
native: q, o, do and dq [B, Sq, H, D]; k, v, dk and dv [B, Sk, Hkv, D]
(H a multiple of Hkv); lse [B*H, Sq] float32 in (b, hkv, g) order, as the
forward (K5) writes it. Masks count q and k positions from 0, as the
forward's.

The JAX wrapper (``repro/kernels/ops.py``, ``_fa_bwd``) repeats K and V
over the group and sums dK and dV per group after rounding each head to
the input type. Here both designs read the shared KV head once and sum
the group in float32 accumulators, rounding once; the CUDA-core design
follows the float32 oracle (autograd through ``ref_flash_attention``),
the wgmma design the Pallas kernels' rounding of P and dS.

A row with nothing to attend to (lse -inf, o NaN: only ``Sq > Sk`` with a
window makes one) gets dq = 0 and adds nothing to dk or dv, in the plain
version and the kernel alike, as in the JAX package (whose forward masks
with -1e30, so its o there is a mean of V). ``kv_valid_len`` [B] int32
masks the keys ``j >= kv_valid_len[b]`` of row b, as the forward does:
their dk and dv are exactly 0 (a dk/dv block of keys wholly past the
length writes its zeros and reads no query tile), and a row with no key
left gets dq = 0. The wrapper counts its
launches in ``flash_attention_bwd_cuda.launches``, and by design in
``flash_attention_bwd_cuda.launches_by_design``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_tiles
from repro_torch.kernels.decode_attention import DTYPES, HEAD_DIMS
from repro_torch.kernels.ref import _mask
from repro_torch.obs import lm


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              kv_valid_len: torch.Tensor | None = None):
    """K6's function in plain torch, one KV head's group at a time (the
    [B, G, Sq, Sk] scores of one group are the largest temporary), in
    float32 (float64 for float64 inputs):

        p  = exp(scale * q.k - lse) under the mask, 0 outside it
        D  = rowsum(do * o)
        ds = p * (do.v - D) under the mask, 0 outside it
        dq = scale * ds.k;  dk = scale * ds^T.q;  dv = p^T.do

    Returns (dq, dk, dv) in q's, k's and v's types."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    wide = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(d)
    qf = q.to(wide).reshape(b, sq, hkv, g, d)
    dof = do.to(wide).reshape(b, sq, hkv, g, d)
    delta = (dof * o.to(wide).reshape(b, sq, hkv, g, d)).sum(-1)
    kf, vf = k.to(wide), v.to(wide)
    lsef = lse.to(wide).reshape(b, hkv, g, sq)
    mask = _mask(sq, sk, causal, window, q.device, kv_valid_len)
    dq = torch.empty((b, sq, hkv, g, d), dtype=wide, device=q.device)
    dk = torch.empty((b, sk, hkv, d), dtype=wide, device=q.device)
    dv = torch.empty_like(dk)
    zero = torch.zeros((), dtype=wide, device=q.device)
    for j in range(hkv):
        s = torch.einsum("bqgd,bkd->bgqk", qf[:, :, j], kf[:, :, j]) * scale
        p = torch.where(mask, torch.exp(s - lsef[:, j, :, :, None]), zero)
        dp = torch.einsum("bqgd,bkd->bgqk", dof[:, :, j], vf[:, :, j])
        ds = torch.where(mask, p * (dp - delta[:, :, j].transpose(1, 2)
                                    [..., None]), zero)
        dq[:, :, j] = torch.einsum("bgqk,bkd->bqgd", ds, kf[:, :, j]) * scale
        dk[:, :, j] = torch.einsum("bgqk,bqgd->bkd", ds, qf[:, :, j]) * scale
        dv[:, :, j] = torch.einsum("bgqk,bqgd->bkd", p, dof[:, :, j])
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def check_lengths(kv_valid_len, b: int, device) -> None:
    """A per-row key length for a kernel: int32 [B], contiguous, on the
    inputs' device. Its values are not read here (that would be a host
    sync a launch): the kernels clamp them to [0, Sk]."""
    if kv_valid_len is None:
        return
    if kv_valid_len.dtype != torch.int32 \
            or tuple(kv_valid_len.shape) != (b,) \
            or kv_valid_len.device != device \
            or not kv_valid_len.is_contiguous():
        raise ValueError(f"kv_valid_len must be int32 [{b}], contiguous on "
                         f"{device}, got {kv_valid_len.dtype} "
                         f"{tuple(kv_valid_len.shape)} on "
                         f"{kv_valid_len.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(q, k, v, o, do, lse):
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v, o,
                                                                 do)):
        raise ValueError("q, k, v, o and do must share one type of "
                         f"{sorted(map(str, DTYPES))}, got "
                         f"{[str(t.dtype) for t in (q, k, v, o, do)]}")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("q, o, do must be one [B, Sq, H, D] shape and k, v "
                         f"one [B, Sk, Hkv, D] shape, got q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}")
    b, sq, h, d = q.shape
    bk, sk, hkv, dk = k.shape
    if bk != b or dk != d or d not in HEAD_DIMS:
        raise ValueError(f"batch {b}/{bk} and head dim {d}/{dk} must match, "
                         f"and the head dim be one of {HEAD_DIMS}")
    if hkv == 0 or h % hkv or sk == 0:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}, and "
                         f"Sk={sk} positive")
    if tuple(lse.shape) != (b * h, sq):
        raise ValueError(f"lse must be [B*H, Sq] = [{b * h}, {sq}], got "
                         f"{tuple(lse.shape)}")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the grid's 65,535 rows")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                    ("lse", lse)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             design: str | None = None,
                             kv_valid_len: torch.Tensor | None = None):
    """K6: attention backward. q, o, do [B, Sq, H, D] and k, v
    [B, Sk, Hkv, D] contiguous, one type of float32 or bfloat16; lse
    [B*H, Sq] float32 -> (dq, dk, dv) in the inputs' type, on the current
    stream. A CPU tensor takes ``flash_attention_bwd_plain``.
    ``kv_valid_len``: int32 [B] on the inputs' device, each row's count of
    valid keys (None: Sk), as the forward took it. ``design`` None takes
    the design of ``flash_tiles``' table; a name forces that design (for
    measurements) and raises where it does not take the inputs. Its span
    is ``kernel.k6``."""
    with lm.span("kernel.k6"):
        return _bwd(q, k, v, o, do, lse, causal, window, design,
                    kv_valid_len)


def _bwd(q, k, v, o, do, lse, causal, window, design, kv_valid_len):
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         window=window,
                                         kv_valid_len=kv_valid_len)
    _check(q, k, v, o, do, lse)
    check_lengths(kv_valid_len, q.shape[0], q.device)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    design = flash_tiles.design(q.dtype, d, design)
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k) if sq == 0 else torch.empty_like(k)
    dv = torch.zeros_like(v) if sq == 0 else torch.empty_like(v)
    if sq == 0 or b == 0:
        return dq, dk, dv
    from repro_torch.kernels._build import library
    stream = torch.cuda.current_stream(q.device).cuda_stream
    causal, window = bool(causal), int(window)
    if design == "wgmma":
        flash_tiles.check_tma(q=q, k=k, v=v, do=do)
        sqp = -(-sq // flash_tiles.ROW_PAD) * flash_tiles.ROW_PAD
        # lse * log2(e) and D = rowsum(do * o), each [B*H, sqp]
        scratch = torch.empty((2, b * h * sqp), dtype=torch.float32,
                              device=q.device)
        sched_q = flash_tiles.schedule_tensor(
            sq, sk, causal, window, *flash_tiles.DQ_TILES, False, q.device)
        sched_k = flash_tiles.schedule_tensor(
            sq, sk, causal, window, *flash_tiles.DKV_TILES, True, q.device)
        library("flash_bwd_hopper.cu").call(
            "flash_bwd_wgmma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(kv_valid_len),
            scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            sched_q.data_ptr(), sched_q.shape[0], sched_k.data_ptr(),
            sched_k.shape[0], b, sq, sk, h, hkv, d, int(causal), window,
            stream)
    else:
        delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
        library("flash_attention_bwd.cu").call(
            "flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), _ptr(kv_valid_len),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
            sq, sk, h, hkv, d, int(causal), window, DTYPES[q.dtype], stream)
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_design[design] += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.launches_by_design = dict.fromkeys(
    flash_tiles.DESIGNS, 0)
