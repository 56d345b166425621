"""Mamba-2 SSD chunk scan, forward (K7): a hand-written CUDA kernel for
Hopper and its plain PyTorch version. The scan of the SSM prefill.

``ssd_scan_cuda`` launches ``ssd_scan`` (``csrc/ssd_scan.cu``) for a CUDA
tensor and takes the plain version only for a tensor on the CPU. Layouts
are the model's: xdt [b, s, h, p] (x * dt), a [b, s, h] float32 (dt * A,
<= 0), B and C [b, s, n] shared by the heads, the optional init_state
[b, h, p, n] float32; it returns y [b, s, h, p] in xdt's type and the
final state [b, h, p, n] float32.

It computes what the JAX package's ``ssd_scan_pallas`` computes, and the
carried state besides: the Pallas kernel starts from zero and keeps the
final state in VMEM scratch, while here the state enters from
``init_state`` and leaves as the second output, so that a streaming
prefill continues a sequence across calls. The function is that of the
sequential oracle ``ref_ssd_chunk_scan``.

``chunk`` is the plain version's chunk (the model's, 256); the kernel
tiles by its own 64 tokens and masks a ragged tail, and so does the plain
version (by ``chunk``): any length works in both. Only the rounding
differs with the chunking.

The scan is forward-only, as ``ssd_scan_pallas`` has no VJP: it runs
inside a ``torch.autograd.Function`` whose backward raises
``NotImplementedError`` on every device, so that the CPU and the card
refuse a gradient alike. The wrapper counts its launches in
``ssd_scan_cuda.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

#: xdt / B / C types the kernel takes (code passed to the C entry point)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest state the kernel's shared memory holds
MAX_STATE = 256
#: the kernel's own chunk, in tokens (``kQ`` in ``csrc/ssd_scan.cu``)
KERNEL_CHUNK = 64


def ssd_scan_plain(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, chunk: int = 256,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's function in plain torch: the chunked SSD of the JAX package's
    ``models/ssm.ssd_scan`` in float32 (the cumulative decay, the
    intra-chunk [Q, Q] term, the inter-chunk term from the carried state,
    the state update), chunk after chunk. A ragged tail is padded with
    a = 0 and zero xdt, B and C, which changes no valid output. Returns
    (y in xdt's type, final state float32)."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    dev = xdt.device
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev) \
        if init_state is None else init_state.to(torch.float32)
    if s == 0:
        return torch.empty_like(xdt), state.clone()
    q = max(min(chunk, s), 1)
    pad = -s % q
    xf, af, Bf, Cf = (F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
                      for t in (xdt, a, B, C))
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    neg_inf = torch.tensor(float("-inf"), device=dev)
    ys = []
    for c0 in range(0, s + pad, q):
        xc, ac = xf[:, c0:c0 + q], af[:, c0:c0 + q]
        Bc, Cc = Bf[:, c0:c0 + q], Cf[:, c0:c0 + q]
        cum = torch.cumsum(ac, dim=1)                          # [b,q,h]
        total = cum[:, -1]                                     # [b,h]
        scores = torch.einsum("bin,bjn->bij", Cc, Bc)          # [b,q,q]
        ldecay = cum[:, :, None, :] - cum[:, None, :, :]       # [b,qi,qj,h]
        decay = torch.exp(torch.where(mask[None, :, :, None], ldecay,
                                      neg_inf))
        y_intra = torch.einsum("bijh,bjhp->bihp",
                               scores[..., None] * decay, xc)
        y_inter = torch.einsum("bin,bhpn->bihp", Cc, state) \
            * torch.exp(cum)[..., None]
        w = torch.exp(total[:, None, :] - cum)                 # [b,q,h]
        chunk_state = torch.einsum("bjn,bjhp->bhpn", Bc, xc * w[..., None])
        state = torch.exp(total)[:, :, None, None] * state + chunk_state
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(xdt.dtype), state


def _check(xdt, a, B, C, init_state):
    if xdt.dtype not in DTYPES or B.dtype != xdt.dtype \
            or C.dtype != xdt.dtype:
        raise ValueError("xdt, B and C must share one type of "
                         f"{sorted(map(str, DTYPES))}, got {xdt.dtype}, "
                         f"{B.dtype}, {C.dtype}")
    if a.dtype != torch.float32:
        raise ValueError(f"a must be float32, got {a.dtype}")
    if xdt.dim() != 4 or a.dim() != 3 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError("xdt must be [b, s, h, p], a [b, s, h] and B, C one "
                         f"[b, s, n] shape, got {tuple(xdt.shape)}, "
                         f"{tuple(a.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    if tuple(a.shape) != (b, s, h) or tuple(B.shape[:2]) != (b, s):
        raise ValueError(f"a {tuple(a.shape)} and B {tuple(B.shape)} must "
                         f"match xdt's [b, s, h] = {(b, s, h)}")
    if not 0 < n <= MAX_STATE or b > 65535 or h > 65535:
        raise ValueError(f"state size {n} must be in 1..{MAX_STATE}, and "
                         f"b {b} and h {h} at most 65,535")
    tensors = [("xdt", xdt), ("a", a), ("B", B), ("C", C)]
    if init_state is not None:
        if init_state.dtype != torch.float32 \
                or tuple(init_state.shape) != (b, h, p, n):
            raise ValueError("init_state must be float32 [b, h, p, n] = "
                             f"{(b, h, p, n)}, got {init_state.dtype} "
                             f"{tuple(init_state.shape)}")
        tensors.append(("init_state", init_state))
    for name, t in tensors:
        if t.device != xdt.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xdt.device}")


def _launch(xdt, a, B, C, init_state):
    _check(xdt, a, B, C, init_state)
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    y = torch.empty_like(xdt)
    if b == 0 or h == 0 or p == 0:
        return y, torch.empty((b, h, p, n), dtype=torch.float32,
                              device=xdt.device)
    if s == 0:
        return y, (torch.zeros((b, h, p, n), dtype=torch.float32,
                               device=xdt.device)
                   if init_state is None else init_state.clone())
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=xdt.device)
    from repro_torch.kernels._build import library
    library("ssd_scan.cu").call(
        "ssd_scan", xdt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if init_state is None else init_state.data_ptr(), y.data_ptr(),
        final.data_ptr(), b, s, h, p, n, DTYPES[xdt.dtype],
        torch.cuda.current_stream(xdt.device).cuda_stream)
    ssd_scan_cuda.launches += 1
    return y, final


class _SSDScan(torch.autograd.Function):
    """K7 (or, for CPU tensors, its plain version) with no gradient."""

    @staticmethod
    def forward(ctx, xdt, a, B, C, init_state, chunk):
        if xdt.is_cuda:
            y, final = _launch(xdt, a, B, C, init_state)
        else:
            y, final = ssd_scan_plain(xdt, a, B, C, chunk=chunk,
                                      init_state=init_state)
        ctx.mark_non_differentiable(final)
        return y, final

    @staticmethod
    def backward(ctx, dy, dstate):
        raise NotImplementedError(
            "the SSD chunk scan is forward-only (ssd_scan_pallas has no "
            "VJP): training the SSM and hybrid families is not ported")


def ssd_scan_cuda(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, chunk: int = 256,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: the SSD chunk scan. xdt [b, s, h, p] and B, C [b, s, n] of one
    type of float32 or bfloat16, a [b, s, h] float32, init_state
    [b, h, p, n] float32 or None, all contiguous -> (y [b, s, h, p] in
    xdt's type, final state [b, h, p, n] float32), on the current stream.
    A CPU tensor takes ``ssd_scan_plain`` (by ``chunk``). No gradient: a
    backward raises."""
    return _SSDScan.apply(xdt, a, B, C, init_state, int(chunk))


ssd_scan_cuda.launches = 0
