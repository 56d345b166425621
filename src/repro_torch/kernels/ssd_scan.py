"""Mamba-2 SSD chunk scan, forward (K7): hand-written CUDA kernels for
Hopper and their plain PyTorch version. The scan of the SSM prefill.

``ssd_scan_cuda`` launches a kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU. Layouts are the model's: xdt
[b, s, h, p] (x * dt), a [b, s, h] float32 (dt * A, <= 0), B and C
[b, s, n] shared by the heads, the optional init_state [b, h, p, n]
float32; it returns y [b, s, h, p] in xdt's type and the final state
[b, h, p, n] float32.

It computes what the JAX package's ``ssd_scan_pallas`` computes, and the
carried state besides: the Pallas kernel starts from zero and keeps the
final state in VMEM scratch, while here the state enters from
``init_state`` and leaves as the second output, so that a streaming
prefill continues a sequence across calls. The function is that of the
sequential oracle ``ref_ssd_chunk_scan``.

Two designs, chosen by ``ssd_design`` from the type and the shape:
``tensor`` (``csrc/ssd_hopper.cu``: bf16 at head dim 64 and state 16 or
128; a chunk pass, a state pass and an output pass, every product on the
bf16 tensor cores with float32 operands split into three bf16 parts,
fp32's 24 bits of mantissa) and ``cuda_core`` (``csrc/ssd_scan.cu``: one
block per slice of p, head and batch row walking the chunks in order on
the CUDA cores in float32; every other input, float32 included). Each
tiles the sequence by its own chunk (``kernel_chunk``) and masks a ragged
tail.
``chunk`` is the plain version's chunk (the model's, 256): any length
works in both, and only the rounding differs with the chunking, so a
check tiles the plain version as the design tiles (``kernel_chunk``).

The scan is differentiable, as the JAX package's ``models/ssm.ssd_scan``
is under ``jax.value_and_grad``: it runs inside a
``torch.autograd.Function`` whose backward is ``ssd_scan_bwd``, the port
of that function's reverse scan over ``jax.checkpoint(step)``, in plain
torch on every device (the JAX training path reaches no Pallas kernel
for this gradient either). K7 stays the forward on the card. The final
state takes a cotangent, and ``init_state`` a gradient. The wrapper
counts its launches (forward only) in ``ssd_scan_cuda.launches`` and by
design in ``ssd_scan_cuda.launches_by_design``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import raw_stream

#: xdt / B / C types the kernels take (code passed to ``ssd_scan``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest state the cuda_core design's shared memory holds
MAX_STATE = 256
DESIGNS = ("tensor", "cuda_core")
#: the head dim and the states the tensor design takes
TENSOR_P = 64
TENSOR_N = (16, 128)
#: the chunks the tensor design is built for
TENSOR_CHUNKS = (64, 128)
#: each design's own chunk, in tokens: the cuda_core design's ``kQ`` of
#: ``csrc/ssd_scan.cu``; the tensor design's by state size, a measured
#: choice (PERF.md: of 64, 128 and 256, 128 was fastest at mamba2-780m's
#: state of 128 and 64 at hymba-1.5b's 16)
KERNEL_CHUNK = {"tensor": {16: 64, 128: 128}, "cuda_core": 64}
#: a pass-3 block's heads at most (``kMaxHeads`` in ``csrc/ssd_hopper.cu``)
TENSOR_MAX_HEADS = 8


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


def ssd_design(dtype: torch.dtype, p: int, n: int,
               forced: Optional[str] = None) -> str:
    """K7's design for xdt's type, head dim ``p`` and state ``n``:
    ``tensor`` for bf16 at p TENSOR_P and n in TENSOR_N, else
    ``cuda_core``; or ``forced`` (a measurement's choice), which must take
    these inputs."""
    table = "tensor" if dtype == torch.bfloat16 and p == TENSOR_P \
        and n in TENSOR_N else "cuda_core"
    if forced is None:
        return table
    if forced not in DESIGNS:
        raise ValueError(f"design {forced!r} is none of {DESIGNS}")
    if forced == "tensor" and table != "tensor":
        raise ValueError(f"the tensor design takes bf16 at head dim "
                         f"{TENSOR_P} and state {TENSOR_N}, got {dtype}, "
                         f"p {p}, n {n}")
    return forced


def kernel_chunk(dtype: torch.dtype, p: int, n: int,
                 design: Optional[str] = None) -> int:
    """The chunk that K7 tiles these inputs by: the plain version tiled
    by it sums in the kernel's order."""
    chosen = ssd_design(dtype, p, n, design)
    return KERNEL_CHUNK["tensor"][n] if chosen == "tensor" \
        else KERNEL_CHUNK["cuda_core"]


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tensor_plan(b: int, s: int, h: int, n: int, q: int,
                sms: int) -> Tuple[int, int, int]:
    """(chunks, heads of a pass-3 block, workspace floats) of a tensor
    launch at chunk ``q`` on a card of ``sms`` SMs: a block walks up to
    TENSOR_MAX_HEADS heads with one score tile, fewer where the grid
    would not fill the SMs twice; the workspace holds each chunk's
    [TENSOR_P, n] state and its total decay."""
    if q not in TENSOR_CHUNKS:
        raise ValueError(f"chunk {q} is none of {TENSOR_CHUNKS}")
    nc = -(-s // q)
    heads = max(1, min(TENSOR_MAX_HEADS, b * nc * h // (2 * sms)))
    return nc, heads, b * nc * h * (TENSOR_P * n + 1)


def _outputs(xdt, n, init_state):
    """(y, final state), or the result itself where no launch is due."""
    b, s, h, p = xdt.shape
    y = torch.empty_like(xdt)
    if b == 0 or h == 0 or p == 0:
        return y, torch.empty((b, h, p, n), dtype=torch.float32,
                              device=xdt.device), True
    if s == 0:
        return y, (torch.zeros((b, h, p, n), dtype=torch.float32,
                               device=xdt.device)
                   if init_state is None else init_state.clone()), True
    return y, torch.empty((b, h, p, n), dtype=torch.float32,
                          device=xdt.device), False


def _launch_cuda_core(xdt, a, B, C, init_state):
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    y, final, done = _outputs(xdt, n, init_state)
    if done:
        return y, final
    from repro_torch.kernels._build import library
    library("ssd_scan.cu").call(
        "ssd_scan", xdt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        None if init_state is None else init_state.data_ptr(), y.data_ptr(),
        final.data_ptr(), b, s, h, p, n, DTYPES[xdt.dtype],
        raw_stream(xdt.device))
    return y, final


def tensor_scan(xdt, a, B, C, init_state=None,
                chunk: Optional[int] = None):
    """One launch of the tensor design (``ssd_tensor``: three kernels) at
    ``chunk`` (``kernel_chunk``'s by default), on checked inputs: (y,
    final state). The wrapper's path, and the measurements' (it counts no
    launch). A CPU tensor takes ``ssd_scan_plain`` tiled by the same
    chunk."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    q = kernel_chunk(xdt.dtype, p, n) if chunk is None else chunk
    if not xdt.is_cuda:
        return ssd_scan_plain(xdt, a, B, C, chunk=q, init_state=init_state)
    ssd_design(xdt.dtype, p, n, "tensor")
    # 16-byte loads: cp.async of xdt and B, C's rows, init_state by float4
    for name, t in (("xdt", xdt), ("B", B), ("C", C),
                    ("init_state", init_state)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y, final, done = _outputs(xdt, n, init_state)
    if done:
        return y, final
    _, heads, words = tensor_plan(b, s, h, n, q, _sm_count(xdt.device.index))
    # one allocation: the chunk states [b, nc, h, p, n], then the chunk
    # totals [b, nc, h]
    ws = torch.empty(words, dtype=torch.float32, device=xdt.device)
    from repro_torch.kernels._build import library
    library("ssd_hopper.cu").call(
        "ssd_tensor", xdt.data_ptr(), a.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), ws.data_ptr(), b, s, h, p, n, q,
        heads, raw_stream(xdt.device))
    return y, final


def _chunk_state(state, xc, ac, Bc):
    """The state after one float32 chunk: the entering ``state`` decayed
    over the chunk plus the chunk's own inputs, each decayed from its
    token to the chunk's end."""
    cum = torch.cumsum(ac, dim=1)                              # [b,q,h]
    total = cum[:, -1]                                         # [b,h]
    w = torch.exp(total[:, None, :] - cum)                     # [b,q,h]
    return torch.exp(total)[:, :, None, None] * state \
        + torch.einsum("bjn,bjhp->bhpn", Bc, xc * w[..., None])


def _chunk_step(state, xc, ac, Bc, Cc, mask):
    """One float32 chunk of the JAX ``ssd_scan``'s ``step``: (y [b, q, h,
    p], the state after the chunk). The decay tile's upper triangle is
    exp(-inf) = 0, whose gradient is 0 too."""
    cum = torch.cumsum(ac, dim=1)
    scores = torch.einsum("bin,bjn->bij", Cc, Bc)              # [b,q,q]
    ldecay = cum[:, :, None, :] - cum[:, None, :, :]           # [b,qi,qj,h]
    decay = torch.exp(torch.where(mask[None, :, :, None], ldecay,
                                  float("-inf")))
    y = torch.einsum("bijh,bjhp->bihp", scores[..., None] * decay, xc) \
        + torch.einsum("bin,bhpn->bihp", Cc, state) \
        * torch.exp(cum)[..., None]
    return y, _chunk_state(state, xc, ac, Bc)


def _chunk_vjp(state, xc, ac, Bc, Cc, mask, dyc, dnew):
    """The chunk's step run again under autograd, and its VJP: the
    gradients of (xc, ac, Bc, Cc, the entering state) for the cotangents
    ``dyc`` of y and ``dnew`` of the state after the chunk."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (xc, ac, Bc, Cc, state)]
        y, new = _chunk_step(leaves[4], *leaves[:4], mask)
        return torch.autograd.grad((y, new), leaves, (dyc, dnew))


def ssd_scan_bwd(xdt, a, B, C, init_state, dy, dstate, chunk: int = 256):
    """The SSD scan's gradient: (dxdt, da, dB, dC, dinit_state) for the
    cotangents ``dy`` of y and ``dstate`` of the final state (either may
    be None: zero), in the inputs' types (None for an absent init_state).

    The JAX reverse scan over ``jax.checkpoint(step)``: the float32 states
    at the chunk boundaries are recomputed first, one chunk after another
    ([nc, b, h, p, n]); then the chunks are walked in reverse, each step
    run again and differentiated (``_chunk_vjp``), the state's adjoint
    carried backwards. Chunks of ``chunk`` tokens, a ragged tail padded
    with a = 0 and zero xdt, B and C. Plain torch on every device; it
    shares no code with ``ssd_scan_plain``, K7's oracle, which tests
    differentiate directly to check this function."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    dev = xdt.device
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev) \
        if init_state is None else init_state.float()
    g_state = torch.zeros_like(state) if dstate is None else dstate.float()
    q = max(min(chunk, s), 1)
    pad = -s % q

    def padded(t):
        return F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))

    xf, af, Bf, Cf = map(padded, (xdt, a, B, C))
    dyf = torch.zeros_like(xf) if dy is None else padded(dy)
    starts = []
    with torch.no_grad():
        for c0 in range(0, s + pad, q):
            starts.append(state)
            state = _chunk_state(state, xf[:, c0:c0 + q], af[:, c0:c0 + q],
                                 Bf[:, c0:c0 + q])
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    grads = [torch.empty_like(t) for t in (xf, af, Bf, Cf)]
    for i in reversed(range(len(starts))):
        c = slice(i * q, (i + 1) * q)
        *parts, g_state = _chunk_vjp(starts[i], xf[:, c], af[:, c],
                                     Bf[:, c], Cf[:, c], mask, dyf[:, c],
                                     g_state)
        for g, part in zip(grads, parts):
            g[:, c] = part
    dx, da, dB, dC = (g[:, :s].to(t.dtype)
                      for g, t in zip(grads, (xdt, a, B, C)))
    return dx, da, dB, dC, None if init_state is None else g_state


class _SSDScan(torch.autograd.Function):
    """K7 (or, for CPU tensors, its plain version) forward, and
    ``ssd_scan_bwd`` backward."""

    @staticmethod
    def forward(ctx, xdt, a, B, C, init_state, chunk, design):
        if xdt.is_cuda:
            _check(xdt, a, B, C, init_state)
            chosen = ssd_design(xdt.dtype, xdt.shape[-1], B.shape[-1],
                                design)
            if chosen == "tensor":
                y, final = tensor_scan(xdt, a, B, C, init_state)
            else:
                y, final = _launch_cuda_core(xdt, a, B, C, init_state)
            if xdt.numel():           # else nothing was launched
                ssd_scan_cuda.launches += 1
                ssd_scan_cuda.launches_by_design[chosen] += 1
        else:
            y, final = ssd_scan_plain(xdt, a, B, C, chunk=chunk,
                                      init_state=init_state)
        ctx.save_for_backward(xdt, a, B, C, init_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = ssd_scan_bwd(*ctx.saved_tensors, dy, dstate,
                             chunk=ctx.chunk)
        return (*grads, None, None)


def ssd_scan_cuda(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, chunk: int = 256,
                  init_state: Optional[torch.Tensor] = None,
                  design: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: the SSD chunk scan. xdt [b, s, h, p] and B, C [b, s, n] of one
    type of float32 or bfloat16, a [b, s, h] float32, init_state
    [b, h, p, n] float32 or None, all contiguous -> (y [b, s, h, p] in
    xdt's type, final state [b, h, p, n] float32), on the current stream.
    ``design`` None takes ``ssd_design``'s choice; a name forces that
    design (for measurements) and raises where it does not take the
    inputs. A CPU tensor takes ``ssd_scan_plain`` (by ``chunk``). The
    gradient is ``ssd_scan_bwd``'s, by ``chunk``, on every device."""
    return _SSDScan.apply(xdt, a, B, C, init_state, int(chunk), design)


ssd_scan_cuda.launches = 0
ssd_scan_cuda.launches_by_design = dict.fromkeys(DESIGNS, 0)
