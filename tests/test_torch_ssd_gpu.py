"""The SSD chunk scan (K7), on both of its designs, against its plain
torch version on the card. Marked ``gpu``: it builds the kernels with
nvcc and skips where there is no CUDA device. Run it on a GPU machine
with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_ssd_gpu.py``.

Tolerances: the final state within rtol 1e-4 and atol 1e-4 x its largest
|value| (both sides sum in fp32; the tensor design's float32 operands go
through the tensor cores as three bf16 parts, fp32's 24 bits); y in
float32 within the same, and in bfloat16 within one bf16 ulp of the
larger magnitude, magnitudes below 2**-10 x the largest |reference|
counted as that floor (both compute in fp32 on the same bf16 inputs and
round once). The plain version is tiled as the design tiles
(``kernel_chunk``: 64 tokens for ``cuda_core``, for ``tensor`` 128 at
state 128 and 64 at state 16): tiled otherwise, it sums in another
order, and where y
cancels that order moved a bf16 output 1.5 ulps on mamba2-780m's
4 x 32,768-token prefill."""
import importlib

import numpy as np
import pytest
import torch

ref = importlib.import_module("repro_torch.kernels.ref")
ss = importlib.import_module("repro_torch.kernels.ssd_scan")

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, dtype, b, s, h, p, n, with_state, seed):
    g = np.random.default_rng(seed)
    xdt = torch.tensor(g.normal(size=(b, s, h, p)) * 0.1, dtype=dtype,
                       device=dev)
    a = torch.tensor(-np.abs(g.normal(size=(b, s, h))) * 0.1,
                     dtype=torch.float32, device=dev)
    B = torch.tensor(g.normal(size=(b, s, n)), dtype=dtype, device=dev)
    C = torch.tensor(g.normal(size=(b, s, n)), dtype=dtype, device=dev)
    h0 = torch.tensor(g.normal(size=(b, h, p, n)), dtype=torch.float32,
                      device=dev) if with_state else None
    return xdt, a, B, C, h0


def _close(got, want, dtype):
    a, b = got.float().cpu(), want.float().cpu()
    assert a.shape == b.shape
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    if dtype == torch.float32:
        scale = max(float(b.abs().max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale)
        return
    floor = max(float(b.abs().max()), 1e-30) * 2.0 ** -10
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=floor)
    ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert float(ulps.max()) <= 1.0, float(ulps.max())


CASES = [
    # b, s, h, p, n, with_state
    (2, 512, 48, 64, 128, False),     # mamba2-780m widths
    (1, 1000, 48, 64, 128, True),     # ragged tail, a carried state
    (2, 700, 50, 64, 16, True),       # hymba-1.5b widths
    (3, 37, 4, 24, 8, True),          # shorter than one chunk, p % 16 != 0
    (1, 256, 2, 16, 256, False),      # the widest state
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_scan_matches_plain(dev, dtype, case):
    xdt, a, B, C, h0 = _case(dev, dtype, *case, seed=sum(case[:5]))
    before = ss.ssd_scan_cuda.launches
    y, st = ss.ssd_scan_cuda(xdt, a, B, C, chunk=256, init_state=h0)
    torch.cuda.synchronize()
    assert ss.ssd_scan_cuda.launches == before + 1
    p, n = case[3], case[4]
    want_y, want_st = ss.ssd_scan_plain(
        xdt, a, B, C, chunk=ss.kernel_chunk(dtype, p, n), init_state=h0)
    assert y.dtype == dtype and st.dtype == torch.float32
    _close(y, want_y, dtype)
    _close(st, want_st, torch.float32)


def test_ssd_scan_carries_the_state_across_calls(dev):
    """Two launches, the second from the first's final state, give one
    launch's y and state."""
    xdt, a, B, C, h0 = _case(dev, torch.bfloat16, 1, 640, 48, 64, 128, True,
                             seed=3)
    y, st = ss.ssd_scan_cuda(xdt, a, B, C, init_state=h0)
    y1, s1 = ss.ssd_scan_cuda(*(t[:, :256].contiguous()
                                for t in (xdt, a, B, C)), init_state=h0)
    y2, s2 = ss.ssd_scan_cuda(*(t[:, 256:].contiguous()
                                for t in (xdt, a, B, C)), init_state=s1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(s2, st)


def test_ssd_scan_large_decay_makes_no_nan(dev):
    """Strongly negative a (about -2 a token: cum falls by about 130 over
    K7's chunk of 64 and 500 over the plain version's 256), so that the
    exponents cum_i - cum_j of the pairs j > i reach past fp32's 88.7:
    the kernel exponentiates no positive number, so nothing overflows to
    inf and no inf * 0 turns into NaN. (Much steeper decays put cum at
    1e4, where its fp32 rounding moves exp(cum_i - cum_j) by 0.1% in
    either chunked version.) Held to the sequential oracle, whose decays
    are products of exp(a_t)."""
    xdt, a, B, C, _ = _case(dev, torch.float32, 1, 256, 4, 16, 16, False,
                            seed=5)
    a = a * 25.0
    assert float(a[0, :64].sum(0).min()) < -88.7
    y, st = ss.ssd_scan_cuda(xdt, a, B, C)
    want_y, want_st = ref.ref_ssd_chunk_scan(xdt, a, B, C, 256)
    _close(y, want_y, torch.float32)
    _close(st, want_st, torch.float32)


def test_ssd_scan_refuses_what_it_does_not_take(dev):
    xdt, a, B, C, _ = _case(dev, torch.float32, 1, 64, 2, 16, 8, False, 0)
    with pytest.raises(ValueError):
        ss.ssd_scan_cuda(xdt, a.double(), B, C)
    with pytest.raises(ValueError):
        ss.ssd_scan_cuda(xdt, a, B.bfloat16(), C)
    with pytest.raises(ValueError):
        ss.ssd_scan_cuda(xdt.transpose(1, 2), a, B, C)
    big = torch.zeros((1, 64, 300), device=dev)
    with pytest.raises(ValueError):
        ss.ssd_scan_cuda(xdt, a, big, big)


# the tensor design: bf16 at head dim 64 and state 16 or 128
TENSOR_CASES = [
    # b, s, h, n, with_state
    (2, 600, 4, 128, False),          # a ragged tail
    (2, 600, 4, 16, True),            # hymba's state, a carried state
    (1, 1000, 48, 128, True),         # mamba2-780m's heads
    (3, 37, 5, 16, False),            # shorter than one chunk, h % 4 != 0
]


@pytest.mark.parametrize("case", TENSOR_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_tensor_design_matches_plain_and_counts(dev, case):
    b, s, h, n, with_state = case
    xdt, a, B, C, h0 = _case(dev, torch.bfloat16, b, s, h, 64, n,
                             with_state, seed=s + n)
    assert ss.ssd_design(torch.bfloat16, 64, n) == "tensor"
    counts = ss.ssd_scan_cuda.launches_by_design
    before = dict(counts)
    y, st = ss.ssd_scan_cuda(xdt, a, B, C, init_state=h0)
    torch.cuda.synchronize()
    assert counts == dict(before, tensor=before["tensor"] + 1)
    want_y, want_st = ss.ssd_scan_plain(
        xdt, a, B, C, chunk=ss.kernel_chunk(torch.bfloat16, 64, n),
        init_state=h0)
    _close(y, want_y, torch.bfloat16)
    _close(st, want_st, torch.float32)


@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("chunk", [64, 128])
def test_tensor_design_at_each_chunk(dev, chunk, n):
    """Every chunk the design is built for, against the plain version
    tiled the same way."""
    xdt, a, B, C, h0 = _case(dev, torch.bfloat16, 2, 700, 6, 64, n, True,
                             seed=chunk + n)
    y, st = ss.tensor_scan(xdt, a, B, C, h0, chunk=chunk)
    want_y, want_st = ss.ssd_scan_plain(xdt, a, B, C, chunk=chunk,
                                        init_state=h0)
    _close(y, want_y, torch.bfloat16)
    _close(st, want_st, torch.float32)


def test_tensor_design_carries_the_state_across_calls(dev):
    """Split at a chunk boundary, two launches give one launch's y and
    state bit for bit."""
    xdt, a, B, C, h0 = _case(dev, torch.bfloat16, 1, 900, 8, 64, 128, True,
                             seed=4)
    cut = ss.kernel_chunk(torch.bfloat16, 64, 128) * 2
    y, st = ss.ssd_scan_cuda(xdt, a, B, C, init_state=h0)
    y1, s1 = ss.ssd_scan_cuda(*(t[:, :cut].contiguous()
                                for t in (xdt, a, B, C)), init_state=h0)
    y2, s2 = ss.ssd_scan_cuda(*(t[:, cut:].contiguous()
                                for t in (xdt, a, B, C)), init_state=s1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(s2, st)


def test_tensor_design_large_decay_makes_no_nan(dev):
    """bf16 with a about -2.5 a token: cum falls past fp32's 88.7 inside
    one chunk, so a decay of a pair j > i would overflow; the design
    exponentiates no positive number. Held to the sequential oracle."""
    xdt, a, B, C, _ = _case(dev, torch.bfloat16, 1, 512, 4, 64, 16, False,
                            seed=6)
    a = a * 25.0
    assert float(a[0, :64].sum(0).min()) < -88.7
    y, st = ss.ssd_scan_cuda(xdt, a, B, C)
    assert bool(torch.isfinite(y.float()).all())
    want_y, want_st = ref.ref_ssd_chunk_scan(xdt.float(), a, B.float(),
                                             C.float(), 256)
    _close(y, want_y.to(torch.bfloat16), torch.bfloat16)
    _close(st, want_st, torch.float32)


def test_forced_designs(dev):
    """The cuda_core design takes bf16 too when forced, and counts there;
    forcing the tensor design where it does not take the inputs raises
    before any launch."""
    xdt, a, B, C, h0 = _case(dev, torch.bfloat16, 1, 300, 4, 64, 128, True,
                             seed=8)
    counts = ss.ssd_scan_cuda.launches_by_design
    before = dict(counts)
    y, st = ss.ssd_scan_cuda(xdt, a, B, C, init_state=h0,
                             design="cuda_core")
    assert counts == dict(before, cuda_core=before["cuda_core"] + 1)
    want_y, want_st = ss.ssd_scan_plain(
        xdt, a, B, C, chunk=ss.KERNEL_CHUNK["cuda_core"], init_state=h0)
    _close(y, want_y, torch.bfloat16)
    _close(st, want_st, torch.float32)
    launches = ss.ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="tensor design takes"):
        ss.ssd_scan_cuda(xdt.float(), a, B.float(), C.float(),
                         design="tensor")
    assert ss.ssd_scan_cuda.launches == launches


def test_tensor_design_refuses_a_misaligned_state(dev):
    """The state pass reads init_state by 16-byte loads: a contiguous view
    that starts 4 bytes into its storage raises before any launch, and the
    same values at an aligned address are taken."""
    xdt, a, B, C, h0 = _case(dev, torch.bfloat16, 1, 200, 4, 64, 16, True,
                             seed=10)
    buf = torch.empty(h0.numel() + 1, dtype=torch.float32, device=dev)
    shifted = buf[1:].view(h0.shape)
    shifted.copy_(h0)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    launches = ss.ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="init_state must be 16-byte"):
        ss.ssd_scan_cuda(xdt, a, B, C, init_state=shifted)
    assert ss.ssd_scan_cuda.launches == launches
    y, st = ss.ssd_scan_cuda(xdt, a, B, C, init_state=shifted.clone())
    want_y, want_st = ss.ssd_scan_plain(
        xdt, a, B, C, chunk=ss.kernel_chunk(torch.bfloat16, 64, 16),
        init_state=h0)
    _close(y, want_y, torch.bfloat16)
    _close(st, want_st, torch.float32)
