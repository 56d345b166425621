"""The flash attention backward (K6) against its plain torch version on the
card. Marked ``gpu``: it builds the kernels with nvcc and skips where there
is no CUDA device. Run it on a GPU machine with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_flash_bwd_gpu.py``.

Tolerances: float32 within rtol and atol 1e-4 (both sides compute in fp32;
dk and dv sum up to G * Sq products, in another order); bfloat16 on the
CUDA-core design (head dims 32 and 256) within one bf16 ulp of the larger
magnitude, magnitudes below 2**-10 x the largest |reference| counted as
that floor (both round one fp32 result to bf16 once; near-cancelling sums
keep an fp32 error of about 1e-6 of the largest term, well inside that
floor's ulp); bfloat16 on the wgmma design (head dims 64 and 128), which
rounds P and dS to bf16 before their products as the Pallas kernels do,
within the limits of ``repro_torch.kernels.flash_limits`` (the worst
row's norm-relative error BWD_ROW_RTOL, elementwise ULP_LIMIT ulps with
the same floor; anchored on the Pallas kernels' own readings by
``tests/test_torch_flash_rounding.py``)."""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("repro_torch.kernels.flash_attention")
fb = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
FL = importlib.import_module("repro_torch.kernels.flash_limits")
FT = importlib.import_module("repro_torch.kernels.flash_tiles")

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(a, b, dtype, design="cuda_core"):
    a, b = a.float().cpu(), b.float().cpu()
    assert a.shape == b.shape
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    if dtype == torch.float32:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
        return
    if design == "wgmma":
        assert FL.row_error(a, b) <= FL.BWD_ROW_RTOL, FL.row_error(a, b)
        floor = max(float(b.abs().max()), 1e-30) * 2.0 ** -10
        assert FL.ulp_error(a, b, floor) <= FL.ULP_LIMIT
        return
    floor = max(float(b.abs().max()), 1e-30) * 2.0 ** -10
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=floor)
    ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert float(ulps.max()) <= 1.0, float(ulps.max())


def _case(dev, dtype, b, sq, sk, h, hkv, d, causal, window, seed):
    """Inputs of one backward: q, k, v random, o and lse from K5, do
    random."""
    g = np.random.default_rng(seed)
    q = torch.tensor(g.normal(size=(b, sq, h, d)), dtype=dtype, device=dev)
    k = torch.tensor(g.normal(size=(b, sk, hkv, d)), dtype=dtype, device=dev)
    v = torch.tensor(g.normal(size=(b, sk, hkv, d)), dtype=dtype, device=dev)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    do = torch.tensor(g.normal(size=(b, sq, h, d)), dtype=dtype, device=dev)
    return q, k, v, o, do, lse


def _oracle(args, design):
    """The plain version's inputs: the kernel's own, or for the wgmma
    design their float32 values, so that the oracle rounds nothing."""
    if design != "wgmma":
        return args
    return tuple(x.float() for x in args[:5]) + (args[5],)


CASES = [
    # b, sq, sk, h, hkv, d, causal, window
    (1, 128, 128, 2, 2, 64, True, 0),       # G = 1
    (2, 256, 256, 4, 2, 64, False, 0),
    (2, 200, 200, 18, 2, 128, True, 0),     # starcoder2-7b: G = 9, ragged
    (1, 300, 300, 10, 2, 64, True, 100),    # hymba-1.5b: G = 5, window
    (1, 96, 160, 4, 2, 32, True, 0),        # Sq < Sk, causal
    (1, 160, 96, 4, 1, 32, True, 0),        # Sq > Sk, causal
    (1, 128, 384, 2, 2, 64, False, 0),      # cross-attention shape
    (1, 192, 192, 4, 2, 64, False, 48),     # window without causal
    (1, 64, 64, 2, 1, 256, True, 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", CASES)
def test_flash_bwd_kernel_matches_plain(dev, dtype, b, sq, sk, h, hkv, d,
                                        causal, window):
    args = _case(dev, dtype, b, sq, sk, h, hkv, d, causal, window,
                 seed=sq + sk + h + d)
    design = FT.design(dtype, d)
    before = fb.flash_attention_bwd_cuda.launches
    by_design = fb.flash_attention_bwd_cuda.launches_by_design[design]
    got = fb.flash_attention_bwd_cuda(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fb.flash_attention_bwd_cuda.launches == before + 1
    assert fb.flash_attention_bwd_cuda.launches_by_design[design] == \
        by_design + 1
    want = fb.flash_attention_bwd_plain(*_oracle(args, design),
                                        causal=causal, window=window)
    for x, y, t in zip(got, want, args[:3]):
        assert x.dtype == dtype and x.shape == t.shape
        _close(x, y, dtype, design)


def test_flash_bwd_row_with_nothing_to_attend(dev):
    """Causal with a window and Sq > Sk + window: late rows see no key
    (o NaN, lse -inf). Their dq is 0 and they add nothing to dk or dv, as
    in the plain version: no NaN anywhere."""
    args = _case(dev, torch.float32, 1, 256, 64, 2, 2, 64, True, 32, seed=3)
    assert bool(torch.isnan(args[3][0, 200]).all())
    got = fb.flash_attention_bwd_cuda(*args, causal=True, window=32)
    want = fb.flash_attention_bwd_plain(*args, causal=True, window=32)
    for x, y in zip(got, want):
        _close(x, y, torch.float32)
    assert not bool(got[0][0, 100:].any())


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", [
    (1, 600, 600, 4, 2, 128, True, 0),      # ragged: S = 600
    (1, 1000, 600, 4, 1, 64, True, 0),      # Sq > Sk
    (1, 600, 1000, 4, 1, 128, True, 0),     # Sq < Sk
    (1, 1024, 1024, 36, 4, 128, True, 0),   # starcoder2-7b: G = 9
    (1, 2048, 2048, 25, 5, 64, True, 1024),  # hymba-1.5b: G = 5, window
    (2, 384, 384, 4, 2, 64, False, 100),    # a window without causal
])
def test_flash_bwd_wgmma_matches_plain(dev, b, sq, sk, h, hkv, d, causal,
                                       window):
    args = _case(dev, torch.bfloat16, b, sq, sk, h, hkv, d, causal, window,
                 seed=sq + d)
    got = fb.flash_attention_bwd_cuda(*args, causal=causal, window=window)
    want = fb.flash_attention_bwd_plain(*_oracle(args, "wgmma"),
                                        causal=causal, window=window)
    for x, y in zip(got, want):
        _close(x, y, torch.bfloat16, "wgmma")


def test_flash_bwd_wgmma_row_with_nothing_to_attend(dev):
    """bf16 at D 64 (the wgmma design), Sq > Sk + window: late rows see no
    key (o NaN, lse -inf); their dq is 0 and they add nothing to dk or dv:
    no NaN anywhere."""
    args = _case(dev, torch.bfloat16, 1, 256, 64, 2, 2, 64, True, 32,
                 seed=3)
    assert bool(torch.isnan(args[3][0, 200]).all())
    got = fb.flash_attention_bwd_cuda(*args, causal=True, window=32)
    want = fb.flash_attention_bwd_plain(*_oracle(args, "wgmma"),
                                        causal=True, window=32)
    for x, y in zip(got, want):
        _close(x, y, torch.bfloat16, "wgmma")
    assert not bool(got[0][0, 100:].any())


def test_flash_bwd_dispatch_follows_the_design_table(dev):
    """bf16 at D 128 launches the wgmma design and float32 the CUDA-core
    one; bf16 forced onto the CUDA-core design keeps its one-ulp
    agreement with the oracle."""
    counts = fb.flash_attention_bwd_cuda.launches_by_design
    args = _case(dev, torch.bfloat16, 1, 256, 256, 4, 2, 128, True, 0,
                 seed=9)
    before = dict(counts)
    fb.flash_attention_bwd_cuda(*args)
    assert counts["wgmma"] == before["wgmma"] + 1
    assert counts["cuda_core"] == before["cuda_core"]
    got = fb.flash_attention_bwd_cuda(*args, design="cuda_core")
    assert counts["cuda_core"] == before["cuda_core"] + 1
    for x, y in zip(got, fb.flash_attention_bwd_plain(*args)):
        _close(x, y, torch.bfloat16)
    fb.flash_attention_bwd_cuda(*(x.float() if x.dtype == torch.bfloat16
                                  else x for x in args))
    assert counts["cuda_core"] == before["cuda_core"] + 2


def test_flash_bwd_is_deterministic_and_k5_recomputes_its_bits(dev):
    """No atomics: two backwards give the same bits; and K5 run twice (as
    under remat) gives the same o and lse. bf16 at D 128: the wgmma
    design."""
    q, k, v, o, do, lse = _case(dev, torch.bfloat16, 2, 256, 256, 18, 2,
                                128, True, 0, seed=7)
    o2, lse2 = fa.flash_attention_cuda(q, k, v, causal=True,
                                       return_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    a = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    b = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_backward_on_the_card_goes_through_k6(dev):
    """``.backward`` through the forward wrapper launches K6 once and
    gives the plain versions' gradient."""
    g = np.random.default_rng(11)
    leaves = [torch.tensor(g.normal(size=s), dtype=torch.float32,
                           device=dev, requires_grad=True)
              for s in ((1, 192, 4, 64), (1, 192, 2, 64), (1, 192, 2, 64))]
    do = torch.tensor(g.normal(size=(1, 192, 4, 64)), dtype=torch.float32,
                      device=dev)
    before = (fa.flash_attention_cuda.launches,
              fb.flash_attention_bwd_cuda.launches)
    got = torch.autograd.grad(fa.flash_attention_cuda(*leaves), leaves, do)
    assert (fa.flash_attention_cuda.launches,
            fb.flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                      before[1] + 1)
    from repro_torch.kernels import ops
    want = torch.autograd.grad(ops.flash_attention_vjp(*leaves,
                                                       backend="ref"),
                               leaves, do)
    for x, y in zip(got, want):
        _close(x, y, torch.float32)


def test_flash_bwd_wrapper_rejects_bad_inputs(dev):
    q, k, v, o, do, lse = _case(dev, torch.float32, 1, 64, 64, 4, 2, 64,
                                True, 0, seed=0)
    with pytest.raises(ValueError):      # mixed types
        fb.flash_attention_bwd_cuda(q, k, v, o, do.bfloat16(), lse)
    with pytest.raises(ValueError):      # lse not float32
        fb.flash_attention_bwd_cuda(q, k, v, o, do, lse.double())
    with pytest.raises(ValueError):      # lse of another shape
        fb.flash_attention_bwd_cuda(q, k, v, o, do, lse[:, :32])
    with pytest.raises(ValueError):      # H not a multiple of Hkv
        fb.flash_attention_bwd_cuda(q[:, :, :3].contiguous(), k, v,
                                    o[:, :, :3].contiguous(),
                                    do[:, :, :3].contiguous(), lse[:3])
    with pytest.raises(ValueError):      # not contiguous
        fb.flash_attention_bwd_cuda(q.transpose(1, 2), k, v, o, do, lse)
    with pytest.raises(ValueError):      # lse on the CPU
        fb.flash_attention_bwd_cuda(q, k, v, o, do, lse.cpu())
    x = torch.zeros(1, 64, 4, 48, device=dev)
    y = torch.zeros(1, 64, 2, 48, device=dev)
    with pytest.raises(ValueError):      # head dim without a kernel
        fb.flash_attention_bwd_cuda(x, y, y, x, x, lse)
