"""The attention kernels (K4 paged decode, K5 flash forward) against their
plain torch versions on the card. Marked ``gpu``: they build the kernels
with nvcc and skip where there is no CUDA device. Run them on a GPU
machine with ``PYTHONPATH=src python -m pytest -m gpu tests/``.

Tolerances: float32 within rtol and atol 2e-5 (both sides compute in
fp32, summing in another order); bfloat16 within one bf16 ulp of the
larger magnitude, magnitudes below 2**-10 counted as 2**-10 (both round
one fp32 result to bf16 once); lse within 1e-4 (float32) and 1e-3
(bfloat16 inputs). NaN rows (no position to attend to) must be NaN on
both sides."""
import importlib

import numpy as np
import pytest
import torch

da = importlib.import_module("repro_torch.kernels.decode_attention")
fa = importlib.import_module("repro_torch.kernels.flash_attention")

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: None}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(a, b, tol):
    """``tol`` None: within one bf16 ulp."""
    a, b = a.float().cpu(), b.float().cpu()
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    fin = ~torch.isnan(b)
    a, b = a[fin], b[fin]
    if tol is not None:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol)
        return
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -10)
    ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert float(ulps.max()) <= 1.0, float(ulps.max())


def _paged_case(dev, dtype, b, h, hkv, d, pages, page, pps, seed):
    g = np.random.default_rng(seed)
    q = torch.tensor(g.normal(size=(b, h, d)), dtype=dtype, device=dev)
    kp = torch.tensor(g.normal(size=(pages, page, hkv, d)), dtype=dtype,
                      device=dev)
    vp = torch.tensor(g.normal(size=(pages, page, hkv, d)), dtype=dtype,
                      device=dev)
    table = np.full((b, pps), -1, np.int32)
    lens = np.zeros(b, np.int32)
    perm = g.permutation(pages)
    c = 0
    for i in range(b):
        used = int(g.integers(1, pps + 1))
        table[i, :used] = perm[c:c + used]
        c += used
        lens[i] = g.integers(1, used * page + 1)
    if b > 2:
        lens[1] = 0                      # nothing to attend to: NaN
        if table[2, 0] >= 0 and lens[2] > page:
            table[2, 0] = -1             # a -1 page inside seq_len
    return (q, kp, vp, torch.tensor(table, device=dev),
            torch.tensor(lens, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,d,pages,page,pps", [
    (2, 4, 2, 64, 8, 16, 3),
    (3, 8, 2, 64, 16, 32, 4),
    (1, 8, 8, 128, 8, 64, 2),
    (4, 36, 4, 128, 64, 16, 12),         # starcoder2-7b: G = 9
    (4, 25, 5, 64, 64, 16, 12),          # hymba-1.5b: G = 5
    (3, 40, 2, 32, 32, 16, 8),           # G = 20: two head chunks
    (3, 8, 1, 256, 32, 8, 8),
])
def test_decode_kernel_matches_plain(dev, dtype, b, h, hkv, d, pages, page,
                                     pps):
    args = _paged_case(dev, dtype, b, h, hkv, d, pages, page, pps,
                       seed=b * h + d)
    before = da.decode_attention_paged_cuda.launches
    out = da.decode_attention_paged_cuda(*args)
    torch.cuda.synchronize()
    assert da.decode_attention_paged_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, h, d)
    _close(out, da.decode_attention_paged_plain(*args), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (2, 256, 256, 4, 1, 128, False, 0),
    (1, 512, 512, 2, 2, 64, True, 128),
    (1, 128, 384, 2, 2, 64, False, 0),   # cross-attention shape
    (1, 200, 200, 18, 2, 128, True, 0),  # G = 9, ragged tile
    (1, 300, 300, 10, 2, 64, True, 100),  # hymba-like window, G = 5
    (1, 96, 160, 4, 2, 32, True, 0),     # Sq != Sk, causal
    (1, 64, 64, 2, 1, 256, True, 0),
])
def test_flash_kernel_matches_plain(dev, dtype, b, sq, sk, h, hkv, d,
                                    causal, window):
    g = np.random.default_rng(sq + sk + h)
    q = torch.tensor(g.normal(size=(b, sq, h, d)), dtype=dtype, device=dev)
    k = torch.tensor(g.normal(size=(b, sk, hkv, d)), dtype=dtype, device=dev)
    v = torch.tensor(g.normal(size=(b, sk, hkv, d)), dtype=dtype, device=dev)
    before = fa.flash_attention_cuda.launches
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    ro, rlse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    assert o.dtype == dtype and lse.shape == (b * h, sq)
    _close(o, ro, TOL[dtype])
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(),
                               rtol=lse_tol, atol=lse_tol)


def test_flash_kernel_row_with_nothing_to_attend_is_nan(dev):
    """Causal with a window and Sq > Sk + window: late rows see no key,
    and are NaN with lse -inf, as the plain version."""
    g = np.random.default_rng(3)
    q = torch.tensor(g.normal(size=(1, 256, 2, 64)), dtype=torch.float32,
                     device=dev)
    k = torch.tensor(g.normal(size=(1, 64, 2, 64)), dtype=torch.float32,
                     device=dev)
    o, lse = fa.flash_attention_cuda(q, k, k, causal=True, window=32,
                                     return_lse=True)
    ro, rlse = fa.flash_attention_plain(q, k, k, causal=True, window=32,
                                        return_lse=True)
    _close(o, ro, 2e-5)
    assert bool(torch.isnan(o[0, 200]).all())
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rlse))


def test_attention_wrappers_reject_bad_inputs(dev):
    q, kp, vp, table, lens = _paged_case(dev, torch.float32, 2, 4, 2, 64, 8,
                                         16, 3, seed=0)
    with pytest.raises(ValueError):      # mixed types
        da.decode_attention_paged_cuda(q.bfloat16(), kp, vp, table, lens)
    with pytest.raises(ValueError):      # H not a multiple of Hkv
        da.decode_attention_paged_cuda(q[:, :3], kp, vp, table, lens)
    with pytest.raises(ValueError):      # table on the CPU
        da.decode_attention_paged_cuda(q, kp, vp, table.cpu(), lens)
    with pytest.raises(ValueError):      # strided pages
        da.decode_attention_paged_cuda(q, kp.transpose(0, 1), vp, table,
                                       lens)
    x = torch.zeros(1, 64, 4, 48, device=dev)
    with pytest.raises(ValueError):      # head dim without a kernel
        fa.flash_attention_cuda(x, x, x)
    y = torch.zeros(1, 64, 4, 64, device=dev)
    with pytest.raises(ValueError):      # not contiguous
        fa.flash_attention_cuda(y.transpose(1, 2), y, y)


def test_ops_never_move_the_pool_to_the_query(dev):
    """A CPU query against pages on the card raises: the entry point runs
    on the pool's device and does not copy the pool to the CPU."""
    from repro_torch.kernels import ops
    q, kp, vp, table, lens = _paged_case(dev, torch.float32, 2, 4, 2, 64, 8,
                                         16, 3, seed=0)
    before = da.decode_attention_paged_cuda.launches
    with pytest.raises(ValueError, match="q is on cpu"):
        ops.decode_attention_paged(q.cpu(), kp, vp, table, lens)
    out = ops.decode_attention_paged(q.cpu().numpy(), kp, vp, table, lens)
    assert out.is_cuda
    assert da.decode_attention_paged_cuda.launches == before + 1
    x = torch.zeros(1, 64, 2, 64, device=dev)
    with pytest.raises(ValueError, match="q is on cpu"):
        ops.flash_attention(x.cpu(), x, x)
