"""The attention kernels (K4 paged decode, K5 flash forward) against their
plain torch versions on the card. Marked ``gpu``: they build the kernels
with nvcc and skip where there is no CUDA device. Run them on a GPU
machine with ``PYTHONPATH=src python -m pytest -m gpu tests/``.

Tolerances: float32 within rtol and atol 2e-5 (both sides compute in
fp32, summing in another order); bfloat16 on K4 (both designs: the
split-KV design's tensor-core products of bf16 values are exact, and P
goes through them as a high and a low bf16 part, so it keeps fp32
accuracy) and on K5's CUDA-core design (head dims 32 and 256) within one
bf16 ulp of the larger magnitude, magnitudes below 2**-10 counted as
2**-10 (both round one fp32 result to bf16 once); bfloat16 on K5's
wgmma design (head dims 64 and 128), which rounds P to bf16 before P.V as the Pallas kernel does, within
the limits of ``repro_torch.kernels.flash_limits`` (the worst row's
norm-relative error FWD_ROW_RTOL, elementwise ULP_LIMIT ulps; anchored on
the Pallas kernel's own readings by ``tests/test_torch_flash_rounding.py``);
lse within 1e-4 (float32) and 1e-3 (bfloat16 inputs). NaN rows (no
position to attend to) must be NaN on both sides."""
import importlib

import numpy as np
import pytest
import torch

da = importlib.import_module("repro_torch.kernels.decode_attention")
fa = importlib.import_module("repro_torch.kernels.flash_attention")
FL = importlib.import_module("repro_torch.kernels.flash_limits")
FT = importlib.import_module("repro_torch.kernels.flash_tiles")

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


def _close_wgmma(a, b):
    """K5's wgmma design against the fp32 oracle: NaN at the same places,
    the worst row within FWD_ROW_RTOL, elementwise within ULP_LIMIT."""
    a, b = a.float().cpu(), b.float().cpu()
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert FL.row_error(a, b) <= FL.FWD_ROW_RTOL, FL.row_error(a, b)
    assert FL.ulp_error(a, b, 2.0 ** -10) <= FL.ULP_LIMIT


def _qkv(dev, dtype, b, sq, sk, h, hkv, d, seed):
    g = np.random.default_rng(seed)
    return (torch.tensor(g.normal(size=(b, sq, h, d)), dtype=dtype,
                         device=dev),
            torch.tensor(g.normal(size=(b, sk, hkv, d)), dtype=dtype,
                         device=dev),
            torch.tensor(g.normal(size=(b, sk, hkv, d)), dtype=dtype,
                         device=dev))


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
    design = da.decode_design(dtype, d, h // hkv)
    before = da.decode_attention_paged_cuda.launches
    by_design = da.decode_attention_paged_cuda.launches_by_design[design]
    out = da.decode_attention_paged_cuda(*args)
    torch.cuda.synchronize()
    assert da.decode_attention_paged_cuda.launches == before + 1
    assert da.decode_attention_paged_cuda.launches_by_design[design] == \
        by_design + 1
    assert out.dtype == dtype and out.shape == (b, h, d)
    _close(out, da.decode_attention_paged_plain(*args), TOL[dtype])


def _split_case(dev, b, h, hkv, d, page, pps, seed):
    """bf16 pages with sequences that end inside a split, a row with
    nothing (seq_len 0), a row whose first splits are all -1 pages, a -1
    page inside a split, and a full row."""
    g = np.random.default_rng(seed)
    pages = b * pps + 4
    q = torch.tensor(g.normal(size=(b, h, d)), dtype=torch.bfloat16,
                     device=dev)
    kp, vp = (torch.tensor(g.normal(size=(pages, page, hkv, d)),
                           dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    table = g.permutation(pages)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = g.integers(1, pps * page + 1, b).astype(np.int32)
    lens[0] = 0
    lens[1] = pps * page
    table[2, :pps // 2] = -1              # its first half masked
    lens[2] = pps * page - page // 2
    table[3, pps // 3] = -1
    return q, kp, vp, torch.tensor(table, device=dev), \
        torch.tensor(lens, device=dev)


@pytest.mark.parametrize("per", [None, 1, 3, 8])
@pytest.mark.parametrize("b,h,hkv,d,page,pps", [
    (5, 36, 4, 128, 16, 40),             # starcoder2-7b: G = 9
    (6, 25, 5, 64, 16, 37),              # hymba-1.5b: G = 5
    (4, 16, 1, 128, 8, 30),              # G = 16, pages of 8
    (4, 4, 4, 64, 64, 9),                # G = 1, pages of 64
])
def test_decode_split_kv_matches_plain(dev, per, b, h, hkv, d, page, pps):
    """The split-KV design on several splits (forced run lengths, the
    plan's included), splits with nothing to attend to, rows ending inside
    a split, and seq_len 0 (NaN), within one bf16 ulp of the fp32 plain
    version."""
    q, kp, vp, table, lens = _split_case(dev, b, h, hkv, d, page, pps,
                                         seed=h + d + page)
    counts = da.decode_attention_paged_cuda.launches_by_design
    before = dict(counts)
    out = da.decode_attention_paged_cuda(q, kp, vp, table, lens,
                                         pages_per_split=per)
    torch.cuda.synchronize()
    assert counts["split_kv"] == before["split_kv"] + 1
    assert counts["cuda_core"] == before["cuda_core"]
    ref = da.decode_attention_paged_plain(q.float(), kp.float(), vp.float(),
                                          table, lens)
    assert bool(torch.isnan(out[0]).all())
    _close(out, ref, None)


def test_decode_split_kv_skips_pages_outside_the_pool(dev):
    """A page id past the pool is masked as a -1 page is."""
    q, kp, vp, table, lens = _split_case(dev, 4, 36, 4, 128, 16, 40,
                                         seed=9)
    bad = table.clone()
    bad[1, 5] = kp.shape[0] + 7
    out = da.decode_attention_paged_cuda(q, kp, vp, bad, lens)
    masked = table.clone()
    masked[1, 5] = -1
    _close(out, da.decode_attention_paged_plain(
        q.float(), kp.float(), vp.float(), masked, lens), None)


def test_decode_dispatch_follows_the_design_table(dev):
    """bf16 at D 64/128 with G <= 16 launches split_kv; float32, D 32 and
    256, and G > 16 the CUDA-core design; bf16 forced onto the CUDA-core
    design computes the same function, and forcing split_kv where it does
    not apply raises before any launch."""
    counts = da.decode_attention_paged_cuda.launches_by_design
    cases = [(torch.bfloat16, 4, 2, 128, "split_kv"),
             (torch.bfloat16, 10, 2, 64, "split_kv"),
             (torch.float32, 4, 2, 128, "cuda_core"),
             (torch.bfloat16, 4, 2, 32, "cuda_core"),
             (torch.bfloat16, 8, 1, 256, "cuda_core"),
             (torch.bfloat16, 40, 2, 64, "cuda_core")]
    for dtype, h, hkv, d, want in cases:
        args = _paged_case(dev, dtype, 3, h, hkv, d, 16, 16, 4, seed=d)
        before = dict(counts)
        da.decode_attention_paged_cuda(*args)
        assert counts[want] == before[want] + 1, (dtype, h, hkv, d)
    args = _paged_case(dev, torch.bfloat16, 3, 36, 4, 128, 16, 16, 4,
                       seed=1)
    forced = da.decode_attention_paged_cuda(*args, design="cuda_core")
    _close(forced, da.decode_attention_paged_cuda(*args), None)
    launches = da.decode_attention_paged_cuda.launches
    f32 = [x.float() if x.is_floating_point() else x for x in args]
    with pytest.raises(ValueError, match="split_kv design takes"):
        da.decode_attention_paged_cuda(*f32, design="split_kv")
    with pytest.raises(ValueError, match="pages_per_split"):
        da.decode_attention_paged_cuda(*f32, pages_per_split=2)
    assert da.decode_attention_paged_cuda.launches == launches


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
    q, k, v = _qkv(dev, dtype, b, sq, sk, h, hkv, d, seed=sq + sk + h)
    design = FT.design(dtype, d)
    before = fa.flash_attention_cuda.launches
    by_design = fa.flash_attention_cuda.launches_by_design[design]
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    assert fa.flash_attention_cuda.launches_by_design[design] == \
        by_design + 1
    ro, rlse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    assert o.dtype == dtype and lse.shape == (b * h, sq)
    if design == "wgmma":
        _close_wgmma(o, fa.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal, window=window))
    else:
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


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", [
    (1, 600, 600, 4, 2, 128, True, 0),     # ragged: S = 600
    (1, 1000, 600, 4, 1, 64, True, 0),     # Sq > Sk
    (1, 600, 1000, 4, 1, 128, True, 0),    # Sq < Sk
    (1, 1024, 1024, 36, 4, 128, True, 0),  # starcoder2-7b: G = 9
    (1, 2048, 2048, 25, 5, 64, True, 1024),  # hymba-1.5b: G = 5, window
    (2, 384, 384, 4, 2, 64, False, 100),   # a window without causal
])
def test_flash_wgmma_matches_plain(dev, b, sq, sk, h, hkv, d, causal,
                                   window):
    """bf16 K5 on the tensor cores against the fp32 oracle, with the lse
    within 1e-3."""
    q, k, v = _qkv(dev, torch.bfloat16, b, sq, sk, h, hkv, d, seed=sq + d)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    ro, rlse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=causal, window=window,
                                        return_lse=True)
    _close_wgmma(o, ro)
    np.testing.assert_allclose(lse.cpu().numpy(), rlse.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


def test_flash_wgmma_row_with_nothing_to_attend_is_nan(dev):
    """bf16 at D 64 (the wgmma design): Sq > Sk + window leaves late rows
    with no key, NaN with lse -inf, as the plain version; the rest within
    the wgmma limits."""
    q, k, v = _qkv(dev, torch.bfloat16, 1, 256, 64, 2, 2, 64, seed=3)
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=32,
                                     return_lse=True)
    ro, rlse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal=True, window=32,
                                        return_lse=True)
    _close_wgmma(o, ro)
    assert bool(torch.isnan(o[0, 200]).all())
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rlse))


def test_flash_dispatch_follows_the_design_table(dev):
    """bf16 at D 128 launches the wgmma design, float32 the CUDA-core one;
    bf16 forced onto the CUDA-core design computes the all-fp32 function
    (within one ulp of the oracle), and forcing wgmma on float32 raises
    before any launch."""
    counts = fa.flash_attention_cuda.launches_by_design
    q, k, v = _qkv(dev, torch.bfloat16, 1, 256, 256, 4, 2, 128, seed=5)
    before = dict(counts)
    fa.flash_attention_cuda(q, k, v)
    assert counts["wgmma"] == before["wgmma"] + 1
    assert counts["cuda_core"] == before["cuda_core"]
    o = fa.flash_attention_cuda(q, k, v, design="cuda_core")
    assert counts["cuda_core"] == before["cuda_core"] + 1
    _close(o, fa.flash_attention_plain(q.float(), k.float(), v.float()),
           None)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    fa.flash_attention_cuda(q32, k32, v32)
    assert counts["cuda_core"] == before["cuda_core"] + 2
    launches = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="wgmma design takes"):
        fa.flash_attention_cuda(q32, k32, v32, design="wgmma")
    assert fa.flash_attention_cuda.launches == launches


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
