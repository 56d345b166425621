"""K4's split-KV design on the CPU: its host-side plan and design table,
and a plain-torch emulation of its order of work held against the plain
version and the JAX package's oracle on the same numpy inputs.

The emulation follows ``csrc/decode_hopper.cu``: each split of
``split_plan``'s pages is cut into tiles of 64 positions, whose 16-position
quarters go to 4 warps; each warp keeps an online (m, l, acc) over its
positions, the block merges its warps, and the combine folds the splits
of each (row, head) in split order, skipping splits with m = -inf. It
runs in float32, as the kernel does, so it is held to the plain version
within rtol and atol 2e-5 (the sums run in another order), and to the
JAX oracle within the same. The kernel itself is held against the plain
version on the card (``tests/test_torch_attention_gpu.py``,
``chip_smoke.py`` phases 4-5)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as JR
from repro_torch.kernels import decode_attention as da

TILE, WARPS = 64, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emulate(q, kp, vp, table, lens, per):
    """K4's split-KV order of work in float32: q [B, H, D], pages
    [P, page, Hkv, D], table [B, pps], lens [B] -> [B, H, D]."""
    b, h, d = q.shape
    p, page, hkv, _ = kp.shape
    pps = table.shape[1]
    g = h // hkv
    per, n_split = da.split_plan(page, pps, per)
    split_tokens = per * page
    out = torch.full((b, h, d), float("nan"))
    for bi in range(b):
        n = min(int(lens[bi]), pps * page)
        used = -(-n // split_tokens) if n > 0 else 0
        assert used <= n_split
        for hk in range(hkv):
            qg = q[bi, hk * g:(hk + 1) * g].float()
            parts = []
            for s in range(used):
                start = s * split_tokens
                end = min(start + split_tokens, n)
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), float("-inf"))
                    l = torch.zeros(g)
                    acc = torch.zeros(g, d)
                    for t0 in range(start, end, TILE):
                        pos = [t0 + w * 16 + i for i in range(16)]
                        pos = [x for x in pos if x < end]
                        pages = [int(table[bi, x // page]) for x in pos]
                        keep = [(x, pg) for x, pg in zip(pos, pages)
                                if 0 <= pg < p]
                        if not keep:
                            continue
                        k = torch.stack([kp[pg, x % page, hk].float()
                                         for x, pg in keep])
                        v = torch.stack([vp[pg, x % page, hk].float()
                                         for x, pg in keep])
                        sc = qg @ k.T / math.sqrt(d)
                        mn = torch.maximum(m, sc.max(1).values)
                        c = torch.exp(m - mn)
                        pr = torch.exp(sc - mn[:, None])
                        l = l * c + pr.sum(1)
                        acc = acc * c[:, None] + pr @ v
                        m = mn
                    warps.append((m, l, acc))
                ms = torch.stack([x[0] for x in warps])
                big = ms.max(0).values
                fin = torch.isfinite(big)
                cs = torch.where(fin, torch.exp(ms - torch.where(
                    fin, big, 0.0)), 0.0)
                parts.append((big,
                              sum(cs[w] * warps[w][1] for w in range(WARPS)),
                              sum(cs[w][:, None] * warps[w][2]
                                  for w in range(WARPS))))
            for gi in range(g):
                live = [(m[gi], l[gi], a[gi]) for m, l, a in parts
                        if m[gi] != float("-inf")]
                if not live:
                    continue                  # NaN: nothing to attend to
                big = max(m for m, _, _ in live)
                lsum = sum(l * torch.exp(m - big) for m, l, _ in live)
                asum = sum(a * torch.exp(m - big) for m, _, a in live)
                out[bi, hk * g + gi] = asum / lsum
    return out


def _case(b, h, hkv, d, page, pps, seed):
    """numpy inputs: sequences ending inside a split, seq_len 0, a row
    whose first half of pages is -1 (splits with nothing to attend to),
    a -1 page inside a split, and a full row."""
    g = np.random.default_rng(seed)
    pages = b * pps + 3
    q = g.normal(size=(b, h, d)).astype(np.float32)
    kp = g.normal(size=(pages, page, hkv, d)).astype(np.float32)
    vp = g.normal(size=(pages, page, hkv, d)).astype(np.float32)
    table = g.permutation(pages)[:b * pps].reshape(b, pps).astype(np.int32)
    lens = g.integers(1, pps * page + 1, b).astype(np.int32)
    lens[0] = 0
    lens[1] = pps * page
    table[2, :pps // 2] = -1
    lens[2] = pps * page - page // 2
    table[3, pps // 3] = -1
    return q, kp, vp, table, lens


@pytest.mark.parametrize("page,pps,per,want", [
    (16, 520, None, (32, 17)),      # phase 4's table: 17 x 64 = 1,088 blocks
    (16, 12, None, (32, 1)),
    (8, 520, None, (64, 9)),
    (64, 30, None, (8, 4)),
    (1024, 3, None, (1, 3)),        # a page longer than a split
    (16, 40, 3, (3, 14)),
    (16, 40, 40, (40, 1)),
])
def test_split_plan(page, pps, per, want):
    got = da.split_plan(page, pps, per)
    assert got == want
    per_, n = got
    assert n * per_ >= pps > (n - 1) * per_


def test_split_plan_rejects_empty_runs():
    with pytest.raises(ValueError, match="pages_per_split"):
        da.split_plan(16, 40, 0)


@pytest.mark.parametrize("dtype,d,g,want", [
    (torch.bfloat16, 128, 9, "split_kv"),     # starcoder2-7b
    (torch.bfloat16, 64, 5, "split_kv"),      # hymba-1.5b
    (torch.bfloat16, 64, 16, "split_kv"),
    (torch.bfloat16, 128, 17, "cuda_core"),
    (torch.bfloat16, 32, 4, "cuda_core"),
    (torch.bfloat16, 256, 4, "cuda_core"),
    (torch.float32, 128, 9, "cuda_core"),
])
def test_decode_design_table(dtype, d, g, want):
    assert da.decode_design(dtype, d, g) == want
    assert da.decode_design(dtype, d, g, "cuda_core") == "cuda_core"
    if want == "cuda_core":
        with pytest.raises(ValueError, match="split_kv design takes"):
            da.decode_design(dtype, d, g, "split_kv")
    with pytest.raises(ValueError, match="none of"):
        da.decode_design(dtype, d, g, "wgmma")


@pytest.mark.parametrize("b,h,hkv,d,page,pps,per", [
    (5, 18, 2, 128, 16, 12, 2),     # starcoder2's G = 9 at D = 128
    (5, 18, 2, 128, 16, 12, None),  # one split: the plan at this width
    (5, 10, 2, 64, 16, 11, 3),      # hymba's G = 5 at D = 64
    (4, 5, 1, 64, 8, 13, 4),        # pages of 8, a ragged last split
])
def test_split_order_of_work_matches_plain_and_jax(b, h, hkv, d, page, pps,
                                                   per):
    q, kp, vp, table, lens = _case(b, h, hkv, d, page, pps, seed=h + d)
    args = [torch.from_numpy(x) for x in (q, kp, vp, table, lens)]
    got = _emulate(*args, per)
    plain = da.decode_attention_paged_plain(*args)
    jref = np.asarray(JR.ref_decode_attention_paged(
        *(jnp.asarray(x) for x in (q, kp, vp, table, lens))))
    assert bool(torch.isnan(got[0]).all())
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(jref))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), jref, rtol=2e-5, atol=2e-5)


def test_split_with_nothing_to_attend_adds_nothing():
    """A row whose early splits hold only -1 pages: those splits keep
    m = -inf and the combine skips them; the row equals attention over
    its resident positions alone."""
    q, kp, vp, table, lens = _case(4, 18, 2, 128, 16, 12, seed=7)
    table[1, :8] = -1                 # splits 0-3 of 2 pages: all masked
    args = [torch.from_numpy(x) for x in (q, kp, vp, table, lens)]
    got = _emulate(*args, 2)
    np.testing.assert_allclose(
        got[1].numpy(), da.decode_attention_paged_plain(*args)[1].numpy(),
        rtol=2e-5, atol=2e-5)
    table[1, :] = -1                  # nothing at all: NaN
    args[3] = torch.from_numpy(table)
    assert bool(torch.isnan(_emulate(*args, 2)[1]).all())
    assert bool(torch.isnan(da.decode_attention_paged_plain(*args)[1]).all())
