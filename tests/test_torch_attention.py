"""The port's attention entry points (K4 paged decode, K5 flash forward)
against the JAX package's, replaying the attention cases of
``tests/test_kernels.py`` and adding the group sizes of the serving
configs (starcoder2-7b G = 9, hymba-1.5b G = 5 with D = 64 and a window).

Here, on the CPU, the port's wrappers take their plain torch versions (they
choose by the tensor's device); the JAX side runs its Pallas kernels in
interpret mode, as its own tests do, or its ``ref`` oracle. The CUDA
kernels are held against the plain versions on the card
(``tests/test_torch_attention_gpu.py``, ``chip_smoke.py``).

Tolerances: float32 within rtol and atol 2e-5 (the JAX tests' own bound
between the Pallas kernel and the oracle: both compute in fp32 and sum in
another order); bfloat16 within 0.05 (the JAX test's bound: both round an
fp32 result to bf16, and the Pallas kernel feeds bf16 probabilities to its
second product); lse within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import (
    decode_attention_paged as j_decode, flash_attention as j_flash,
)
from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention_paged, flash_attention
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_plain,
)

F32 = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32))


# --------------------------------------------------------- flash attention
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (2, 256, 256, 4, 1, 128, False, 0),
    (1, 512, 512, 2, 2, 64, True, 128),
    (1, 128, 384, 2, 2, 64, False, 0),      # cross-attention shape
    (1, 128, 128, 18, 2, 128, True, 0),     # starcoder2-7b group: G = 9
    (1, 256, 256, 10, 2, 64, True, 64),     # hymba-1.5b: G = 5, window
]


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", FLASH_CASES)
def test_flash_attention_sweep(backend, b, sq, sk, h, hkv, d, causal,
                               window):
    rng = np.random.default_rng(sq + sk + h)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                          backend=backend)
    jo = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, window=window, backend="interpret",
                 block_q=128, block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=F32,
                               atol=F32)
    jr = JR.ref_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), rtol=F32,
                               atol=F32)


def test_flash_attention_bf16():
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(1, 128, 2, 64)).astype(np.float32)
               for _ in range(3))
    out = flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)))
    assert out.dtype == torch.bfloat16
    jo = j_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                 backend="interpret", block_q=64, block_k=64)
    np.testing.assert_allclose(_np(out), np.asarray(jo, np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", [
    (1, 128, 128, 2, 2, 64, True, 0),
    (1, 256, 256, 10, 2, 64, True, 64),
    (2, 128, 256, 18, 2, 128, False, 0),
])
def test_flash_attention_lse_matches_pallas(b, sq, sk, h, hkv, d, causal,
                                            window):
    """The log-sum-exp keeps the JAX layout [B*H, Sq] in (b, hkv, g)
    order: the backward (K6) reads it."""
    rng = np.random.default_rng(h * d)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    o, lse = flash_attention_cuda(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, return_lse=True)
    jo, jlse = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=128, block_k=128, interpret=True,
        return_lse=True)
    assert lse.shape == (b * h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=F32,
                               atol=F32)


def test_flash_attention_widths_come_from_the_configs():
    """The serving configs' attention widths, taken from the port's
    config registry, are what the kernel is instantiated for."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    sc, hy = get_config("starcoder2-7b"), get_config("hymba-1.5b")
    assert (sc.num_heads, sc.num_kv_heads, sc.resolved_head_dim) == \
        (36, 4, 128)
    assert (hy.num_heads, hy.num_kv_heads, hy.resolved_head_dim,
            hy.attn_window) == (25, 5, 64, 1024)
    assert {sc.resolved_head_dim, hy.resolved_head_dim} <= set(HEAD_DIMS)


def test_flash_attention_backward_holds_the_gradient():
    """``.backward`` through the forward wrapper goes through K6 (its plain
    version on the CPU) and gives the gradient of autograd through the
    float32 oracle, GQA group sums included."""
    rng = np.random.default_rng(4)
    shapes = ((1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch.autograd.grad(flash_attention_cuda(*leaves).square().sum(),
                              leaves)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    want = torch.autograd.grad(
        TR.ref_flash_attention(*leaves).square().sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F32, atol=F32)


def test_flash_attention_block_sizes_are_not_read():
    rng = np.random.default_rng(1)
    q = _t(rng.normal(size=(1, 96, 2, 32)).astype(np.float32))
    a = flash_attention(q, q, q, block_q=512, block_k=512)
    b = flash_attention(q, q, q, block_q=32, block_k=16)
    assert torch.equal(a, b)


# ------------------------------------------------------ paged decode attn
def _paged_case(rng, b, h, hkv, d, pages, page, pps, dtype=np.float32):
    q = rng.normal(size=(b, h, d)).astype(dtype)
    kp = rng.normal(size=(pages, page, hkv, d)).astype(dtype)
    vp = rng.normal(size=(pages, page, hkv, d)).astype(dtype)
    table = np.full((b, pps), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    perm = rng.permutation(pages)
    c = 0
    for i in range(b):
        used = rng.integers(1, pps + 1)
        table[i, :used] = perm[c:c + used]
        c += used
        lens[i] = rng.integers(1, used * page + 1)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("b,h,hkv,d,pages,page,pps", [
    (2, 4, 2, 64, 8, 16, 3),
    (3, 8, 2, 64, 16, 32, 4),
    (1, 8, 8, 128, 8, 64, 2),
    (4, 36, 4, 128, 64, 16, 12),            # starcoder2-7b: G = 9
    (4, 25, 5, 64, 64, 16, 12),             # hymba-1.5b: G = 5
    (2, 4, 1, 32, 8, 8, 4),                 # hkv = 1
])
def test_decode_attention_paged_sweep(backend, b, h, hkv, d, pages, page,
                                      pps):
    rng = np.random.default_rng(b * h + d)
    q, kp, vp, table, lens = _paged_case(rng, b, h, hkv, d, pages, page, pps)
    out = decode_attention_paged(_t(q), _t(kp), _t(vp), _t(table),
                                 _t(lens), backend=backend)
    jo = j_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(table), jnp.asarray(lens), backend="interpret")
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=F32,
                               atol=F32)


def test_decode_attention_paged_bf16():
    rng = np.random.default_rng(9)
    q, kp, vp, table, lens = _paged_case(rng, 4, 36, 4, 128, 64, 16, 12)
    out = decode_attention_paged(
        *(_t(x).to(torch.bfloat16) for x in (q, kp, vp)), _t(table),
        _t(lens))
    assert out.dtype == torch.bfloat16
    jo = j_decode(*(jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp)),
                  jnp.asarray(table), jnp.asarray(lens), backend="interpret")
    np.testing.assert_allclose(_np(out), np.asarray(jo, np.float32),
                               rtol=0.05, atol=0.05)


def test_decode_minus_one_page_inside_seq_len_follows_ref():
    """A -1 page inside ``seq_len`` contributes nothing, as in the JAX
    ``ref`` oracle. The JAX Pallas wrapper clamps the table to >= 0
    (``decode_attention.py:83``), so its kernel reads such a page as page
    0; the port follows ``ref``, and so does its CUDA kernel. The serving
    path produces such tables when its victim policy evicts a page of the
    batch it is launching (ROADMAP, Queue 3)."""
    rng = np.random.default_rng(11)
    q, kp, vp, table, lens = _paged_case(rng, 3, 8, 2, 64, 16, 16, 4)
    table[0, :] = [3, -1, 5, -1]
    lens[0] = 60                             # pages 1 and 3 inside seq_len
    table[1, 1] = -1
    lens[1] = max(lens[1], 20)
    out = decode_attention_paged(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    jr = JR.ref_decode_attention_paged(jnp.asarray(q), jnp.asarray(kp),
                                       jnp.asarray(vp), jnp.asarray(table),
                                       jnp.asarray(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(jr), rtol=F32,
                               atol=F32)
    jp = j_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(table), jnp.asarray(lens), backend="interpret")
    assert not np.allclose(out.numpy()[0], np.asarray(jp)[0], atol=1e-3)


def test_decode_empty_sequence_is_nan_as_ref():
    """A ``seq_len == 0`` row is a softmax over nothing: NaN in the JAX
    ``ref`` and in the port (the Pallas kernel gives the mean of page 0's
    values instead)."""
    rng = np.random.default_rng(12)
    q, kp, vp, table, lens = _paged_case(rng, 2, 4, 2, 32, 8, 8, 3)
    lens[1] = 0
    out = decode_attention_paged(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    jr = JR.ref_decode_attention_paged(jnp.asarray(q), jnp.asarray(kp),
                                       jnp.asarray(vp), jnp.asarray(table),
                                       jnp.asarray(lens))
    assert np.isnan(out.numpy()[1]).all() and np.isnan(np.asarray(jr)[1]).all()
    np.testing.assert_allclose(out.numpy()[0], np.asarray(jr)[0], rtol=F32,
                               atol=F32)


def test_decode_oracle_is_the_plain_version():
    rng = np.random.default_rng(13)
    args = [_t(x) for x in _paged_case(rng, 2, 4, 2, 32, 8, 8, 3)]
    assert torch.equal(decode_attention_paged(*args),
                       TR.ref_decode_attention_paged(*args))
    q = _t(rng.normal(size=(1, 64, 4, 32)).astype(np.float32))
    assert torch.equal(flash_attention(q, q[:, :, :2], q[:, :, :2]),
                       flash_attention_plain(q, q[:, :, :2].contiguous(),
                                             q[:, :, :2].contiguous()))


def test_attention_array_inputs_default_to_the_card():
    """Array-likes go to ``device``, which defaults to the card; on a
    machine without CUDA that raises rather than running on the CPU."""
    q = np.ones((1, 2, 32), np.float32)
    kp = np.ones((2, 4, 1, 32), np.float32)
    table = np.zeros((1, 1), np.int32)
    lens = np.ones(1, np.int32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            decode_attention_paged(q, kp, kp, table, lens)
    out = decode_attention_paged(q, kp, kp, table, lens, device="cpu")
    np.testing.assert_allclose(out.numpy(), np.ones((1, 2, 32)), rtol=1e-6)
    with pytest.raises(ValueError):
        flash_attention(np.ones((1, 4, 2, 32), np.float32),
                        np.ones((1, 4, 2, 32), np.float32),
                        np.ones((1, 4, 2, 32), np.float32),
                        backend="pallas", device="cpu")


@pytest.mark.parametrize("moved", ["q", "block_table", "seq_lens"])
def test_decode_runs_on_the_pool_device_and_never_moves_it(moved):
    """The pool fixes the device: a query, table or lengths tensor on
    another device raises instead of copying the pool after it (here the
    pool is on ``meta``, which holds no data, and the rest on the CPU)."""
    cpu = dict(q=torch.ones((1, 2, 32)),
               block_table=torch.zeros((1, 1), dtype=torch.int32),
               seq_lens=torch.ones(1, dtype=torch.int32))
    kp = torch.empty((2, 4, 1, 32), device="meta")
    args = {k: v.to("meta") for k, v in cpu.items()}
    args.update(k_pages=kp, v_pages=kp)
    args[moved] = cpu[moved]
    q = cpu["q"]
    with pytest.raises(ValueError, match=f"{moved} is on cpu"):
        decode_attention_paged(**args)
    with pytest.raises(ValueError, match="asked for"):
        decode_attention_paged(q, torch.ones((2, 4, 1, 32)),
                               torch.ones((2, 4, 1, 32)),
                               np.zeros((1, 1), np.int32), np.ones(1),
                               device="meta")


def test_flash_runs_on_the_kv_device():
    q = torch.ones((1, 4, 2, 32))
    kv = torch.empty((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError, match="q is on cpu"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="v is on cpu"):
        flash_attention(q.to("meta"), kv, q)
    out = flash_attention(q.numpy(), q, q)       # array-likes join the K/V
    assert torch.equal(out, flash_attention_plain(q, q, q))


def test_attention_library_build_raises_without_nvcc(monkeypatch):
    """Each source builds into a library of its own; where no nvcc exists
    the build raises with the reason, never falls back."""
    from repro_torch.kernels import _build
    assert set(_build.SIGNATURES) == {"segment_aggregate.cu",
                                      "attention.cu",
                                      "flash_attention_bwd.cu",
                                      "flash_fwd_hopper.cu",
                                      "flash_bwd_hopper.cu",
                                      "ssd_scan.cu",
                                      "ssd_hopper.cu",
                                      "decode_hopper.cu",
                                      "segment_splitk.cu"}
    assert {"decode_attention_paged", "flash_attention_fwd"} == \
        set(_build.SIGNATURES["attention.cu"])
    assert {"flash_attention_bwd"} == \
        set(_build.SIGNATURES["flash_attention_bwd.cu"])
    assert {"flash_fwd_wgmma"} == \
        set(_build.SIGNATURES["flash_fwd_hopper.cu"])
    assert {"flash_bwd_wgmma"} == \
        set(_build.SIGNATURES["flash_bwd_hopper.cu"])
    assert {"ssd_scan"} == set(_build.SIGNATURES["ssd_scan.cu"])
    assert {"ssd_tensor"} == set(_build.SIGNATURES["ssd_hopper.cu"])
    assert {"seg_agg_splitk_smem", "seg_agg_block_table_smem",
            "seg_agg_flat_smem"} == \
        set(_build.SIGNATURES["segment_splitk.cu"])
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "BUILD_DIR",
                        _build.BUILD_DIR.parent / "nonexistent-kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("attention.cu")
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build.library("moe.cu")


# ------------------------------------ the model's attention block (models/)
def _attn_pair(hkv: int):
    """The attention block's parameters drawn by the JAX ``attn_init`` at
    the reduced seamless-m4t-medium's width (d 256, 4 heads of 64) with
    ``hkv`` KV heads, for both packages, and its configs."""
    import dataclasses
    import jax
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import attention as JA
    from repro_torch.configs import reduced
    kw = dict(num_kv_heads=hkv, compute_dtype="float32")
    jcfg = dataclasses.replace(j_reduced(j_get_config(
        "seamless-m4t-medium")), **kw)
    tcfg = dataclasses.replace(reduced(get_config("seamless-m4t-medium")),
                               **kw)
    jp, _ = JA.attn_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("kv_repeat,hkv", [(1, 4), (2, 2), (2, 1)])
def test_attn_forward_self_and_cross_match_jax(kv_repeat, hkv):
    """``models/attention.attn_forward`` against the JAX function in
    float32: causal self-attention with ``kv_repeat`` (the stored K/V
    repeated on the head axis, as ``jnp.repeat``), and cross-attention of
    24 decoder positions onto 16 frames' K/V (q RoPE'd at the decoder's
    positions, K/V taken as they come, non-causal: Sq != Sk through K5's
    plain version). ``kv_valid_len`` raises."""
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    jcfg, tcfg, jp, tp = _attn_pair(hkv)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 24, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    hs = hkv * kv_repeat
    ck = rng.normal(size=(2, 16, hs, 64)).astype(np.float32)
    cv = rng.normal(size=(2, 16, hs, 64)).astype(np.float32)
    jy, (jk, jv) = JA.attn_forward(jp, jnp.asarray(x), jcfg,
                                   positions=jnp.asarray(pos),
                                   kv_repeat=kv_repeat, return_kv=True)
    ty, (tk, tv) = TA.attn_forward(tp, _t(x), tcfg, positions=_t(pos),
                                   kv_repeat=kv_repeat, return_kv=True)
    assert tuple(tk.shape) == jk.shape == (2, 24, hs, 64)
    for a, b in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32, atol=F32)
    jy, jkv = JA.attn_forward(jp, jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos), causal=False,
                              xattn_kv=(jnp.asarray(ck), jnp.asarray(cv)))
    ty, tkv = TA.attn_forward(tp, _t(x), tcfg, positions=_t(pos),
                              causal=False, xattn_kv=(_t(ck), _t(cv)))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=F32, atol=F32)
    assert tkv[0] is not None and jkv is not None
    # q at other positions gives another result: the RoPE is applied
    moved, _ = TA.attn_forward(tp, _t(x), tcfg, positions=_t(pos + 7),
                               causal=False, xattn_kv=(_t(ck), _t(cv)))
    assert float((moved - ty).abs().max()) > 1e-3
    with pytest.raises(NotImplementedError, match="kv_valid_len"):
        TA.attn_forward(tp, _t(x), tcfg, positions=_t(pos), causal=False,
                        xattn_kv=(_t(ck), _t(cv)),
                        kv_valid_len=torch.full((2,), 8))


@pytest.mark.parametrize("kv_repeat,hkv", [(1, 4), (2, 2)])
@pytest.mark.parametrize("xattn_len", [None, (16, 9)])
def test_attn_decode_self_and_cross_match_jax(kv_repeat, hkv, xattn_len):
    """``attn_decode`` against the JAX function in float32: a cache
    decode at position 11 with ``kv_repeat`` (the new K/V repeated before
    the write; the written cache against JAX's), and a cross-attention
    decode against 16 frames masked to ``xattn_len`` valid frames a row
    (q RoPE'd at the position; the caches neither read nor written). A
    frame past a row's length changes nothing there."""
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    jcfg, tcfg, jp, tp = _attn_pair(hkv)
    rng = np.random.default_rng(6)
    hs = hkv * kv_repeat
    x = rng.normal(size=(2, 1, 256)).astype(np.float32)
    kc = rng.normal(size=(2, 20, hs, 64)).astype(np.float32)
    vc = rng.normal(size=(2, 20, hs, 64)).astype(np.float32)
    jy, jk, jv, _ = JA.attn_decode(jp, jnp.asarray(x), jcfg,
                                   cache_k=jnp.asarray(kc),
                                   cache_v=jnp.asarray(vc), cache_pos=11,
                                   kv_repeat=kv_repeat)
    tk, tv = _t(kc.copy()), _t(vc.copy())
    ty, tk, tv, _ = TA.attn_decode(tp, _t(x), tcfg, cache_k=tk, cache_v=tv,
                                   cache_pos=11, kv_repeat=kv_repeat)
    for a, b in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=F32, atol=F32)
    jlen = None if xattn_len is None else jnp.asarray(xattn_len, jnp.int32)
    tlen = None if xattn_len is None else torch.tensor(xattn_len)
    ck, cv = kc[:, :16], vc[:, :16]
    jy, *_ = JA.attn_decode(jp, jnp.asarray(x), jcfg, cache_k=None,
                            cache_v=None, cache_pos=11,
                            xattn_kv=(jnp.asarray(ck), jnp.asarray(cv)),
                            xattn_len=jlen)
    ty, tk, tv, sc = TA.attn_decode(tp, _t(x), tcfg, cache_k=None,
                                    cache_v=None, cache_pos=11,
                                    xattn_kv=(_t(ck), _t(cv)),
                                    xattn_len=tlen)
    assert tk is None and tv is None and sc is None
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=F32, atol=F32)
    if xattn_len is not None:
        cv2 = cv.copy()
        cv2[:, 9:] += 1.0
        ty2, *_ = TA.attn_decode(tp, _t(x), tcfg, cache_k=None,
                                 cache_v=None, cache_pos=11,
                                 xattn_kv=(_t(ck), _t(cv2)), xattn_len=tlen)
        assert torch.equal(ty2[1], ty[1])
        assert not torch.equal(ty2[0], ty[0])
