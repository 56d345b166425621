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
from hypothesis import given, settings
from hypothesis import strategies as st

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
    plain version). The per-row key length is held in
    ``test_attn_forward_with_kv_valid_len_matches_jax``."""
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


#: ``attn_forward`` with a per-row key length: (case, kv_repeat, KV heads,
#: window, lengths); "cross" attends 16 frames
KV_LEN_CASES = [("causal", 1, 4, 0, (24, 13)),
                ("repeat", 2, 2, 0, (24, 13)),
                ("window", 1, 4, 8, (24, 20)),
                ("cross", 1, 4, 0, (16, 9))]


@pytest.mark.parametrize("case,kv_repeat,hkv,window,lens", KV_LEN_CASES)
def test_attn_forward_with_kv_valid_len_matches_jax(case, kv_repeat, hkv,
                                                    window, lens):
    """``attn_forward`` with ``kv_valid_len`` (K5/K6's per-row key length;
    their plain versions here) against the JAX function
    (``blocked_attention``'s padding mask) in float32: causal
    self-attention with lengths (24, 13), with ``kv_repeat`` 2, under a
    window of 8 with lengths that leave no row empty, and
    cross-attention over 16 frames with lengths (16, 9). The output and
    the gradients of the summed squares with respect to x and every
    parameter (and the cross K/V) meet ``jax.grad``'s within F32: rtol
    F32, and atol F32 of the gradient's largest magnitude where that
    passes 1 (a weight's gradient sums 48 rows: 2e-5 of values up to 23,
    as ``test_torch_models.py`` scales its atol); the gradients of the
    keys past a row's length are exactly 0."""
    import jax
    from repro.models import attention as JA
    from repro_torch.models import attention as TA
    jcfg, tcfg, jp, tp = _attn_pair(hkv)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 24, 256)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    hs = hkv * kv_repeat
    ck = rng.normal(size=(2, 16, hs, 64)).astype(np.float32)
    cv = rng.normal(size=(2, 16, hs, 64)).astype(np.float32)
    cross = case == "cross"
    kw = dict(kv_repeat=kv_repeat, window=window, causal=not cross)

    def jloss(p, x, ck, cv):
        y, _ = JA.attn_forward(p, x, jcfg, positions=jnp.asarray(pos),
                               xattn_kv=(ck, cv) if cross else None,
                               kv_valid_len=jnp.asarray(lens, jnp.int32),
                               **kw)
        return jnp.sum(y * y), y
    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv))
    leaves = {"x": _t(x), "ck": _t(ck), "cv": _t(cv),
              **{f"{a}.{b}": t for a, sub in tp.items()
                 for b, t in sub.items()}}
    leaves = {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
    params = {a: {b: leaves[f"{a}.{b}"] for b in sub}
              for a, sub in tp.items()}
    ty, _ = TA.attn_forward(params, leaves["x"], tcfg, positions=_t(pos),
                            xattn_kv=(leaves["ck"], leaves["cv"])
                            if cross else None,
                            kv_valid_len=torch.tensor(lens), **kw)
    np.testing.assert_allclose(_np(ty.detach()), _np(jy), rtol=F32,
                               atol=F32)
    # cross-attention takes the K/V as given: its k and v weights are unused
    used = [n for n in leaves if (n.split(".")[0] not in ("k", "v")
                                  if cross else n not in ("ck", "cv"))]
    got = dict(zip(used, torch.autograd.grad(
        ty.square().sum(), [leaves[n] for n in used])))
    want = {"x": jg[1], "ck": jg[2], "cv": jg[3],
            **{f"{a}.{b}": jg[0][a][b] for a, sub in tp.items()
               for b in sub}}
    for n, g in got.items():
        w = np.asarray(want[n])
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(_np(g), w, rtol=F32, atol=F32 * scale,
                                   err_msg=n)
    if cross:
        for n in ("ck", "cv"):
            for b, n_valid in enumerate(lens):
                assert torch.equal(got[n][b, n_valid:],
                                   torch.zeros_like(got[n][b, n_valid:]))
            assert float(got[n][1, :lens[1]].abs().max()) > 0


def test_a_row_with_no_key_is_nan_in_the_port_and_finite_in_jax():
    """ROADMAP Queue 3, item 27: a row whose length is 0 has nothing to
    attend to. K5 and its plain version give NaN there (an lse of -inf),
    the port's rule (Queue 3, item 12); JAX masks with a finite -1e30,
    so its row is a weighting of V over the blocks it scanned. The other
    row meets JAX's; K6 gives the empty row's query and its keys no
    gradient."""
    from repro.models.attention import blocked_attention
    from repro_torch.kernels.ops import flash_attention_vjp
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(2, 16, 2, 32)).astype(np.float32)
               for _ in range(3))
    lens = (0, 11)
    jo = np.asarray(blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        kv_valid_len=jnp.asarray(lens, jnp.int32)))
    o, lse = flash_attention_cuda(_t(q), _t(k), _t(v), causal=False,
                                  return_lse=True,
                                  kv_valid_len=torch.tensor(lens))
    assert bool(torch.isnan(o[0]).all()) and np.isfinite(jo[0]).all()
    assert bool(torch.isinf(lse[:2]).all()) and bool((lse[:2] < 0).all())
    np.testing.assert_allclose(_np(o[1]), jo[1], rtol=F32, atol=F32)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention_vjp(*leaves, causal=False, kv_valid_len=lens)
    dq, dk, dv = torch.autograd.grad(out[1].sum(), leaves)
    for g in (dq[0], dk[0], dv[0], dk[1, 11:], dv[1, 11:]):
        assert torch.equal(g, torch.zeros_like(g))


@settings(max_examples=25, deadline=None)
@given(lens=st.lists(st.integers(0, 18), min_size=2, max_size=2),
       causal=st.booleans(), window=st.sampled_from([0, 5]))
def test_plain_flash_with_lengths_is_attention_over_each_rows_keys(
        lens, causal, window):
    """K5's and K6's plain versions with a per-row key length (0..Sk + 2,
    Sk = 16) against ``ref``'s masks without one, row by row on the
    row's first ``min(len, Sk)`` keys: o, lse, dq, and dk/dv of those keys
    equal; the keys past the length get exactly 0; a row of length 0 is
    NaN with lse -inf and gets no gradient."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_plain,
    )
    rng = np.random.default_rng(sum(lens) + 31 * causal + window)
    sq, sk, h, hkv, d = 12, 16, 4, 2, 32
    q = _t(rng.normal(size=(2, sq, h, d)).astype(np.float32))
    k, v = (_t(rng.normal(size=(2, sk, hkv, d)).astype(np.float32))
            for _ in range(2))
    do = _t(rng.normal(size=(2, sq, h, d)).astype(np.float32))
    kw = dict(causal=causal, window=window)
    n = torch.tensor(lens, dtype=torch.int32)
    o, lse = flash_attention_plain(q, k, v, return_lse=True,
                                   kv_valid_len=n, **kw)
    grads = flash_attention_bwd_plain(q, k, v, o, do, lse, kv_valid_len=n,
                                      **kw)
    lse = lse.reshape(2, h, sq)
    for b, n_b in enumerate(lens):
        m = min(n_b, sk)
        if m == 0:
            assert bool(torch.isnan(o[b]).all())
            assert bool(torch.isneginf(lse[b]).all())
            for g in grads:
                assert torch.equal(g[b], torch.zeros_like(g[b]))
            continue
        ro, rl = TR.ref_flash_attention(q[b:b + 1], k[b:b + 1, :m],
                                        v[b:b + 1, :m], return_lse=True,
                                        **kw)
        nan = torch.isnan(ro[0])
        assert torch.equal(torch.isnan(o[b]), nan)
        np.testing.assert_allclose(o[b][~nan].numpy(), ro[0][~nan].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(lse[b].numpy(), rl.reshape(h, sq).numpy(),
                                   rtol=1e-6, atol=1e-6)
        rq, rk, rv = flash_attention_bwd_plain(
            q[b:b + 1], k[b:b + 1, :m].contiguous(),
            v[b:b + 1, :m].contiguous(), ro, do[b:b + 1], rl, **kw)
        for got, want in ((grads[0][b], rq[0]), (grads[1][b, :m], rk[0]),
                          (grads[2][b, :m], rv[0])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)
        for g in grads[1:]:
            assert torch.equal(g[b, m:], torch.zeros_like(g[b, m:]))


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
