"""The encoder-decoder families (``FAMILY_AUDIO``, seamless-m4t-medium's,
and ``FAMILY_ENCDEC``, the same reduced config with the family renamed)
in the port against the JAX package, on the same numpy inputs, with the
JAX weights carried across by ``convert.model_params_from_jax`` and JAX
caches by ``convert.model_cache_from_jax``: the encoder, the cross K/V,
``train_logits``, the loss and every gradient (the encoder's and the
cross-attention's included), the remat modes, the prefill cache
(``k``, ``v``, ``cross_k``, ``cross_v``), ``decode_step``, the int8 cache
and ``kv_repeat``.

Here, on the CPU, the port's attention takes K5's and K6's plain
versions (the cross-attention non-causal, Sq != Sk); the JAX model runs
``blocked_attention`` under its own autodiff.

Tolerances are those of ``test_torch_models.py`` and
``test_torch_serve_model.py``. In float32: logits within atol 1e-4, the
loss within 1e-5, every gradient within rtol 1e-3 and atol 1e-5 x its
largest |value|, cache leaves within rtol and atol 1e-5 (the same fp32
arithmetic in another order). In bf16 (the configs' own compute type):
the loss within 2e-2 of the JAX bf16 loss, each gradient within 5% of
its norm of the JAX float32 gradient, cache leaves within 2% of their
norm and 4 bf16 ulps (8 for float32 leaves) of their largest |value|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models import transformer as TT

ARCH = "seamless-m4t-medium"
FAMILIES = ["audio", "encdec"]



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the tests run
    many small operations, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(family="audio", dtype="float32", *, grad=False, **build):
    """Both models of the reduced seamless-m4t-medium (2 encoder and 2
    decoder layers, 4 heads of 64, 16 frames) with ``family`` and the
    compute type ``dtype``, the JAX weights in each. ``build`` goes to
    both ``build_model``s, except ``cfg``: fields of the config."""
    kw = dict(family=family, compute_dtype=dtype, **build.pop("cfg", {}))
    jcfg = dataclasses.replace(j_reduced(j_get_config(ARCH)), **kw)
    tcfg = dataclasses.replace(reduced(get_config(ARCH)), **kw)
    jm = j_build_model(jcfg, **build)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu", **build)
    tparams = convert.model_params_from_jax(jax.tree.map(np.asarray,
                                                         jparams))
    if grad:
        tparams = {n: t.requires_grad_(True) for n, t in tparams.items()}
    return jcfg, jm, jparams, tm, tparams


def _batch(cfg, b=2, s=32, seed=0):
    """Tokens, targets and the stub frame embeddings (normal x 0.02, as
    the JAX smoke test draws them) from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "frame_embeds": (rng.normal(size=(b, cfg.frontend_tokens,
                                              cfg.d_model)) * 0.02)
            .astype(np.float32)}


def _both(batch, keys=None):
    keys = keys or batch
    return ({k: jnp.asarray(batch[k]) for k in keys},
            {k: torch.from_numpy(batch[k]) for k in keys})


def _grads(jm, jparams, tm, tparams, batch):
    jb, tb = _both(batch)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, jb)
    tl, tmet = tm.loss(tparams, tb)
    tg = dict(zip(tparams, torch.autograd.grad(tl, list(tparams.values()))))
    jg = convert.model_params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jg) == set(tg)
    return (float(jl), jmet), (float(tl.detach()), tmet), jg, tg


def _assert_grads_f32(jg, tg):
    for name in jg:
        scale = float(jg[name].abs().max())
        np.testing.assert_allclose(_np(tg[name]), _np(jg[name]), rtol=1e-3,
                                   atol=1e-5 * max(scale, 1e-3),
                                   err_msg=name)


def _close(got, want, dtype):
    a, b = _np(got), _np(want)
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        return
    assert np.linalg.norm(a - b) <= 0.02 * np.linalg.norm(b)
    top = float(np.abs(b).max())
    ulp = 2.0 ** (np.floor(np.log2(max(top, 2.0 ** -10))) - 7)
    wide = got.dtype == torch.float32 and np.asarray(want).dtype == \
        np.float32
    assert float(np.abs(a - b).max()) <= (8 if wide else 4) * ulp


def _logits_close(got, want, vocab, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got)[..., :vocab],
                                   _np(want)[..., :vocab], rtol=0,
                                   atol=1e-4)
    else:
        _close(got[..., :vocab], want[..., :vocab], dtype)


# ------------------------------------------------------- the parameters
@pytest.mark.parametrize("family", FAMILIES)
def test_init_draws_the_jax_tree(family):
    """``init`` gives every leaf of the JAX tree in its shape: the decoder
    layers with ``ln_x`` and ``xattn``, the encoder's layers without,
    ``enc_norm``; the names are those of the JAX tree flattened."""
    jcfg, jm, jp, tm, tp = _pair(family)
    params = tm.init(torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: tuple(t.shape) for n, t in tp.items()}
    names = set(params)
    assert "enc_norm.scale" in names
    for i in range(jcfg.num_layers):
        assert {f"layers.{i}.ln_x.scale",
                f"layers.{i}.xattn.k.w"} <= names
    for i in range(jcfg.encoder_layers):
        assert f"encoder.{i}.attn.q.w" in names
        assert not any(n.startswith(f"encoder.{i}.xattn") for n in names)


def test_split_refuses_a_name_under_no_head():
    """A parameter outside embed, layers, encoder, enc_norm and
    final_norm raises instead of being dropped (it would get no gradient
    and no update)."""
    _, _, _, tm, tp = _pair()
    with pytest.raises(KeyError, match="under no head"):
        tm.train_logits({**tp, "decoder.0.ln1.scale": tp["enc_norm.scale"]},
                        _both(_batch(tm.cfg))[1])


# ------------------------------------------------------------ the encoder
def test_encoder_and_cross_kv_match_jax():
    """``_encode`` (bidirectional, ``enc_norm``) and ``_cross_kv`` (every
    decoder layer's K RoPE'd at the encoder's positions, V as projected)
    against the JAX functions, in float32."""
    jcfg, jm, jp, tm, tp = _pair()
    jb, tb = _both(_batch(jcfg), ("frame_embeds",))
    jenc = jm._encode(jp, jb)
    tree = tm._split(tp)
    tenc = tm._encode(tree, tb)
    np.testing.assert_allclose(_np(tenc), _np(jenc), rtol=1e-5, atol=1e-5)
    jk, jv = jm._cross_kv(jp, jenc)
    tkv = tm._cross_kv(tree, torch.from_numpy(np.array(jenc)))
    assert len(tkv) == jcfg.num_layers
    for i, (k, v) in enumerate(tkv):
        np.testing.assert_allclose(_np(k), _np(jk[i]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(v), _np(jv[i]), rtol=1e-5, atol=1e-5)


def test_encoder_attention_is_bidirectional():
    """A change to the last frame moves the encoder's output at the first
    frame (its attention is not causal), in both packages alike."""
    jcfg, jm, jp, tm, tp = _pair()
    batch = _batch(jcfg)
    moved = dict(batch, frame_embeds=batch["frame_embeds"].copy())
    moved["frame_embeds"][:, -1] += 0.5
    tree = tm._split(tp)
    outs = [tm._encode(tree, _both(b, ("frame_embeds",))[1])
            for b in (batch, moved)]
    assert float((outs[0][:, 0] - outs[1][:, 0]).abs().max()) > 1e-3
    jout = jm._encode(jp, _both(moved, ("frame_embeds",))[0])
    np.testing.assert_allclose(_np(outs[1]), _np(jout), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------- training
@pytest.mark.parametrize("family", FAMILIES)
def test_model_matches_jax_float32(family):
    """train_logits, the loss and every parameter's gradient (the
    encoder's, ``enc_norm``'s and each decoder layer's ``xattn`` and
    ``ln_x`` included; the name sets equal to JAX's flattened tree)
    against jax.value_and_grad(model.loss)."""
    jcfg, jm, jp, tm, tp = _pair(family, grad=True)
    batch = _batch(jcfg)
    jb, tb = _both(batch)
    jlog, _ = jm.train_logits(jp, jb)
    tlog, aux = tm.train_logits(tp, tb)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=0, atol=1e-4)
    (jl, jmet), (tl, tmet), jg, tg = _grads(jm, jp, tm, tp, batch)
    assert abs(jl - tl) <= 1e-5
    assert float(tmet["ntok"]) == float(jmet["ntok"]) == 64.0
    assert {n for n in jg if n.startswith("encoder.")}
    assert all(float(tg[n].abs().max()) > 0 for n in tg
               if n.startswith(("encoder.", "enc_norm.")) or ".xattn." in n)
    _assert_grads_f32(jg, tg)


@pytest.mark.parametrize("remat,group", [
    ("none", 0), ("full", 0), ("dots", 0), ("none", 2), ("full", 2)],
    ids=["none", "full", "dots", "none-g2", "full-g2"])
def test_remat_policies_match_jax(remat, group):
    """The audio model with 4 decoder layers under each ``remat`` and
    two-level remat (``remat_group=2``: the decoder layers with their
    cross K/V in two outer checkpoints; the encoder is never regrouped)
    against the JAX model built the same way, in float32. Checkpoints:
    each encoder layer's and decoder layer's under ``remat``, again for
    the decoder layers where an outer group checkpoint recomputes."""
    jcfg, jm, jp, tm, tp = _pair(grad=True, remat_group=group,
                                 cfg=dict(remat=remat, num_layers=4))
    calls = []
    real = TT.checkpoint

    def spy(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)

    TT.checkpoint = spy
    try:
        (jl, _), (tl, _), jg, tg = _grads(jm, jp, tm, tp, _batch(jcfg))
    finally:
        TT.checkpoint = real
    per_layer = 0 if remat == "none" else 1
    dec = 4 * per_layer * (2 if group else 1)
    enc = jcfg.encoder_layers * per_layer
    assert len(calls) == (2 if group else 0) + dec + enc
    assert abs(jl - tl) <= 1e-5
    _assert_grads_f32(jg, tg)


@pytest.mark.parametrize("family", FAMILIES)
def test_model_bf16_within_jax_float32(family):
    """In bf16 compute: the loss within 2e-2 of the JAX bf16 loss and each
    gradient within 5% of its norm of the JAX float32 gradient (the
    reference that does not round), the encoder's included."""
    jcfg, jm, jp, tm, tp = _pair(family, "bfloat16", grad=True)
    batch = _batch(jcfg)
    jb, tb = _both(batch)
    jl = float(jax.jit(jm.loss)(jp, jb)[0])
    tl, _ = tm.loss(tp, tb)
    assert abs(jl - float(tl.detach())) <= 2e-2
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    jm32 = j_build_model(dataclasses.replace(jcfg, compute_dtype="float32"))
    jg = convert.model_params_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(lambda p: jm32.loss(p, jb)[0]))(jp)))
    assert set(jg) == set(tg)
    for name in jg:
        a, b = _np(tg[name]), _np(jg[name])
        assert np.isfinite(a).all(), name
        assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b), name


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_the_jax_cache(dtype):
    """Every leaf of ``init_cache`` (``cross_k``/``cross_v`` [L, B, F, Hs,
    dh] in the compute type beside the self-attention K/V) in the JAX
    name, shape and dtype, all zero; under ``kv_cache_bits=8`` the cross
    K/V stay in the compute type."""
    for bits in (16, 8):
        _, jm, _, tm, _ = _pair(dtype=dtype, kv_cache_bits=bits)
        jc, tc = jm.init_cache(3, 24), tm.init_cache(3, 24)
        assert set(tc["layers"]) == set(jc["layers"])
        for k, v in jc["layers"].items():
            t = tc["layers"][k]
            assert tuple(t.shape) == tuple(v.shape), k
            assert str(t.dtype).replace("torch.", "") == str(v.dtype), k
            assert not bool(t.any())
        assert tc["layers"]["cross_k"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    """The last token's logits and every cache leaf (``k``, ``v``,
    ``cross_k``, ``cross_v``) after a prefill of 2 x 24 tokens over 16
    frames, and ``pos``."""
    jcfg, jm, jp, tm, tp = _pair(dtype=dtype)
    jb, tb = _both(_batch(jcfg, s=24), ("tokens", "frame_embeds"))
    jl, jc = jm.prefill(jp, jb, max_len=30)
    tl, tc = tm.prefill(tp, tb, max_len=30)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _logits_close(tl, jl, jcfg.vocab_size, dtype)
    assert int(tc["pos"]) == int(jc["pos"]) == 24
    assert set(tc["layers"]) == set(jc["layers"]) == {
        "k", "v", "cross_k", "cross_v"}
    for k, v in jc["layers"].items():
        _close(tc["layers"][k], v, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_continues_a_jax_prefill(dtype):
    """A JAX prefill carried into the port by ``model_cache_from_jax`` (the
    cross K/V bit for bit), then two decode steps in each package: the
    logits and every cache leaf after them."""
    jcfg, jm, jp, tm, tp = _pair(dtype=dtype)
    batch = _batch(jcfg, s=26, seed=1)
    toks = batch["tokens"]
    pre = {"tokens": toks[:, :24], "frame_embeds": batch["frame_embeds"]}
    _, jc = jm.prefill(jp, _both(pre)[0], max_len=30)
    tc = convert.model_cache_from_jax(jax.tree.map(np.asarray, jc),
                                      device="cpu")
    for k, v in jc["layers"].items():
        assert np.array_equal(_np(tc["layers"][k]), _np(v)), k
    for t in (24, 25):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), tc)
        _logits_close(tl, jl, jcfg.vocab_size, dtype)
    assert int(tc["pos"]) == int(jc["pos"]) == 26
    for k, v in jc["layers"].items():
        _close(tc["layers"][k], v, dtype)


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_matches_teacher_forcing(family):
    """``test_models_smoke.py``'s identity in the port, in bf16: prefill 31
    tokens over the frames, decode the 32nd, and the argmax equals that of
    the teacher-forced logits at the last position; ``pos`` is 32."""
    jcfg, _, _, tm, tp = _pair(family, "bfloat16")
    batch = _both(_batch(jcfg), ("tokens", "frame_embeds"))[1]
    full, _ = tm.train_logits(tp, batch)
    _, cache = tm.prefill(tp, dict(batch, tokens=batch["tokens"][:, :-1]),
                          max_len=32)
    dl, cache = tm.decode_step(tp, batch["tokens"][:, -1:], cache)
    v = jcfg.vocab_size
    assert (_np(full[:, -1, :v]).argmax(-1) == _np(dl[:, 0, :v])
            .argmax(-1)).all()
    assert int(cache["pos"]) == 32


def test_cross_attention_reads_its_own_layer():
    """A decode whose layer 0 reads layer 1's cross K/V (phase 23b's
    control) moves the logits beyond the teacher-forcing agreement of the
    right cache, in float32: the cross K/V of each layer are used."""
    jcfg, _, _, tm, tp = _pair()
    batch = _both(_batch(jcfg), ("tokens", "frame_embeds"))[1]
    full, _ = tm.train_logits(tp, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    errs = []
    for swap in (False, True):
        _, cache = tm.prefill(tp, pre, max_len=32)
        if swap:
            for name in ("cross_k", "cross_v"):
                cache["layers"][name][0] = cache["layers"][name][1]
        dl, _ = tm.decode_step(tp, batch["tokens"][:, -1:], cache)
        errs.append(float((dl[:, 0] - full[:, -1])[..., :jcfg.vocab_size]
                          .abs().max()))
    assert errs[0] <= 1e-4 and errs[1] > max(100 * errs[0], 1e-2)


def test_int8_kv_cache_decode_parity():
    """The int8 cache (the self-attention K/V in int8 with bf16 scales;
    the cross K/V stay bf16): its decode agrees with the 16-bit cache's by
    ``test_models_smoke.py``'s int8 rule (argmaxes on 99%, atol 0.35 and
    rtol 0.1), and the port's int8 cache and decode against the JAX
    package's own int8 run."""
    jcfg, jm8, jp, _, tp = _pair(dtype="bfloat16", kv_cache_bits=8)
    m16 = build_model(jm8.cfg, device="cpu")
    m8 = build_model(jm8.cfg, kv_cache_bits=8, device="cpu")
    batch = _batch(jcfg, s=24)
    pre = {"tokens": batch["tokens"][:, :-1],
           "frame_embeds": batch["frame_embeds"]}
    _, c16 = m16.prefill(tp, _both(pre)[1], max_len=24)
    _, c8 = m8.prefill(tp, _both(pre)[1], max_len=24)
    assert c8["layers"]["k"].dtype == torch.int8
    assert c8["layers"]["cross_k"].dtype == torch.bfloat16
    assert torch.equal(c8["layers"]["cross_k"], c16["layers"]["cross_k"])
    last = torch.from_numpy(batch["tokens"][:, -1:])
    l16, _ = m16.decode_step(tp, last, c16)
    l8, c8b = m8.decode_step(tp, last, c8)
    v = jcfg.vocab_size
    a, b = _np(l16[:, 0, :v]), _np(l8[:, 0, :v])
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.99
    np.testing.assert_allclose(a, b, atol=0.35, rtol=0.1)
    _, jc8 = jm8.prefill(jp, _both(pre)[0], max_len=24)
    jl8, jc8 = jm8.decode_step(jp, jnp.asarray(batch["tokens"][:, -1:]),
                               jc8)
    _logits_close(l8, jl8, v, "bfloat16")
    for k in ("cross_k", "cross_v"):
        _close(c8b["layers"][k], jc8["layers"][k], "bfloat16")
    for k in ("k", "v"):
        sc, jsc = c8b["layers"][f"{k}_scale"], jc8["layers"][f"{k}_scale"]
        _close(sc, jsc, "bfloat16")
        _close(c8b["layers"][k].float() * sc.float()[..., None],
               np.asarray(jc8["layers"][k], np.float32)
               * np.asarray(jsc, np.float32)[..., None], "bfloat16")


# ------------------------------------------------------------- kv_repeat
@pytest.mark.parametrize("family", FAMILIES)
def test_kv_repeat_matches_jax(family):
    """``kv_repeat=2`` on 4 heads with 2 KV heads (so 4 stored heads, one
    query each): the loss and every gradient, then the prefill cache
    (self and cross K/V repeated on the head axis) and a decode step,
    against the JAX model built the same way, in float32; and the loss
    equal to the unrepeated model's (a repeat changes no function)."""
    jcfg, jm, jp, tm, tp = _pair(family, grad=True, kv_repeat=2,
                                 cfg=dict(num_kv_heads=2))
    batch = _batch(jcfg)
    (jl, _), (tl, _), jg, tg = _grads(jm, jp, tm, tp, batch)
    assert abs(jl - tl) <= 1e-5
    _assert_grads_f32(jg, tg)
    plain = build_model(tm.cfg, device="cpu")
    assert abs(float(plain.loss(tp, _both(batch)[1])[0]) - tl) <= 1e-5
    pre = {"tokens": batch["tokens"][:, :-1],
           "frame_embeds": batch["frame_embeds"]}
    jlog, jc = jm.prefill(jp, _both(pre)[0], max_len=32)
    with torch.no_grad():
        tlog, tc = tm.prefill(tp, _both(pre)[1], max_len=32)
    _logits_close(tlog, jlog, jcfg.vocab_size, "float32")
    for k, v in jc["layers"].items():
        assert tc["layers"][k].shape[3] == 4, k
        _close(tc["layers"][k], v, "float32")
    last = batch["tokens"][:, -1:]
    jl2, _ = jm.decode_step(jp, jnp.asarray(last), jc)
    tl2, _ = tm.decode_step(tp, torch.from_numpy(last), tc)
    _logits_close(tl2, jl2, jcfg.vocab_size, "float32")


# ------------------------------------------------ chip_smoke's rehearsal
def test_chip_smoke_rehearses_phases_23_to_26(monkeypatch):
    """``chip_smoke.py``'s phases 23-26 on the CPU at the reduced configs
    (``small=True``; the replays' timer on the host clock): every check
    and control runs: 23b's teacher forcing with the swapped cross K/V
    rejected and the int8 cache within phase 10's rule, 24a's gradient
    check in float32 and bf16 with the last cross-attention's dK/dV
    zeroed read on the encoder (every decoder layer's held, the last
    layer's read), 24b's steps, 25b with the decode at the
    text's position rejected, and phase 26's replays with their dropped
    key tiles, and its masked replays (K5 and K6 with per-row key
    lengths, bf16 and float32) with their lengths ignored rejected. Here
    both sides of each kernel comparison are plain torch (on the CPU
    nothing launches)."""
    import time

    import chip_smoke as cs

    def host_ms(fn, iters):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    monkeypatch.setattr(cs, "_sync_time_ms", host_ms)
    out = cs.frontend_phases(torch.device("cpu"), cs.all_wrappers(),
                             small=True)
    serve, train = out["runs"]["encdec_serve"], out["runs"]["encdec_train"]
    tf = serve["teacher_forcing"]
    assert tf["bfloat16"]["argmax_equal"] and tf["float32"]["rel"] <= 1e-4
    assert serve["int8"]["fp32_int8"]["agree"] >= cs.INT8_AGREE
    assert len(train["losses"]) == cs.SMALL_ENCDEC_TRAIN["steps"]
    for g in train["grad_check"].values():
        assert g["control_ratio"] >= 10 and g["last_cross_read"] > 0
    assert out["runs"]["vlm_serve"]["teacher_forcing"]["float32"][
        "argmax_equal"]
    for key in ("K5", "K6"):
        assert set(out["replays"][key]) == {"encoder", "cross"}
        for r in out["replays"][key].values():
            assert r["control_ratio"] >= 10 and "causal=False" in r["shape"]
    assert set(out["masked"]) == {"cross", "causal", "fp32"}
    for name, rec in out["masked"].items():
        for key in ("K5", "K6"):
            r = rec[key]
            assert r["control_ratio"] >= 10 and "kv_valid_len" in r["shape"]
        assert 0 < rec["K5"]["tile_share"] < 1
