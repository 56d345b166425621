"""The port's dense model and its layers against the JAX package's, on the
same numpy inputs, with the JAX weights carried across by
``convert.model_params_from_jax``.

Here, on the CPU, the model's attention takes K5's and K6's plain versions;
the JAX model runs ``blocked_attention`` under its own autodiff.

Tolerances: the layers in float32 within rtol and atol 1e-6 (the same
arithmetic; only the reduction order differs) and in bfloat16 within one
bf16 ulp (2**-7 relative: both round one fp32 result). The model in
float32: logits within atol 1e-4, loss within 1e-5 and every gradient
within rtol 1e-3 and atol 1e-5 x its largest |value| (two layers of fp32
arithmetic in another order; the attention is an online softmax on one
side and a materialized one on the other). In bfloat16 the loss within
2e-2 and each gradient within 5% of its norm (measured about 1%): every
matmul rounds to bf16, and ``blocked_attention`` rounds ``q * scale`` to
bf16 before the score product while K5/K6 scale the fp32 scores.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.data.generators import token_batches
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """The reduced starcoder2-7b config in both packages, with ``kw``."""
    return (dataclasses.replace(j_reduced(j_get_config("starcoder2-7b")),
                                **kw),
            dataclasses.replace(reduced(get_config("starcoder2-7b")), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulp_close(a, b):
    """Within one bf16 ulp of the larger magnitude (floor 2**-10)."""
    a, b = _np(a), _np(b)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 2.0 ** -10)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert float((np.abs(a - b) / ulp).max()) <= 1.0


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.rmsnorm_apply({"scale": jnp.asarray(scale)},
                            jnp.asarray(x).astype(jd), 1e-5, jd)
    got = TL.rmsnorm_apply({"scale": _t(scale)}, _t(x).to(td), 1e-5, td)
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    else:
        _ulp_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32) * 37, (2, 64))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.apply_rope(jnp.asarray(x).astype(jd), jnp.asarray(pos),
                         10_000.0)
    got = TL.apply_rope(_t(x).to(td), _t(pos), 10_000.0)
    assert got.dtype == td
    if dtype == "float32":
        # angles up to 2,331 rad: the two libraries' cos/sin differ in
        # the last bits there
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        _ulp_close(got, want)


@pytest.mark.parametrize("variant,bias", [("swiglu", False),
                                          ("gelu", True)])
def test_mlp_matches_jax(variant, bias):
    jcfg, tcfg = _cfgs(mlp_variant=variant, use_bias=bias)
    params = JL.mlp_init(jax.random.PRNGKey(3), jcfg, jnp.float32)[0]
    params = jax.tree.map(lambda p: p + 0.1, params)     # nonzero biases
    tparams = jax.tree.map(lambda p: _t(p), params)
    x = np.random.default_rng(2).normal(size=(2, 8, jcfg.d_model)) \
        .astype(np.float32)
    want = JL.mlp_apply(params, jnp.asarray(x), jcfg, jnp.float32)
    got = TL.mlp_apply(tparams, _t(x), tcfg, torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tie", [False, True])
def test_unembed_masks_the_padded_vocabulary(tie):
    """vocab 500 pads to 512; the 12 pad columns are -1e30 in both, and
    the rest agree."""
    jcfg, tcfg = _cfgs(vocab_size=500, tie_embeddings=tie)
    params = JL.embed_init(jax.random.PRNGKey(4), jcfg, jnp.float32)[0]
    tparams = {k: _t(v) for k, v in params.items()}
    assert tuple(tparams["table"].shape) == (TL.pad_vocab(500), 256)
    x = np.random.default_rng(3).normal(size=(2, 8, 256)).astype(np.float32)
    want = JL.unembed_apply(params, jnp.asarray(x), jcfg)
    got = TL.unembed_apply(tparams, _t(x), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 512)
    assert bool((got[..., 500:] == -1e30).all())
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    tok = np.random.default_rng(5).integers(0, 500, (2, 8))
    np.testing.assert_array_equal(
        _np(TL.embed_apply(tparams, _t(tok), torch.float32)),
        _np(JL.embed_apply(params, jnp.asarray(tok), jnp.float32)))


def test_dense_contracts_two_dims_as_jax():
    """The attention output projection [h, dh, d] contracts two dims."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(4, 16, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    x = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    want = JL.dense_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x), jnp.float32, contract_dims=2)
    got = TL.dense_apply({"w": _t(w), "b": _t(b)}, _t(x), torch.float32,
                         contract_dims=2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- model
def _model_pair(arch="starcoder2-7b", remat_group=0, **kw):
    """Both models of one config, the JAX weights in each, and a batch."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
    tcfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    jm = j_build_model(jcfg, remat_group=remat_group)
    jparams = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tm = build_model(tcfg, remat_group=remat_group, device="cpu")
    tparams = {n: t.requires_grad_(True) for n, t in
               convert.model_params_from_jax(np_params).items()}
    batch = next(token_batches(tcfg.vocab_size, 2, 64, seed=3))
    return jm, jparams, tm, tparams, batch


def _grads(jm, jparams, tm, tparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jparams, jb)
    tb = {k: _t(v) for k, v in batch.items()}
    tl, tmet = tm.loss(tparams, tb)
    tg = dict(zip(tparams, torch.autograd.grad(tl, list(tparams.values()))))
    jg = convert.model_params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jg) == set(tg)
    return (float(jl), jmet), (float(tl), tmet), jg, tg


@pytest.mark.parametrize("kw", [
    dict(compute_dtype="float32"),
    dict(compute_dtype="float32", mlp_variant="gelu", use_bias=True,
         remat="full"),
], ids=["swiglu", "gelu-bias-remat"])
def test_model_matches_jax_float32(kw):
    """train_logits, loss and every parameter's gradient of the reduced
    starcoder2-7b against jax.value_and_grad(model.loss)."""
    jm, jparams, tm, tparams, batch = _model_pair(**kw)
    jlog, _ = jm.train_logits(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tlog, aux = tm.train_logits(tparams, {k: _t(v) for k, v in
                                          batch.items()})
    assert tlog.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=0, atol=1e-4)
    (jl, jmet), (tl, tmet), jg, tg = _grads(jm, jparams, tm, tparams, batch)
    assert abs(jl - tl) <= 1e-5
    assert float(tmet["ntok"]) == float(jmet["ntok"]) == 128.0
    for name in jg:
        scale = float(jg[name].abs().max())
        np.testing.assert_allclose(_np(tg[name]), _np(jg[name]), rtol=1e-3,
                                   atol=1e-5 * max(scale, 1e-3),
                                   err_msg=name)


def test_model_matches_jax_bfloat16():
    """The same in the configs' own compute type, bf16, with the
    starcoder2 MLP (GELU, biases) and full remat."""
    jm, jparams, tm, tparams, batch = _model_pair(
        mlp_variant="gelu", use_bias=True, remat="full")
    (jl, _), (tl, _), jg, tg = _grads(jm, jparams, tm, tparams, batch)
    assert abs(jl - tl) <= 2e-2
    for name in jg:
        a, b = _np(tg[name]), _np(jg[name])
        assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b), name


def test_model_refuses_what_is_not_ported():
    """Every family of ``configs/base.py`` builds, the K/V repeat too
    (every reduced arch, and enc-dec, VLM and audio configs with
    ``kv_repeat`` 1 and 2), and runs a loss; ``attn_forward``'s
    ``kv_valid_len`` (a per-row key length in K5/K6) runs, finite where
    every row keeps a key; what stays refused is a cache of other than 8
    or 16 bits. The serving half is held to the JAX package in
    ``test_torch_serve_model.py``, the lengths in
    ``test_layer_with_key_lengths_matches_jax``."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ALL_FAMILIES
    from repro_torch.models import attention as TA
    cfg = reduced(get_config("starcoder2-7b"))
    built = set()
    for arch in sorted(ARCHS):
        for r in (1, 2):
            c = reduced(get_config(arch))
            if c.has_attention and c.num_heads % (c.num_kv_heads * r):
                continue
            build_model(c, kv_repeat=r, kv_cache_bits=8, device="cpu")
            built.add(c.family)
    enc = dataclasses.replace(reduced(get_config("seamless-m4t-medium")),
                              family="encdec", num_kv_heads=2,
                              compute_dtype="float32")
    m = build_model(enc, kv_repeat=2, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    batch = {k: _t(v) for k, v in next(token_batches(
        enc.vocab_size, 2, 16, seed=1)).items()}
    batch["frame_embeds"] = torch.zeros((2, enc.frontend_tokens,
                                         enc.d_model))
    assert torch.isfinite(m.loss(params, batch)[0])
    built.add(enc.family)
    assert built == set(ALL_FAMILIES)
    lp = {k[len("layers.0.attn."):]: v for k, v in params.items()
          if k.startswith("layers.0.attn.")}
    y, _ = TA.attn_forward(TL.nest(lp), torch.ones((2, 4, enc.d_model)),
                           enc, positions=torch.zeros((2, 4),
                                                      dtype=torch.int32),
                           kv_valid_len=torch.full((2,), 3))
    assert y.shape == (2, 4, enc.d_model) and bool(torch.isfinite(y).all())
    with pytest.raises(ValueError):
        build_model(cfg, kv_cache_bits=4, device="cpu")
    for arch in ("mamba2-780m", "hymba-1.5b"):
        build_model(reduced(get_config(arch)), kv_cache_bits=8,
                    kv_dus_write=True, device="cpu")


@pytest.mark.parametrize("arch", ["starcoder2-7b", "seamless-m4t-medium"])
def test_layer_with_key_lengths_matches_jax(arch):
    """A dense layer (the reduced starcoder2-7b) and an audio decoder
    layer (the reduced seamless-m4t-medium, cross-attending 16 frames)
    against the JAX layer in float32: ``_layer_forward`` with
    ``kv_valid_len`` (24, 13) and, for the audio layer, ``xattn_len``
    (16, 9): the output and the gradients of its summed squares with
    respect to x, every parameter of the layer and the cross K/V within
    rtol 2e-5 and atol 2e-5 of the gradient's largest magnitude (at least
    1), those of the frames past a row's length exactly 0; and
    ``_layer_decode`` at position 11 with ``xattn_len``: its output and
    the written cache."""
    from repro.models import transformer as JT
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32")
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    flat = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams))
    names = [n for n in flat if n.startswith("layers.0.")]
    leaves = {n[len("layers.0."):]: flat[n].requires_grad_(True)
              for n in names}
    cross = "xattn" in TL.nest(dict(leaves))
    rng = np.random.default_rng(21)
    b, s, f = 2, 24, tcfg.frontend_tokens
    hs, dh = tcfg.num_kv_heads, tcfg.resolved_head_dim
    x = rng.normal(size=(b, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    ck, cv = (rng.normal(size=(b, f or 1, hs, dh)).astype(np.float32)
              for _ in range(2))
    kvl, xl = (24, 13), (16, 9)

    def jfwd(lp, x, ck, cv):
        y, _, _ = JT._layer_forward(
            lp, x, jcfg, positions=jnp.asarray(pos), kv_repeat=1,
            causal=True, window=jcfg.attn_window,
            cross_kv=(ck, cv) if cross else None,
            xattn_len=jnp.asarray(xl, jnp.int32) if cross else None,
            kv_valid_len=jnp.asarray(kvl, jnp.int32))
        return jnp.sum(y * y), y
    (_, jy), jg = jax.value_and_grad(jfwd, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        jlp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv))
    tx, tck, tcv = (_t(a).requires_grad_(True) for a in (x, ck, cv))
    ty, _, _ = TT._layer_forward(
        TL.nest(dict(leaves)), tx, cfg=tcfg, positions=_t(pos),
        window=tcfg.attn_window, cross_kv=(tck, tcv) if cross else None,
        xattn_len=torch.tensor(xl) if cross else None,
        kv_valid_len=torch.tensor(kvl))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=2e-5, atol=2e-5)
    # the layer takes its cross K/V as given: the model's _cross_kv reads
    # the xattn k and v weights
    wrt = {"x": tx, **{n: t for n, t in leaves.items()
                       if not n.startswith(("xattn.k.", "xattn.v."))},
           **({"ck": tck, "cv": tcv} if cross else {})}
    got = dict(zip(wrt, torch.autograd.grad(ty.square().sum(),
                                            list(wrt.values()))))
    jflat = convert.model_params_from_jax(jax.tree.map(
        np.asarray, {"layers": jax.tree.map(lambda a: a[None], jg[0])}))
    want = {"x": jg[1], "ck": jg[2], "cv": jg[3],
            **{n[len("layers.0."):]: t for n, t in jflat.items()}}
    for n, g in got.items():
        w = _np(want[n])
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(_np(g), w, rtol=2e-5, atol=2e-5 * scale,
                                   err_msg=n)
    if cross:
        for n in ("ck", "cv"):
            assert torch.equal(got[n][1, xl[1]:],
                               torch.zeros_like(got[n][1, xl[1]:]))
    # one decode step at position 11 against a 20-slot cache
    x1 = rng.normal(size=(b, 1, tcfg.d_model)).astype(np.float32)
    cache = {"k": rng.normal(size=(b, 20, hs, dh)).astype(np.float32),
             "v": rng.normal(size=(b, 20, hs, dh)).astype(np.float32)}
    if cross:
        cache.update(cross_k=ck, cross_v=cv)
    jx, jcache = JT._layer_decode(
        jlp, jnp.asarray(x1), jcfg,
        cache_layer={k: jnp.asarray(a) for k, a in cache.items()},
        cache_pos=11, kv_repeat=1, window=jcfg.attn_window,
        xattn_len=jnp.asarray(xl, jnp.int32) if cross else None)
    tcache = {k: _t(a.copy()) for k, a in cache.items()}
    with torch.no_grad():
        tx1 = TT._layer_decode(
            TL.nest({k: t.detach() for k, t in leaves.items()}), _t(x1),
            tcfg, cache_layer=tcache, cache_pos=11,
            window=tcfg.attn_window,
            xattn_len=torch.tensor(xl) if cross else None)
    np.testing.assert_allclose(_np(tx1), _np(jx), rtol=2e-5, atol=2e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]),
                                   rtol=2e-5, atol=2e-5)
    if cross:
        # a frame past row 1's length changes nothing there
        tcache["cross_v"][:, xl[1]:] += 1.0
        with torch.no_grad():
            moved = TT._layer_decode(
                TL.nest({k: t.detach() for k, t in leaves.items()}),
                _t(x1), tcfg, cache_layer=dict(tcache, k=_t(cache["k"]),
                                               v=_t(cache["v"])),
                cache_pos=11, window=tcfg.attn_window,
                xattn_len=torch.tensor(xl))
        assert torch.equal(moved[1], tx1[1])
        assert not torch.equal(moved[0], tx1[0])


@pytest.mark.parametrize("arch,remat", [("qwen3-moe-30b-a3b", "full"),
                                        ("phi3.5-moe-42b-a6.6b", "none")])
def test_moe_model_matches_jax_float32(arch, remat):
    """The reduced MoE configs (8 experts, top-2; 2 x 64 tokens, so the
    capacity, 64, drops tokens): train_logits, the aux summed over the
    layers, the loss and every parameter's gradient (the router's and the
    experts' included) against jax.value_and_grad(model.loss), with the
    fp32 tolerances of the dense model. Under ``remat="full"`` the
    checkpointed layer returns (x, aux)."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)),
                               compute_dtype="float32", remat=remat)
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32", remat=remat)
    jm = j_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tparams = {n: t.requires_grad_(True) for n, t in
               convert.model_params_from_jax(
                   jax.tree.map(np.asarray, jparams)).items()}
    assert any(n.endswith("moe.router.w") for n in tparams)
    batch = next(token_batches(tcfg.vocab_size, 2, 64, seed=3))
    jlog, jaux = jm.train_logits(jparams, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tlog, taux = tm.train_logits(tparams, {k: _t(v)
                                           for k, v in batch.items()})
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=0, atol=1e-4)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    (jl, jmet), (tl, tmet), jg, tg = _grads(jm, jparams, tm, tparams, batch)
    assert abs(jl - tl) <= 1e-5
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]),
                               rtol=1e-6)
    for name in jg:
        scale = float(jg[name].abs().max())
        np.testing.assert_allclose(_np(tg[name]), _np(jg[name]), rtol=1e-3,
                                   atol=1e-5 * max(scale, 1e-3),
                                   err_msg=name)


def test_model_init_draws_the_jax_shapes():
    """``init`` gives every leaf of the JAX tree, per layer, in the JAX
    shapes and fp32, and its state_dict carries the same names."""
    jcfg, tcfg = _cfgs(mlp_variant="gelu", use_bias=True)
    shapes = jax.eval_shape(lambda: j_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    want = {n: tuple(t.shape) for n, t in convert.model_params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                     shapes)).items()}
    m = build_model(tcfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in params.items()} == want
    assert set(m.state_dict()) == set(want)
    assert all(p.dtype == torch.float32 for p in params.values())
    assert sum(p.numel() for p in params.values()) == \
        sum(int(np.prod(s)) for s in want.values())


# ------------------------------------------------- SSM and hybrid training
SSM_ARCHS = ["mamba2-780m", "hymba-1.5b"]


def _assert_grads_f32(jg, tg):
    for name in jg:
        scale = float(jg[name].abs().max())
        np.testing.assert_allclose(_np(tg[name]), _np(jg[name]), rtol=1e-3,
                                   atol=1e-5 * max(scale, 1e-3),
                                   err_msg=name)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_model_matches_jax_float32(arch):
    """The reduced mamba2-780m and hymba-1.5b (2 x 64 tokens, chunk 32;
    hymba's window 32 and 4 heads on 1 KV head): train_logits, the loss
    and every parameter's gradient, ``A_log``, ``dt_bias``, ``D`` and the
    convolutions included, through K7's plain version and
    ``ssd_scan_bwd``, against jax.value_and_grad(model.loss), with the
    dense model's float32 tolerances."""
    jm, jparams, tm, tparams, batch = _model_pair(arch,
                                                  compute_dtype="float32")
    assert any(n.endswith("ssd.A_log") for n in tparams)
    jlog, _ = jm.train_logits(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    tlog, aux = tm.train_logits(tparams, {k: _t(v) for k, v in
                                          batch.items()})
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=0, atol=1e-4)
    (jl, jmet), (tl, tmet), jg, tg = _grads(jm, jparams, tm, tparams, batch)
    assert abs(jl - tl) <= 1e-5
    assert float(tmet["ntok"]) == float(jmet["ntok"])
    _assert_grads_f32(jg, tg)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_model_matches_jax_bfloat16(arch):
    """The same in bf16 compute: the loss within 2e-2 of the JAX bf16
    loss, and each gradient within 5% of its norm (the dense model's
    bf16 limits) of the JAX float32 gradient, the reference that does
    not round. The JAX bf16 gradient is not the reference here: it sums
    the ``D`` term's bf16 products in bf16 and lies 5.1% (mamba2) and
    5.4% (hymba) from its own float32 value, where the port lies 1.3%;
    every other gradient of both packages lies within 4% of it."""
    jm, jparams, tm, tparams, batch = _model_pair(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl = float(jm.loss(jparams, jb)[0])
    tl, _ = tm.loss(tparams, {k: _t(v) for k, v in batch.items()})
    assert abs(jl - float(tl)) <= 2e-2
    tg = dict(zip(tparams, torch.autograd.grad(tl, list(tparams.values()))))
    jm32 = j_build_model(dataclasses.replace(jm.cfg,
                                             compute_dtype="float32"))
    jg = jax.grad(lambda p: jm32.loss(p, jb)[0])(jparams)
    jg = convert.model_params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jg) == set(tg)
    for name in jg:
        a, b = _np(tg[name]), _np(jg[name])
        assert np.isfinite(a).all(), name
        assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b), name


@pytest.mark.parametrize("arch,remat,group", [
    ("hymba-1.5b", "dots", 0), ("hymba-1.5b", "full", 2),
    ("hymba-1.5b", "dots", 2), ("mamba2-780m", "none", 2),
    ("starcoder2-7b", "dots", 2),
], ids=["hymba-dots", "hymba-full-g2", "hymba-dots-g2", "mamba2-none-g2",
        "starcoder2-dots-g2"])
def test_remat_policies_match_jax(arch, remat, group):
    """``remat="dots"`` (JAX's ``checkpoint_dots``) and two-level remat
    (``remat_group=2`` on 4 layers: two outer checkpoints of two layers,
    each layer wrapped as ``remat`` says) against the JAX model built the
    same way, in float32: the loss and every gradient, with the tolerances
    above. The K5/K6 and K7 plain versions run inside the checkpoints and
    inside their recomputes."""
    jm, jparams, tm, tparams, batch = _model_pair(
        arch, remat_group=group, compute_dtype="float32", remat=remat,
        num_layers=4)
    calls = []
    real = TT.checkpoint

    def spy(fn, *a, **kw):
        calls.append("context_fn" in kw)
        return real(fn, *a, **kw)

    TT.checkpoint = spy
    try:
        (jl, _), (tl, _), jg, tg = _grads(jm, jparams, tm, tparams, batch)
    finally:
        TT.checkpoint = real
    # the two outer group checkpoints; each layer's (none under "none"),
    # called again where the outer checkpoint recomputes its group
    inner = (0 if remat == "none" else 4) * (2 if group else 1)
    assert len(calls) == (2 if group else 0) + inner
    assert sum(calls) == (inner if remat == "dots" else 0)
    assert abs(jl - tl) <= 1e-5
    _assert_grads_f32(jg, tg)


def test_remat_group_that_does_not_divide_falls_back():
    """``remat_group=3`` on 4 layers: JAX's ``train_logits`` falls back to
    the flat scan without a word, and so does the port (no outer
    checkpoint; each layer checkpointed as ``remat="full"`` says); the
    loss and gradients match the JAX model built the same way."""
    jm, jparams, tm, tparams, batch = _model_pair(
        "mamba2-780m", remat_group=3, compute_dtype="float32",
        remat="full", num_layers=4)
    seen = []
    real = TT.checkpoint

    def spy(fn, *a, **kw):
        seen.append(fn)
        return real(fn, *a, **kw)

    TT.checkpoint = spy
    try:
        (jl, _), (tl, _), jg, tg = _grads(jm, jparams, tm, tparams, batch)
    finally:
        TT.checkpoint = real
    assert len(seen) == 4
    assert all(getattr(f, "func", None) is TT._layer_train for f in seen)
    assert abs(jl - tl) <= 1e-5
    _assert_grads_f32(jg, tg)
