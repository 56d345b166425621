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
def _model_pair(**kw):
    """Both models of one config, the JAX weights in each, and a batch."""
    jcfg, tcfg = _cfgs(**kw)
    jm = j_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tm = build_model(tcfg, device="cpu")
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
    """The families other than dense, SSM and hybrid, ``remat="dots"``,
    two-level remat and the K/V repeat raise at construction; the serving
    half is held to the JAX package in ``test_torch_serve_model.py``."""
    cfg = reduced(get_config("starcoder2-7b"))
    for arch in ("qwen3-moe-30b-a3b", "internvl2-76b",
                 "seamless-m4t-medium"):
        with pytest.raises(NotImplementedError):
            build_model(reduced(get_config(arch)), device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, remat="dots"), device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(cfg, remat_group=2, device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(cfg, kv_repeat=2, device="cpu")
    with pytest.raises(ValueError):
        build_model(cfg, kv_cache_bits=4, device="cpu")
    for arch in ("mamba2-780m", "hymba-1.5b"):
        build_model(reduced(get_config(arch)), kv_cache_bits=8,
                    kv_dus_write=True, device="cpu")


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
