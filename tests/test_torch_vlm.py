"""The VLM family (internvl2-76b's ``FAMILY_VLM``: the dense decoder
behind a prefix of stub patch embeddings) in the port against the JAX
package, on the same numpy inputs, with the JAX weights carried across by
``convert.model_params_from_jax``: logits over the patches and the text
[B, F + S, Vp], the loss scored on the text tail and every gradient, the
prefill cache and ``pos`` = F + S, decode steps, and a batch without
patches, which is the dense path.

Here, on the CPU, the port's attention takes K5's and K6's plain
versions; the JAX model runs ``blocked_attention``. Tolerances are those
of ``test_torch_models.py`` and ``test_torch_serve_model.py``: in float32
logits within atol 1e-4, the loss within 1e-5, every gradient within
rtol 1e-3 and atol 1e-5 x its largest |value|, cache leaves within rtol
and atol 1e-5; in bf16 the loss within 2e-2 of the JAX bf16 loss, each
gradient within 5% of its norm of the JAX float32 gradient, cache leaves
and logits within 2% of their norm and 4 bf16 ulps (8 for float32) of
their largest |value|.
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

ARCH = "internvl2-76b"



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


def _pair(dtype="float32", grad=False, **kw):
    """Both models of the reduced internvl2-76b (2 layers, 4 heads on 1 KV
    head of 64, 16 patches) in the compute type ``dtype``, the JAX weights
    in each."""
    kw = dict(compute_dtype=dtype, **kw)
    jcfg = dataclasses.replace(j_reduced(j_get_config(ARCH)), **kw)
    tcfg = dataclasses.replace(reduced(get_config(ARCH)), **kw)
    jm = j_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tparams = convert.model_params_from_jax(jax.tree.map(np.asarray,
                                                         jparams))
    if grad:
        tparams = {n: t.requires_grad_(True) for n, t in tparams.items()}
    return jcfg, jm, jparams, tm, tparams


def _batch(cfg, b=2, s=32, seed=0):
    """Tokens, targets (the text's) and the stub patch embeddings (normal
    x 0.02, as the JAX smoke test draws them) from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "patch_embeds": (rng.normal(size=(b, cfg.frontend_tokens,
                                              cfg.d_model)) * 0.02)
            .astype(np.float32)}


def _both(batch, keys=None):
    keys = keys or batch
    return ({k: jnp.asarray(batch[k]) for k in keys},
            {k: torch.from_numpy(batch[k]) for k in keys})


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


# ------------------------------------------------------------- training
def test_model_matches_jax_float32():
    """train_logits [B, F + S, Vp] over the patches and the text, the loss
    scored on the text tail (the targets are the text's), and every
    parameter's gradient against jax.value_and_grad(model.loss)."""
    jcfg, jm, jp, tm, tp = _pair(grad=True)
    batch = _batch(jcfg)
    jb, tb = _both(batch)
    f, (b, s) = jcfg.frontend_tokens, batch["tokens"].shape
    jlog, _ = jm.train_logits(jp, jb)
    tlog, _ = tm.train_logits(tp, tb)
    assert tuple(tlog.shape) == jlog.shape == (b, f + s, 512)
    np.testing.assert_allclose(_np(tlog), _np(jlog), rtol=0, atol=1e-4)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    tl, tmet = tm.loss(tp, tb)
    assert abs(float(jl) - float(tl.detach())) <= 1e-5
    assert float(tmet["ntok"]) == float(jmet["ntok"]) == b * s
    tail = tlog.detach()[:, f:]
    ce = torch.logsumexp(tail, -1) - torch.gather(
        tail, -1, tb["targets"].long()[..., None])[..., 0]
    assert abs(float(ce.mean()) - float(tl.detach())) <= 1e-5
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    jg = convert.model_params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jg) == set(tg)
    for name in jg:
        scale = float(jg[name].abs().max())
        np.testing.assert_allclose(_np(tg[name]), _np(jg[name]), rtol=1e-3,
                                   atol=1e-5 * max(scale, 1e-3),
                                   err_msg=name)


def test_model_bf16_within_jax_float32():
    """In bf16 compute: the loss within 2e-2 of the JAX bf16 loss, each
    gradient within 5% of its norm of the JAX float32 gradient."""
    jcfg, jm, jp, tm, tp = _pair("bfloat16", grad=True)
    jb, tb = _both(_batch(jcfg))
    tl, _ = tm.loss(tp, tb)
    assert abs(float(jax.jit(jm.loss)(jp, jb)[0]) - float(tl.detach())) <= 2e-2
    tg = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    jm32 = j_build_model(dataclasses.replace(jcfg, compute_dtype="float32"))
    jg = convert.model_params_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(lambda p: jm32.loss(p, jb)[0]))(jp)))
    for name in jg:
        a, b = _np(tg[name]), _np(jg[name])
        assert np.isfinite(a).all(), name
        assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b), name


def test_batch_without_patches_is_the_dense_path():
    """A VLM batch without ``patch_embeds`` (what the JAX training entry
    point feeds) runs text-only: logits [B, S, Vp] and the loss equal bit
    for bit to the same weights in a dense model, and to JAX's VLM."""
    jcfg, jm, jp, tm, tp = _pair()
    batch = _batch(jcfg)
    keys = ("tokens", "targets")
    jb, tb = _both(batch, keys)
    dense = build_model(dataclasses.replace(tm.cfg, family="dense"),
                        device="cpu")
    got, _ = tm.train_logits(tp, tb)
    want, _ = dense.train_logits(tp, tb)
    assert got.shape == (2, 32, 512) and torch.equal(got, want)
    assert torch.equal(tm.loss(tp, tb)[0], dense.loss(tp, tb)[0])
    np.testing.assert_allclose(_np(got), _np(jm.train_logits(jp, jb)[0]),
                               rtol=0, atol=1e-4)


# --------------------------------------------------------------- serving
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """A prefill of 16 patches and 24 tokens: the last logits, every
    cache leaf and ``pos`` = F + S = 40; then two decode steps in each
    package from the same cache (the JAX cache carried across), their
    logits, the cache after them and ``pos`` = 42."""
    jcfg, jm, jp, tm, tp = _pair(dtype)
    batch = _batch(jcfg, s=26, seed=1)
    toks, f = batch["tokens"], jcfg.frontend_tokens
    pre = {"tokens": toks[:, :24], "patch_embeds": batch["patch_embeds"]}
    jl, jc = jm.prefill(jp, _both(pre)[0], max_len=f + 26)
    tl, tc = tm.prefill(tp, _both(pre)[1], max_len=f + 26)
    _logits_close(tl, jl, jcfg.vocab_size, dtype)
    assert int(tc["pos"]) == int(jc["pos"]) == f + 24
    assert set(tc["layers"]) == set(jc["layers"]) == {"k", "v"}
    for k, v in jc["layers"].items():
        _close(tc["layers"][k], v, dtype)
    tc = convert.model_cache_from_jax(jax.tree.map(np.asarray, jc),
                                      device="cpu")
    for t in (24, 25):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), tc)
        _logits_close(tl, jl, jcfg.vocab_size, dtype)
    assert int(tc["pos"]) == int(jc["pos"]) == f + 26
    for k, v in jc["layers"].items():
        _close(tc["layers"][k], v, dtype)


def test_decode_matches_teacher_forcing_and_counts_the_patches():
    """``test_models_smoke.py``'s identity for the VLM, in bf16: prefill
    the patches and 31 tokens (capacity F + 32), decode the 32nd, and the
    argmax equals that of the teacher-forced logits at the last of the F +
    32 positions; ``pos`` is F + 32. The same decode at ``pos`` = the text
    length (phase 25b's control: the patches not counted) moves the
    logits more than 100 times further from teacher forcing (and by more
    than 1e-2), in float32."""
    jcfg, _, _, tm, tp = _pair("bfloat16")
    f = jcfg.frontend_tokens
    batch = _both(_batch(jcfg), ("tokens", "patch_embeds"))[1]
    full, _ = tm.train_logits(tp, batch)
    assert full.shape[1] == f + 32
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = tm.prefill(tp, pre, max_len=f + 32)
    dl, cache = tm.decode_step(tp, batch["tokens"][:, -1:], cache)
    v = jcfg.vocab_size
    assert (_np(full[:, -1, :v]).argmax(-1) == _np(dl[:, 0, :v])
            .argmax(-1)).all()
    assert int(cache["pos"]) == f + 32
    _, _, _, tm32, _ = _pair()
    full, _ = tm32.train_logits(tp, batch)
    errs = []
    for at in (f + 31, 31):
        _, cache = tm32.prefill(tp, pre, max_len=f + 32)
        cache["pos"].fill_(at)
        dl, _ = tm32.decode_step(tp, batch["tokens"][:, -1:], cache)
        errs.append(float((dl[:, 0] - full[:, -1])[..., :v].abs().max()))
    assert errs[0] <= 1e-4 and errs[1] > max(100 * errs[0], 1e-2)


def test_chip_smoke_rehearses_phase_25():
    """``chip_smoke.py``'s phase 25 on the CPU at the reduced internvl2-76b
    (2 layers; 2 x (16 patches + 24 tokens), 3 decode steps): the
    serving run's position counts the patches, 25b's teacher forcing holds
    in bf16 and float32, and its control (the decode at the text's
    position) is rejected."""
    import chip_smoke as cs
    cfg = dataclasses.replace(reduced(get_config(ARCH)), num_layers=2)
    run = cs.SMALL_VLM_SERVE
    s = run["check_seq"]
    seen = []

    def control(cache):
        seen.append(int(cache["pos"]))
        cache["pos"].fill_(s - 1)

    rec = cs.frontend_serve(torch.device("cpu"), cfg, run, 0,
                            cs.all_wrappers(), 25, control, "text position")
    assert seen == [cfg.frontend_tokens + s - 1]
    assert rec["prefill_positions_per_s"] > rec["prefill_tokens_per_s"]
    assert rec["teacher_forcing"]["float32"]["rel"] <= cs.TF_F32_RTOL
