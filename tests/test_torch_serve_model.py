"""The serving half of the port's ``Model`` (``init_cache``, ``prefill``,
``prefill_streaming``, ``decode_step``, ``attn_decode`` with its window
ring and int8 cache), ``serve/serve_step.py`` and ``launch/serve.py``
against the JAX package, for the SSM (mamba2-780m), hybrid (hymba-1.5b),
dense (starcoder2-7b, command-r-35b for int8), MoE, audio
(seamless-m4t-medium: its stub frame embeddings beside the tokens) and
VLM (internvl2-76b: its stub patch embeddings ahead of them, so the
capacities and positions count F more) families at their reduced
configs, with the JAX weights carried across by
``convert.model_params_from_jax`` and JAX caches by
``convert.model_cache_from_jax``.

Here, on the CPU, the port's SSD scan is K7's plain version and its
prefill attention K5's; the JAX model runs its own ``jnp`` scan and
``blocked_attention``.

Tolerances: in float32, logits within atol 1e-4 and cache leaves within
rtol and atol 1e-5 (two layers of the same fp32 arithmetic in another
order; measured up to 3e-6). In bfloat16 (the configs' own compute type),
XLA and torch round at other places (the conv taps, silu, the residual
adds), and every leaf is held within 2% of its norm (measured up to 1.2%)
and elementwise within 4 bf16 ulps of its largest |value| for the leaves
in bf16 (measured up to 2.2), 8 for the fp32 ones, the logits and the SSM
state, which sum many bf16 inputs (measured up to 5.6, on the state). The
greedy tokens are equal.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.serve import make_decode_step as j_make_decode_step
from repro.serve import make_prefill_step as j_make_prefill_step
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models.transformer import Model
from repro_torch.serve import make_decode_step, make_prefill_step

ARCHS = ["mamba2-780m", "hymba-1.5b", "starcoder2-7b", "qwen3-moe-30b-a3b",
         "phi3.5-moe-42b-a6.6b", "seamless-m4t-medium", "internvl2-76b"]
#: the batch key of each frontend family's stub embeddings
STUBS = {"audio": "frame_embeds", "encdec": "frame_embeds",
         "vlm": "patch_embeds"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arch, dtype="float32", **build):
    """Both models of one reduced config in ``dtype``, the JAX weights in
    each."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)),
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype=dtype)
    jm = j_build_model(jcfg, **build)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu", **build)
    tparams = convert.model_params_from_jax(jax.tree.map(np.asarray,
                                                         jparams))
    return jcfg, jm, jparams, tm, tparams


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _inputs(cfg, toks, seed=0):
    """The prompt batch of ``toks`` [B, S] for both packages: the family's
    stub embeddings beside them (normal x 0.02 from ``default_rng(seed +
    100)``), none for the families without a frontend."""
    batch = {"tokens": toks}
    key = STUBS.get(cfg.family)
    if key is not None:
        batch[key] = (np.random.default_rng(seed + 100).normal(
            size=(toks.shape[0], cfg.frontend_tokens, cfg.d_model))
            * 0.02).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _prefix(cfg):
    """The positions ahead of the tokens: the VLM's patches."""
    return cfg.frontend_tokens if cfg.family == "vlm" else 0


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
    wide = _is_fp32(got) and _is_fp32(want)
    assert float(np.abs(a - b).max()) <= (8 if wide else 4) * ulp


def _is_fp32(x):
    return x.dtype in (torch.float32, np.float32, jnp.float32)


def _logits_close(got, want, vocab, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got)[..., :vocab],
                                   _np(want)[..., :vocab], rtol=0,
                                   atol=1e-4)
    else:
        _close(got[..., :vocab], want[..., :vocab], dtype)


# ------------------------------------------------------------ the cache
@pytest.mark.parametrize("arch,bits", [
    ("mamba2-780m", 16), ("hymba-1.5b", 16), ("hymba-1.5b", 8),
    ("starcoder2-7b", 16), ("command-r-35b", 8), ("seamless-m4t-medium", 8),
    ("internvl2-76b", 16)])
@pytest.mark.parametrize("cache_len", [24, 100])
def test_init_cache_matches_the_jax_cache(arch, bits, cache_len):
    """Every leaf of ``init_cache`` in the JAX name, shape and dtype, all
    zero, with ``pos`` a 0-dim int32 zero; a window arch's cache is at
    most ``window`` long."""
    jcfg = j_reduced(j_get_config(arch))
    jc = j_build_model(jcfg, kv_cache_bits=bits).init_cache(3, cache_len)
    tm = build_model(reduced(get_config(arch)), kv_cache_bits=bits,
                     device="cpu")
    tc = tm.init_cache(3, cache_len)
    assert set(tc["layers"]) == set(jc["layers"])
    for k, v in jc["layers"].items():
        t = tc["layers"][k]
        assert tuple(t.shape) == tuple(v.shape), k
        assert str(t.dtype).replace("torch.", "") == str(v.dtype), k
        assert not bool(t.any())
    assert tc["pos"].dtype == torch.int32 and tc["pos"].dim() == 0
    assert int(tc["pos"]) == 0
    assert tm.cache_len_for(cache_len) == j_build_model(jcfg) \
        .cache_len_for(cache_len)


# ------------------------------------------------------------ prefill
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(arch, dtype):
    """The last token's logits and every cache leaf after a prefill of
    2 x 64 tokens (hymba keeps the last 32 keys of its window; the VLM's
    16 patches come first)."""
    jcfg, jm, jp, tm, tp = _pair(arch, dtype)
    f = _prefix(jcfg)
    jb, tb = _inputs(jcfg, _tokens(jcfg, 2, 64))
    jl, jc = jm.prefill(jp, jb, max_len=65 + f)
    tl, tc = tm.prefill(tp, tb, max_len=65 + f)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _logits_close(tl, jl, jcfg.vocab_size, dtype)
    assert int(tc["pos"]) == int(jc["pos"]) == 64 + f
    assert set(tc["layers"]) == set(jc["layers"])
    for k, v in jc["layers"].items():
        _close(tc["layers"][k], v, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_continues_a_jax_prefill(arch, dtype):
    """A JAX prefill carried into the port by ``model_cache_from_jax``,
    then two decode steps in each package: the logits and every cache
    leaf after them."""
    jcfg, jm, jp, tm, tp = _pair(arch, dtype)
    f = _prefix(jcfg)
    toks = _tokens(jcfg, 2, 34, seed=1)
    _, jc = jm.prefill(jp, _inputs(jcfg, toks[:, :32], seed=1)[0],
                       max_len=40 + f)
    tc = convert.model_cache_from_jax(jax.tree.map(np.asarray, jc),
                                      device="cpu")
    for k, v in jc["layers"].items():
        assert np.array_equal(_np(tc["layers"][k]), _np(v)), k
    for t in (32, 33):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), tc)
        _logits_close(tl, jl, jcfg.vocab_size, dtype)
    assert int(tc["pos"]) == int(jc["pos"]) == 34 + f
    for k, v in jc["layers"].items():
        _close(tc["layers"][k], v, dtype)


def test_streaming_prefill_matches_jax_and_the_whole_prefill():
    """mamba2: ``prefill_streaming`` of 2 x 64 tokens in chunks of 16
    against JAX's, and against the port's whole prefill (the state
    carried through the scan's ``init_state``); a hybrid is refused, as
    in JAX."""
    jcfg, jm, jp, tm, tp = _pair("mamba2-780m")
    toks = _tokens(jcfg, 2, 64, seed=2)
    jl, jc = jm.prefill_streaming(jp, {"tokens": jnp.asarray(toks)},
                                  chunk=16)
    tl, tc = tm.prefill_streaming(tp, {"tokens": torch.from_numpy(toks)},
                                  chunk=16)
    _logits_close(tl, jl, jcfg.vocab_size, "float32")
    assert int(tc["pos"]) == int(jc["pos"]) == 64
    for k, v in jc["layers"].items():
        _close(tc["layers"][k], v, "float32")
    wl, wc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=65)
    _logits_close(tl, wl, jcfg.vocab_size, "float32")
    for k, v in wc["layers"].items():
        _close(tc["layers"][k], v, "float32")
    with pytest.raises(ValueError, match="multiple"):
        tm.prefill_streaming(tp, {"tokens": torch.from_numpy(toks[:, :40])},
                             chunk=16)
    _, _, _, hm, hp = _pair("hymba-1.5b")
    with pytest.raises(ValueError, match="SSM-only"):
        hm.prefill_streaming(hp, {"tokens": torch.from_numpy(toks)})


# ----------------------------------------------------- teacher forcing
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """``test_models_smoke.py``'s identity in the port, in bf16: prefill 31
    tokens, decode the 32nd, and the argmax equals that of the teacher-
    forced logits at the last position."""
    _, _, _, tm, tp = _pair(arch, "bfloat16")
    cfg = tm.cfg
    f = _prefix(cfg)
    batch = _inputs(cfg, _tokens(cfg, 2, 32))[1]
    toks = batch["tokens"]
    full, _ = tm.train_logits(tp, batch)
    _, cache = tm.prefill(tp, dict(batch, tokens=toks[:, :-1]),
                          max_len=32 + f)
    dl, cache2 = tm.decode_step(tp, toks[:, -1:], cache)
    a = _np(full[:, -1, :cfg.vocab_size])
    d = _np(dl[:, 0, :cfg.vocab_size])
    assert (a.argmax(-1) == d.argmax(-1)).all()
    assert int(cache2["pos"]) == 32 + f


@pytest.mark.parametrize("s,aligned", [(40, False), (64, True)])
def test_hybrid_ring_is_aligned_only_at_multiples_of_the_window(s, aligned):
    """A JAX fault the port reproduces (ROADMAP Queue 3): the hybrid
    prefill keeps a longer prompt's last ``window`` keys in slots
    0..window-1, and decode writes position ``pos`` at ``pos % window``.
    At 40 tokens with window 32 the ring is misaligned, decode evicts a
    newer key than the oldest, and prefill + decode misses teacher forcing
    (JAX 0.08761, port 0.08761 here, of |logits| up to 3.2); at 64 it is
    aligned and both agree with it (2.5e-6 and 1.4e-6). fp32 compute."""
    jcfg, jm, jp, tm, tp = _pair("hymba-1.5b", "float32")
    assert jcfg.attn_window == 32
    toks = _tokens(jcfg, 2, s + 1, seed=3)
    v = jcfg.vocab_size
    jfull, _ = jm.train_logits(jp, {"tokens": jnp.asarray(toks)})
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :-1])},
                       max_len=s + 1)
    jd, _ = jm.decode_step(jp, jnp.asarray(toks[:, -1:]), jc)
    tfull, _ = tm.train_logits(tp, {"tokens": torch.from_numpy(toks)})
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :-1])},
                       max_len=s + 1)
    td, _ = tm.decode_step(tp, torch.from_numpy(toks[:, -1:]), tc)
    _logits_close(td, jd, v, "float32")
    _logits_close(tfull[:, -1:], jfull[:, -1:], v, "float32")
    j_err = float(np.abs(_np(jd) - _np(jfull[:, -1:]))[..., :v].max())
    t_err = float(np.abs(_np(td) - _np(tfull[:, -1:]))[..., :v].max())
    if aligned:
        assert j_err < 1e-4 and t_err < 1e-4
    else:
        assert j_err > 0.05 and t_err > 0.05
        assert abs(j_err - t_err) < 1e-4


# ---------------------------------------------------------------- int8
@pytest.mark.parametrize("arch", ["command-r-35b", "hymba-1.5b"])
def test_int8_kv_cache_decode_parity(arch):
    """``test_models_smoke.py``'s int8 parity in the port (the int8 decode
    agrees with the 16-bit decode on at least 99% of the argmaxes and
    within atol 0.35, rtol 0.1), and the port's int8 cache and decode
    against the JAX package's own int8 run."""
    _, jm8, jp, _, tp = _pair(arch, "bfloat16", kv_cache_bits=8)
    cfg = jm8.cfg
    m16 = build_model(reduced(get_config(arch)), device="cpu")
    m8 = build_model(reduced(get_config(arch)), kv_cache_bits=8,
                     device="cpu")
    toks = _tokens(cfg, 2, 24)
    pre = {"tokens": torch.from_numpy(toks[:, :-1])}
    _, c16 = m16.prefill(tp, pre, max_len=24)
    _, c8 = m8.prefill(tp, pre, max_len=24)
    assert c8["layers"]["k"].dtype == torch.int8
    last = torch.from_numpy(toks[:, -1:])
    l16, _ = m16.decode_step(tp, last, c16)
    l8, c8b = m8.decode_step(tp, last, c8)
    a = _np(l16[:, 0, :cfg.vocab_size])
    b = _np(l8[:, 0, :cfg.vocab_size])
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= 0.99
    np.testing.assert_allclose(a, b, atol=0.35, rtol=0.1)
    _, jc8 = jm8.prefill(jp, {"tokens": jnp.asarray(toks[:, :-1])},
                         max_len=24)
    jl8, jc8 = jm8.decode_step(jp, jnp.asarray(toks[:, -1:]), jc8)
    _logits_close(l8, jl8, cfg.vocab_size, "bfloat16")
    for k in ("k", "v"):
        # the int8 codes move by a step where the bf16 K/V or their scales
        # differ (measured on 11-13% of the codes, by at most 2 steps); the
        # dequantized values are held as bf16 leaves
        sc, jsc = c8b["layers"][f"{k}_scale"], jc8["layers"][f"{k}_scale"]
        _close(sc, jsc, "bfloat16")
        _close(c8b["layers"][k].float() * sc.float()[..., None],
               np.asarray(jc8["layers"][k], np.float32)
               * np.asarray(jsc, np.float32)[..., None], "bfloat16")


# -------------------------------------------- steps and the entry point
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax(arch):
    """``make_prefill_step`` then three ``make_decode_step`` steps, greedy,
    tokens in and tokens out, against the JAX factories (fp32)."""
    jcfg, jm, jp, tm, tp = _pair(arch)
    cap = 40 + _prefix(jcfg)
    jb, tb = _inputs(jcfg, _tokens(jcfg, 2, 32, seed=4), seed=4)
    jpre, jdec = j_make_prefill_step(jm, max_len=cap), j_make_decode_step(jm)
    tpre, tdec = make_prefill_step(tm, max_len=cap), make_decode_step(tm)
    jt, jc = jpre(jp, jb)
    tt, tc = tpre(tp, tb)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (2, 1)
    got, want = [tt.numpy()], [np.asarray(jt)]
    for _ in range(3):
        jt, jc = jdec(jp, jt, jc)
        tt, tc = tdec(tp, tt, tc)
        got.append(tt.numpy())
        want.append(np.asarray(jt))
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


def test_launch_serve_matches_the_jax_entry_point(monkeypatch, capsys):
    """``launch.serve.main`` at its default config (reduced mamba2-780m, 4
    prompts of 64 tokens, 32 new) prints the JAX entry point's sample
    continuation ids, from the JAX weights; and ``--smoke`` cannot be
    turned off in either (``store_true`` with default True, ROADMAP Queue
    3)."""
    import repro.launch.serve as JSV
    from repro_torch.launch import serve as LS
    monkeypatch.setattr(sys, "argv", ["serve"])
    JSV.main()
    jout = capsys.readouterr().out
    jids = jout.split("sample continuation ids: ")[1].strip()
    jparams = j_build_model(j_reduced(j_get_config("mamba2-780m"))).init(
        jax.random.PRNGKey(0))
    want = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams))
    orig = Model.init

    def init_from_jax(self, generator):
        params = orig(self, generator)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(want[name])
        return params

    monkeypatch.setattr(Model, "init", init_from_jax)
    ids = LS.main([], device="cpu")
    tout = capsys.readouterr().out
    assert ids.shape == (4, 32)
    assert tout.split("sample continuation ids: ")[1].strip() == jids
    assert "mamba2-780m-smoke: prefill 4x64" in tout
    seen = []
    monkeypatch.setattr(LS, "serve", lambda cfg, **kw: seen.append(cfg.name))
    LS.main(["--arch", "hymba-1.5b", "--smoke"])
    LS.main(["--arch", "hymba-1.5b"])
    assert seen == ["hymba-1.5b-smoke"] * 2


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_convert_round_trips_ssm_and_hybrid_trees(arch):
    """``model_params_from_jax`` / ``model_params_to_jax`` over an SSM and
    a hybrid parameter tree (``A_log`` beside ``z.w`` in one node): bit
    for bit, and in ``init``'s names and shapes."""
    jcfg, jm, jp, tm, tp = _pair(arch)
    want = jax.tree.map(np.asarray, jp)
    back = convert.model_params_to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    params = tm.init(torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: tuple(t.shape) for n, t in tp.items()}


def test_launch_serve_moe_matches_the_jax_entry_point(monkeypatch, capsys):
    """``launch.serve.main(["--arch", "qwen3-moe-30b-a3b"])`` (the reduced
    config: 8 experts, top-2; 4 prompts of 64 tokens, 32 new) prints the
    JAX entry point's sample continuation ids from the JAX weights. The
    prefill's 256 tokens pass the capacity (128), so tokens are dropped;
    each decode step's 4 are not. Both entry points serve the reduced
    config in float32 compute here: in its own bf16 the greedy ids part at
    the fifth token (a near tie that one rounding turns), as any two bf16
    implementations may."""
    import repro.launch.serve as JSV
    from repro_torch.launch import serve as LS
    from repro_torch.models import moe as TM
    arch = "qwen3-moe-30b-a3b"
    cfg = reduced(get_config(arch))
    assert TM._capacity(4 * 64, cfg) == 128 and TM._capacity(4, cfg) == 4
    monkeypatch.setattr(JSV, "reduced", lambda c: dataclasses.replace(
        j_reduced(c), compute_dtype="float32"))
    monkeypatch.setattr(LS, "reduced", lambda c: dataclasses.replace(
        reduced(c), compute_dtype="float32"))
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    JSV.main()
    jids = capsys.readouterr().out.split("sample continuation ids: ")[1]
    jparams = j_build_model(j_reduced(j_get_config(arch))).init(
        jax.random.PRNGKey(0))
    want = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams))
    orig = Model.init

    def init_from_jax(self, generator):
        params = orig(self, generator)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(want[name])
        return params

    monkeypatch.setattr(Model, "init", init_from_jax)
    ids = LS.main(["--arch", arch], device="cpu")
    tout = capsys.readouterr().out
    assert ids.shape == (4, 32)
    assert f"{arch}-smoke: prefill 4x64" in tout
    assert tout.split("sample continuation ids: ")[1].strip() == \
        jids.strip()


@pytest.mark.parametrize("arch,dtype", [("seamless-m4t-medium", "bfloat16"),
                                        ("internvl2-76b", "float32")])
def test_launch_serve_frontends_match_the_jax_entry_point(arch, dtype,
                                                          monkeypatch,
                                                          capsys):
    """``launch.serve.main(["--arch", arch])`` for the audio and VLM
    families (reduced; 4 prompts of 64 tokens, 32 new): the stub frame or
    patch embeddings it draws after the tokens from ``default_rng(0)``
    (normal x 0.02 in bf16) equal the JAX entry point's draw bit for bit,
    and it prints the JAX entry point's sample continuation ids from the
    JAX weights. The audio config serves in its own bf16; the VLM in
    float32 compute in both entry points, because in bf16 the greedy ids
    part at the twelfth token (a near tie that one rounding turns, as the
    MoE case above), while its bf16 logits are held to JAX's in
    ``test_prefill_matches_jax`` and ``test_torch_vlm.py``."""
    import repro.launch.serve as JSV
    from repro_torch.launch import serve as LS
    monkeypatch.setattr(JSV, "reduced", lambda c: dataclasses.replace(
        j_reduced(c), compute_dtype=dtype))
    monkeypatch.setattr(LS, "reduced", lambda c: dataclasses.replace(
        reduced(c), compute_dtype=dtype))
    cfg = reduced(get_config(arch))
    key = STUBS[cfg.family]
    # the JAX entry point's draw (``launch/serve.py``): tokens, then these
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, (4, 64))
    seen = {"jax": np.asarray(jnp.asarray(jnp.asarray(
        rng.normal(size=(4, cfg.frontend_tokens, cfg.d_model)) * 0.02,
        jnp.bfloat16), jnp.float32))}
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    JSV.main()
    jids = capsys.readouterr().out.split("sample continuation ids: ")[1]
    jparams = j_build_model(j_reduced(j_get_config(arch))).init(
        jax.random.PRNGKey(0))
    want = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams))
    orig_init, orig_prefill = Model.init, Model.prefill

    def init_from_jax(self, generator):
        params = orig_init(self, generator)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(want[name])
        return params

    def prefill(self, params, batch, **kw):
        assert batch[key].dtype == torch.bfloat16
        seen["torch"] = batch[key].float().numpy()
        return orig_prefill(self, params, batch, **kw)

    monkeypatch.setattr(Model, "init", init_from_jax)
    monkeypatch.setattr(Model, "prefill", prefill)
    ids = LS.main(["--arch", arch], device="cpu")
    tout = capsys.readouterr().out
    assert seen["torch"].shape == (4, 16, 256)
    np.testing.assert_array_equal(seen["torch"], seen["jax"])
    assert ids.shape == (4, 32)
    assert f"{arch}-smoke: prefill 4x64" in tout
    assert tout.split("sample continuation ids: ")[1].strip() == \
        jids.strip()
