"""The SSD scan (K7's plain version) and the port's ``models/ssm.py``
against the JAX package, on the same numpy inputs.

The JAX side runs as its own tests run it: ``ops.ssd_chunk_scan`` with
the Pallas kernel in interpret mode, ``ref_ssd_chunk_scan`` and
``models/ssm.py`` in plain JAX. Here, on the CPU, the port's scan takes
K7's plain version (the chunked algorithm in plain torch).

Tolerances: in float32, the scans within rtol and atol 1e-5 (the same
sums in another order and chunking; the JAX package's own tests allow
1e-4), the SSD block within 1e-5 and 1e-4 of |value| 1; in bfloat16, the
block and its decode step within 2% of the output's norm and 4 bf16 ulps
of the largest |value| elementwise (measured up to 0.7% and 2 ulps: XLA
and torch round the conv taps, silu and the D term at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.kernels import ref as JR
from repro.kernels.ops import ssd_chunk_scan as j_ssd_chunk_scan
from repro.models import ssm as JS
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
from repro_torch.models import ssm as TS


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32) * 0.1,
            -np.abs(rng.normal(size=(b, s, h))).astype(np.float32) * 0.1,
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, h, p, n)).astype(np.float32))


def _bf16_close(got, want, rel=0.02, ulps=4):
    """Within ``rel`` of the norm, and ``ulps`` bf16 ulps of the largest
    |value| elementwise."""
    a, b = _np(got), _np(want)
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b)
    top = float(np.abs(b).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float(np.abs(a - b).max()) <= ulps * ulp


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("b,s,h,p,n,chunk,hb", [
    (1, 128, 4, 32, 16, 64, 4),
    (2, 256, 8, 32, 16, 64, 4),
    (2, 256, 8, 64, 32, 128, 8),
])
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_plain_matches_jax_interpret_sweep(b, s, h, p, n, chunk, hb,
                                           backend):
    """``test_kernels.py``'s SSD sweep: the JAX Pallas kernel in interpret
    mode against ``ops.ssd_chunk_scan`` (on the CPU both backends take the
    plain version)."""
    xdt, a, B, C, _ = _inputs(b, s, h, p, n)
    want = j_ssd_chunk_scan(*map(jnp.asarray, (xdt, a, B, C)), chunk=chunk,
                            head_block=hb, backend="interpret")
    got = ops.ssd_chunk_scan(xdt, a, B, C, chunk=chunk, head_block=hb,
                             backend=backend, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(192, 64), (200, 64), (37, 256)],
                         ids=["whole-chunks", "ragged-tail", "one-short"])
def test_plain_matches_the_sequential_oracle_with_a_state(s, chunk):
    """K7's plain version from a nonzero ``init_state`` against JAX's
    ``ref_ssd_chunk_scan`` (the token-by-token recurrence), y and the
    final state, and the port's own copy of that oracle against it."""
    xdt, a, B, C, h0 = _inputs(2, s, 4, 16, 8, seed=1)
    yr, sr = JR.ref_ssd_chunk_scan(*map(jnp.asarray, (xdt, a, B, C)), chunk,
                                   init_state=jnp.asarray(h0))
    y, st = ssd_scan_plain(_t(xdt), _t(a), _t(B), _t(C), chunk=chunk,
                           init_state=_t(h0))
    np.testing.assert_allclose(_np(y), _np(yr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(st), _np(sr), rtol=1e-5, atol=1e-5)
    y2, st2 = TR.ref_ssd_chunk_scan(_t(xdt), _t(a), _t(B), _t(C), chunk,
                                    init_state=_t(h0))
    np.testing.assert_allclose(_np(y2), _np(yr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(st2), _np(sr), rtol=1e-5, atol=1e-5)


def test_plain_carries_the_state_across_calls():
    """Two calls, the second from the first's final state, give the one
    call's y and state: what the streaming prefill relies on."""
    xdt, a, B, C, h0 = _inputs(1, 160, 3, 16, 8, seed=2)
    T = [_t(x) for x in (xdt, a, B, C)]
    y, st = ssd_scan_plain(*T, chunk=64, init_state=_t(h0))
    y1, s1 = ssd_scan_plain(*(x[:, :96] for x in T), chunk=64,
                            init_state=_t(h0))
    y2, s2 = ssd_scan_plain(*(x[:, 96:] for x in T), chunk=64,
                            init_state=s1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s2), _np(st), rtol=1e-5, atol=1e-5)


def test_ops_scan_masks_a_tail_the_jax_kernel_refuses():
    """The JAX kernel asserts ``s % chunk == 0`` (``ssd_scan.py:75``): 100
    tokens in chunks of 64 raise there. The port masks the tail and gives
    the sequential oracle's y (ROADMAP Queue 3)."""
    xdt, a, B, C, _ = _inputs(1, 100, 4, 16, 8, seed=3)
    with pytest.raises(AssertionError):
        j_ssd_chunk_scan(*map(jnp.asarray, (xdt, a, B, C)), chunk=64,
                         backend="interpret")
    yr, _ = JR.ref_ssd_chunk_scan(*map(jnp.asarray, (xdt, a, B, C)), 64)
    got = ops.ssd_chunk_scan(xdt, a, B, C, chunk=64, device="cpu")
    np.testing.assert_allclose(_np(got), _np(yr), rtol=1e-5, atol=1e-5)


def test_scan_is_forward_only_on_every_device():
    """K7 has no backward, as ``ssd_scan_pallas`` has no VJP: a gradient
    through it raises, here on the CPU as on the card."""
    xdt, a, B, C, _ = _inputs(1, 32, 2, 16, 8)
    x = _t(xdt).requires_grad_(True)
    y, _ = ssd_scan_cuda(x, _t(a), _t(B), _t(C), chunk=16)
    assert y.requires_grad
    with pytest.raises(NotImplementedError, match="forward-only"):
        y.sum().backward()
    with pytest.raises(NotImplementedError):
        TS.ssd_scan(x, _t(a), _t(B), _t(C), 16)[0].sum().backward()


# ------------------------------------------------------------ the block
def _cfgs(arch, dtype):
    return (dataclasses.replace(j_reduced(j_get_config(arch)),
                                compute_dtype=dtype),
            dataclasses.replace(reduced(get_config(arch)),
                                compute_dtype=dtype))


def _block_params(jcfg, seed=0):
    """JAX ``ssd_init`` weights with every leaf moved off its init (the
    convolutions' taps too, which init passes through), as numpy, and the
    port's copy."""
    params = JS.ssd_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)[0]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape)
        .astype(np.float32), params)
    return params, jax.tree.map(_t, params)


def _state_pair(jcfg, b, seed):
    """An SSM state and conv tail in both packages."""
    from repro.models.ssm import ssm_dims
    _, nh, p, n = ssm_dims(jcfg)
    cw = jcfg.ssm.conv_width
    rng = np.random.default_rng(seed)
    ssm = rng.normal(size=(b, nh, p, n)).astype(np.float32) * 0.5
    conv = {"x": rng.normal(size=(b, cw - 1, nh, p)).astype(np.float32),
            "B": rng.normal(size=(b, cw - 1, n)).astype(np.float32),
            "C": rng.normal(size=(b, cw - 1, n)).astype(np.float32)}
    return ssm, conv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 40])
def test_model_ssd_scan_matches_jax(dtype, s):
    """``models/ssm.ssd_scan`` (K7's plain version here) against the JAX
    chunked scan, from a nonzero state, on inputs in the compute type; at
    40 tokens the JAX scan halves its chunk to 8 and the port masks a
    tail of its 32."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    xdt, a, B, C, h0 = _inputs(2, s, 4, 16, 8, seed=4)
    yj, sj = JS.ssd_scan(jnp.asarray(xdt).astype(jd), jnp.asarray(a),
                         jnp.asarray(B).astype(jd), jnp.asarray(C).astype(jd),
                         32, init_state=jnp.asarray(h0))
    y, st = TS.ssd_scan(_t(xdt).to(td), _t(a), _t(B).to(td), _t(C).to(td),
                        32, init_state=_t(h0))
    assert y.dtype == td and st.dtype == torch.float32
    np.testing.assert_allclose(_np(st), _np(sj), rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), _np(yj), rtol=1e-5, atol=1e-5)
    else:
        # both compute in fp32 and round y once: within one bf16 ulp
        a_, b_ = _np(y), _np(yj)
        mag = np.maximum(np.maximum(np.abs(a_), np.abs(b_)), 2.0 ** -10)
        assert float((np.abs(a_ - b_) / np.exp2(np.floor(np.log2(mag))
                                                - 7)).max()) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "continued"])
def test_ssd_forward_matches_jax(dtype, with_state):
    """The whole block over 48 tokens, and with ``init_state`` and a
    ``conv_state`` to continue from; the returned state and conv tail
    too (reduced mamba2-780m; reduced hymba-1.5b has the same block)."""
    jcfg, tcfg = _cfgs("mamba2-780m", dtype)
    jp, tp = _block_params(jcfg)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 48, jcfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if with_state:
        ssm, conv = _state_pair(jcfg, 2, 6)
        kw_j = dict(init_state=jnp.asarray(ssm),
                    conv_state={k: jnp.asarray(v).astype(jd)
                                for k, v in conv.items()})
        kw_t = dict(init_state=_t(ssm),
                    conv_state={k: _t(v).to(td) for k, v in conv.items()})
    yj, stj = JS.ssd_forward(jp, jnp.asarray(x).astype(jd), jcfg,
                             return_state=True, **kw_j)
    y, st = TS.ssd_forward(tp, _t(x).to(td), tcfg, return_state=True,
                           **kw_t)
    assert y.dtype == td
    pairs = [(y, yj), (st["ssm"], stj["ssm"])] + [
        (st["conv"][k], stj["conv"][k]) for k in ("x", "B", "C")]
    for got, want in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-4)
        else:
            _bf16_close(got, want)
    y2, none = TS.ssd_forward(tp, _t(x).to(td), tcfg, **kw_t)
    assert none is None and torch.equal(y2, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_matches_jax(dtype):
    """The single-token step from a state and conv tail: its output, the
    new state and the shifted tail."""
    jcfg, tcfg = _cfgs("mamba2-780m", dtype)
    jp, tp = _block_params(jcfg, seed=1)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ssm, conv = _state_pair(jcfg, 3, 7)
    x = np.random.default_rng(8).normal(size=(3, 1, jcfg.d_model)) \
        .astype(np.float32)
    yj, nj = JS.ssd_decode(jp, jnp.asarray(x).astype(jd), jcfg, state={
        "ssm": jnp.asarray(ssm),
        "conv": {k: jnp.asarray(v).astype(jd) for k, v in conv.items()}})
    y, nt = TS.ssd_decode(tp, _t(x).to(td), tcfg, state={
        "ssm": _t(ssm), "conv": {k: _t(v).to(td) for k, v in conv.items()}})
    pairs = [(y, yj), (nt["ssm"], nj["ssm"])] + [
        (nt["conv"][k], nj["conv"][k]) for k in ("x", "B", "C")]
    for got, want in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-4)
        else:
            _bf16_close(got, want)


def test_ssd_init_draws_the_jax_shapes():
    """``ssd_init`` gives the JAX leaves in the JAX shapes, A < 0, dt_bias
    the inverse softplus of [1e-3, 1e-1], and pass-through convs."""
    jcfg, tcfg = _cfgs("mamba2-780m", "bfloat16")
    want = jax.tree.map(lambda p: tuple(p.shape),
                        JS.ssd_init(jax.random.PRNGKey(0), jcfg,
                                    jnp.float32)[0])
    got = TS.ssd_init(torch.Generator().manual_seed(0), tcfg, torch.float32,
                      "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    a_log = got["A_log"]
    assert bool(((a_log >= 0) & (a_log <= np.log(16.0) + 1e-6)).all())
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert bool(((dt > 0.9e-3) & (dt < 1.1e-1)).all())
    assert float(got["conv_x"][-1].min()) == 1.0
    assert float(got["conv_x"][:-1].abs().max()) == 0.0
