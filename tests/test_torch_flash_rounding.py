"""The bf16 limits of the tensor-core flash kernels, anchored on the JAX
Pallas kernels' own error.

The wgmma design of K5 and K6 rounds P (and dS) to bf16 before its
product, where ``flash_attention_pallas`` (``p.astype(v.dtype)``) and
``flash_attention_bwd_pallas`` (``p.astype(do.dtype)``,
``ds.astype(q.dtype)``, ``ds.astype(k.dtype)``) round them. So the limits
that ``chip_smoke.py`` and the ``gpu`` tests hold the kernels to on the
card (``repro_torch.kernels.flash_limits``) are read here off the Pallas
kernels, run in interpret mode as ``tests/test_kernels.py`` runs them, on
bf16 inputs made with numpy, against the float32 oracle (the port's plain
versions on the same bf16 values): the worst row's norm-relative error
of o, dq, dk and dv, and their elementwise bf16 ulps (with the CUDA-core
checks' floors). Each norm-relative limit must lie between 1x and 3x the
Pallas reading of every case: no tighter than what the TPU kernel itself
computes, no looser than three times it. The elementwise limit must cover
every reading.

The backward is fed the Pallas forward's own o and lse, as K6 is fed
K5's; the Pallas backward takes K and V repeated over the group, and its
per-head dk and dv (bf16, its output type) are summed over the group in
float32 here, as K6 sums the group.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention_bwd import flash_attention_bwd_pallas
from repro_torch.kernels import flash_limits as FL
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_plain

S, H = 1024, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, *shape):
    return torch.tensor(rng.normal(size=shape),
                        dtype=torch.float32).bfloat16()


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _torch(a):
    return torch.tensor(np.asarray(a.astype(jnp.float32)))


def _heads(t, n, d):
    """[1, S, n, D] -> [n, S, D], the Pallas kernels' flattened heads."""
    return t.reshape(1, S, n, d).permute(0, 2, 1, 3).reshape(n, S, d)


def pallas_readings(d, hkv, causal, window, seed=0):
    """{name: (worst row's norm-relative error, elementwise ulps)} of the
    Pallas forward (o) and backward (dq, dk, dv) against the oracle."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(rng, 1, S, n, d) for n in (H, hkv, hkv, H))
    o, lse = flash_attention_pallas(_jax(q), _jax(k), _jax(v), causal=causal,
                                    window=window, block_q=512, block_k=512,
                                    interpret=True, return_lse=True)
    o, lse = _torch(o), torch.tensor(np.asarray(lse))
    ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                causal=causal, window=window)
    out = {"o": (FL.row_error(o, ref), FL.ulp_error(o, ref, 2.0 ** -10))}
    g = H // hkv
    rep = [_jax(torch.repeat_interleave(_heads(t.float(), hkv, d), g, dim=0))
           for t in (k, v)]
    dq, dk, dv = flash_attention_bwd_pallas(
        _jax(_heads(q.float(), H, d)), *rep, _jax(_heads(o, H, d)),
        _jax(_heads(do.float(), H, d)), jnp.asarray(lse.numpy()),
        causal=causal, window=window, block_q=512, block_k=512,
        interpret=True)
    got = (_torch(dq).reshape(1, H, S, d).permute(0, 2, 1, 3),
           _torch(dk).reshape(1, hkv, g, S, d).sum(2).permute(0, 2, 1, 3),
           _torch(dv).reshape(1, hkv, g, S, d).sum(2).permute(0, 2, 1, 3))
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o,
                                     do.float(), lse, causal=causal,
                                     window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        floor = float(b.abs().max()) * 2.0 ** -10
        out[name] = (FL.row_error(a, b), FL.ulp_error(a, b, floor))
    return out


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 256),
                                           (False, 0)])
def test_limits_lie_within_three_times_the_pallas_readings(d, hkv, causal,
                                                           window):
    readings = pallas_readings(d, hkv, causal, window)
    for name, (row, ulps) in readings.items():
        limit = FL.FWD_ROW_RTOL if name == "o" else FL.BWD_ROW_RTOL
        assert row <= limit <= 3 * row, (name, row, limit)
        assert ulps <= FL.ULP_LIMIT, (name, ulps)


def test_row_error_sees_one_bad_row_that_the_whole_tensor_hides():
    """The row check is the sharp one: a single row off by 20% reads 0.2
    however many rows surround it, while the whole tensor's norm-relative
    error dilutes it to below the limit."""
    rng = np.random.default_rng(1)
    ref = torch.tensor(rng.normal(size=(1, 4096, 4, 64)),
                       dtype=torch.float32)
    bad = ref.clone()
    bad[0, 4095, 0] *= 1.2
    assert FL.row_error(bad, ref) == pytest.approx(0.2, rel=1e-5)
    whole = float((bad - ref).norm() / ref.norm())
    assert whole < FL.FWD_ROW_RTOL < FL.row_error(bad, ref) / 10
    assert FL.row_error(ref, ref) == 0.0


def test_errors_count_nan_at_the_same_places_as_equal():
    ref = torch.ones(2, 3, 8)
    ref[0, 1] = float("nan")
    out = ref.clone()
    out[1, 2, 3] += 2.0 ** -7              # one ulp at 1.0 is 2**-7
    assert FL.row_error(out, ref) == pytest.approx(2.0 ** -7 / 8 ** 0.5)
    assert FL.ulp_error(out, ref, 2.0 ** -10) == 1.0
