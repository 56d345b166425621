"""The port's flash attention backward (K6's plain version, and the
differentiable ``ops.flash_attention_vjp``) against the JAX package's
``flash_attention_vjp``, whose backward is the Pallas kernel run in
interpret mode as ``tests/test_kernels.py`` runs it, and against
``torch.autograd`` through the float32 oracle ``ref_flash_attention``.

Here, on the CPU, the wrappers take the plain versions (they choose by
the tensor's device); the CUDA kernel is held against the plain version on
the card (``tests/test_torch_flash_bwd_gpu.py``, ``chip_smoke.py``).

Tolerances: against JAX rtol and atol 2e-4 in fp32, the JAX test's own
bound between its kernel and autodiff through the reference (both sides
compute in fp32; the Pallas backward sums dK and dV per head, then over the
group). Against autograd through the torch oracle 2e-5 (the same math in
another order). The sizes are ones the JAX wrapper takes: ``_fa_fwd`` does
not shrink its blocks to divide S (``ops.py:343-348``), and the Pallas
backward asserts that they do (``flash_attention_bwd.py:128``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention_vjp as j_vjp
from repro_torch.kernels import flash_attention_vjp
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd_cuda, flash_attention_bwd_plain,
)
from repro_torch.kernels.ref import ref_flash_attention

JAX_TOL = 2e-4
TORCH_TOL = 2e-5

# b, sq, sk, h, hkv, d, causal, window: the four cases of
# test_kernels.py::test_flash_attention_vjp_grads_match_ref, then
# starcoder2-7b's group (G = 9, D = 128) and hymba-1.5b's (G = 5, window)
CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (2, 128, 128, 4, 4, 64, False, 0),
    (2, 128, 128, 4, 2, 64, True, 64),
    (2, 128, 128, 4, 1, 64, True, 0),
    (1, 128, 128, 18, 2, 128, True, 0),
    (1, 128, 128, 10, 2, 64, True, 32),
]


def _inputs(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32))


def _leaves(arrays, dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", CASES)
def test_vjp_grads_match_jax(b, sq, sk, h, hkv, d, causal, window):
    """jax.grad of sum(o**2) through the JAX flash_attention_vjp (Pallas
    forward and backward, interpret mode) against the port's gradient of
    the same loss through ops.flash_attention_vjp (K5 and K6's plain
    versions on the CPU)."""
    arrays = _inputs(sq + h + hkv + window, b, sq, sk, h, hkv, d)

    def f(q, k, v):
        return jnp.sum(j_vjp(q, k, v, causal, window, 64, 64) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    leaves = _leaves(arrays)
    o = flash_attention_vjp(*leaves, causal=causal, window=window)
    got = torch.autograd.grad((o ** 2).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=JAX_TOL,
                                   atol=JAX_TOL)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", CASES + [
    (1, 96, 160, 4, 2, 32, True, 0),        # Sq < Sk
    (1, 160, 96, 4, 1, 32, True, 0),        # Sq > Sk
    (1, 128, 128, 4, 2, 32, False, 48),     # window without causal
])
def test_plain_backward_matches_autograd_through_the_oracle(
        b, sq, sk, h, hkv, d, causal, window):
    """K6's plain version, fed K5's o and lse, against torch.autograd
    through the float32 oracle (which materializes the softmax)."""
    arrays = _inputs(sq * 3 + sk + h, b, sq, sk, h, hkv, d)
    leaves = _leaves(arrays)
    o = ref_flash_attention(*leaves, causal=causal, window=window)
    do = torch.tensor(np.random.default_rng(5).normal(size=o.shape),
                      dtype=torch.float32)
    want = torch.autograd.grad(o, leaves, do)
    q, k, v = (t.detach() for t in leaves)
    o, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    got = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                    window=window)
    for g, w, t in zip(got, want, leaves):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TORCH_TOL,
                                   atol=TORCH_TOL)
    # the wrapper takes the plain version for a CPU tensor
    same = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                    window=window)
    assert all(torch.equal(x, y) for x, y in zip(same, got))


@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, 0, 12, 12), (False, 0, 8, 12), (True, 4, 12, 12),
    (False, 5, 12, 8),
])
def test_gradcheck_float64(causal, window, sq, sk):
    """torch.autograd.gradcheck of the autograd.Function (plain forward,
    plain K6 backward) in float64 on a tiny shape with G = 2."""
    rng = np.random.default_rng(sq + sk + window)
    leaves = [torch.tensor(rng.normal(size=s), dtype=torch.float64,
                           requires_grad=True)
              for s in ((1, sq, 4, 8), (1, sk, 2, 8), (1, sk, 2, 8))]
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention_vjp(q, k, v, causal=causal,
                                            window=window), leaves)


def test_row_with_nothing_to_attend_gets_zero_gradient():
    """Causal with a window and Sq > Sk: rows past Sk + window - 1 attend
    to no key (o NaN, lse -inf). The port defines their dq as 0 and lets
    them add nothing to dk or dv, as the JAX backward does (its forward
    masks with -1e30, so its o there is a mean of V and its lse finite);
    the other rows' gradients are those of the oracle restricted to the
    rows that attend."""
    arrays = _inputs(9, 1, 128, 48, 4, 2, 32)
    q, k, v = (torch.tensor(a) for a in arrays)
    o, lse = flash_attention_plain(q, k, v, causal=True, window=16,
                                   return_lse=True)
    live = 48 + 16 - 1
    assert bool(torch.isnan(o[:, live:]).all())
    assert not bool(torch.isnan(o[:, :live]).any())
    do = torch.ones_like(o)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True,
                                           window=16)
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    assert not bool(dq[:, live:].any())
    _, pull = jax.vjp(lambda *a: j_vjp(*a, True, 16, 128, 48),
                      *map(jnp.asarray, arrays))
    jdq = np.asarray(pull(jnp.ones(o.shape, jnp.float32))[0])
    assert not np.any(jdq[:, live:])
    leaves = _leaves((arrays[0][:, :live], arrays[1], arrays[2]))
    ref = ref_flash_attention(*leaves, causal=True, window=16)
    want = torch.autograd.grad(ref, leaves, do[:, :live])
    for g, w in zip((dq[:, :live], dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TORCH_TOL,
                                   atol=TORCH_TOL)


def test_vjp_ref_backend_and_block_sizes():
    """``backend="ref"`` takes the plain versions (the same ones a CPU
    tensor takes), and ``block_q``/``block_k`` are read by neither."""
    arrays = _inputs(2, 1, 96, 96, 4, 2, 32)
    grads = []
    for kw in ({}, {"backend": "ref"}, {"block_q": 32, "block_k": 16}):
        leaves = _leaves(arrays)
        o = flash_attention_vjp(*leaves, **kw)
        grads.append(torch.autograd.grad(o.sum(), leaves))
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))
    with pytest.raises(ValueError):
        flash_attention_vjp(*_leaves(arrays), backend="interpret")


def test_vjp_takes_lengths_the_jax_blocks_do_not_divide():
    """S = 600: the JAX entry point keeps 512-row blocks and asserts that
    they divide S (``_fa_fwd`` does not shrink them, ``ops.py:343-348``);
    the port tiles by 64 and masks the ragged edge, and gives the
    oracle's gradient."""
    arrays = _inputs(600, 1, 600, 600, 2, 1, 32)
    with pytest.raises(AssertionError):
        jax.grad(lambda q: jnp.sum(j_vjp(q, *map(jnp.asarray, arrays[1:]),
                                         True, 0)))(jnp.asarray(arrays[0]))
    leaves = _leaves(arrays)
    got = torch.autograd.grad(flash_attention_vjp(*leaves).sum(), leaves)
    leaves = _leaves(arrays)
    want = torch.autograd.grad(ref_flash_attention(*leaves).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TORCH_TOL,
                                   atol=TORCH_TOL)


def _bf16_ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)),
                     np.abs(b).max() * 2.0 ** -10)
    return float((np.abs(a - b) / np.exp2(np.floor(np.log2(mag)) - 7)).max())


def test_gqa_group_sums_in_fp32_in_bfloat16():
    """bf16 inputs, G = 9, the same (q, k, v, o, do, lse) to both
    backwards: the port sums dk and dv over the group in fp32 and rounds
    once, so all three gradients stay within one bf16 ulp of the same
    function computed in fp32; the JAX wrapper (``_fa_bwd``) rounds each
    head's dk/dv to bf16 before it sums the group (``ops.py:376-377``), and
    lands further from it."""
    from repro.kernels.ops import _fa_bwd
    b, s, h, hkv, d = 1, 128, 18, 2, 128
    arrays = _inputs(13, b, s, s, h, hkv, d)
    q, k, v = (torch.tensor(a).bfloat16() for a in arrays)
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    do = torch.tensor(np.random.default_rng(14).normal(size=o.shape),
                      dtype=torch.float32).bfloat16()
    exact = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                      o.float(), do.float(), lse)
    got = flash_attention_bwd_plain(q, k, v, o, do, lse)

    def jx(t):
        return jnp.asarray(t.float().numpy(), t.dtype == torch.bfloat16
                           and jnp.bfloat16 or jnp.float32)

    jgot = _fa_bwd(True, 0, 64, 64, True, tuple(map(jx, (q, k, v, o, lse))),
                   jx(do))
    for name, g, jg, w in zip("qkv", got, jgot, exact):
        assert g.dtype == torch.bfloat16
        ours = _bf16_ulps(g.float(), w)
        assert ours <= 1.0, name
        if name != "q":
            assert _bf16_ulps(jg, w) > 1.0, name
