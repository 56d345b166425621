"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
the JAX package's ``models/moe.py`` on the same numpy inputs, with the JAX
weights carried across by ``convert.model_params_from_jax``.

The JAX function runs its single-device branch (no mesh). Sizes: the
reduced configs' widths (d_model 256, d_ff 512, 8 experts, top-2).

Tolerances: in float32 the output within 1e-5 x (1 + max|y|) and the aux
within 1e-6 relative (the same arithmetic; the products sum in another
order). In bfloat16 the routing is the same float32 arithmetic on the
same bf16 inputs, and each kept token's FFN rounds the three products,
the activation and the gate to bf16 in both packages, at places that
differ by one rounding (XLA rounds ``silu`` as ``x * sigmoid(x)``, two
roundings; torch rounds it once): the output within 2 bf16 ulps of its
largest |value| elementwise (measured up to 1) and 1% of its norm
(measured up to 0.6%). Gradients in float32 within rtol 1e-4 and 1e-5 x
each gradient's largest |value|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import moe as JM
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="qwen3-moe-30b-a3b", **kw):
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _params(jcfg, seed=0):
    """JAX moe_init's tree (float32) and the port's copy of it."""
    p, _ = JM.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    flat = convert.model_params_from_jax(
        {"moe": jax.tree.map(np.asarray, p)})
    return p, TL.nest(flat)["moe"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _run(jcfg, tcfg, jp, tp, x, dtype):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jy, ja = JM.moe_forward(jp, jnp.asarray(x).astype(jd), jcfg)
    ty, ta = TM.moe_forward(tp, torch.from_numpy(x).to(td), tcfg)
    assert ty.dtype == td and ta.dtype == torch.float32
    assert tuple(ty.shape) == jy.shape
    return (_np(jy), float(ja)), (_np(ty), float(ta))


def _bf16_close(got, want):
    assert np.isfinite(got).all()
    ulp = 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)
    assert float(np.abs(got - want).max()) <= 2 * ulp
    assert np.linalg.norm(got - want) <= 0.01 * np.linalg.norm(want)


# ---------------------------------------------------------------- capacity
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [1, 4, 63, 64, 65, 512, 8192])
def test_capacity_matches_jax(arch, tokens):
    """At each full config's (E, k): 128 experts top-8, 16 top-2."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    assert TM._capacity(tokens, tcfg) == JM._capacity(tokens, jcfg)
    c = TM._capacity(tokens, tcfg)
    assert 1 <= c <= tokens and (c == tokens or c % 64 == 0)


def test_top_k_breaks_ties_as_jax():
    """Many exact ties, in float32 and bf16: the values and the indices
    of ``jax.lax.top_k``, the lower index first."""
    vals = np.random.default_rng(3).integers(0, 4, (8, 96)) \
        .astype(np.float32) / 4
    for dtype in ("float32", "bfloat16"):
        jv, ji = jax.lax.top_k(jnp.asarray(vals).astype(dtype), 40)
        tv, ti = TM.top_k(torch.from_numpy(vals).to(getattr(torch, dtype)),
                          40)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(_np(tv), _np(jv))


# ---------------------------------------------------------------- forward
def _routed_x(jp, b, s, d, seed):
    """Inputs that lean towards expert 0 (an offset along its router
    column), so that at 2 x 256 tokens its load passes the capacity."""
    w0 = np.asarray(jp["router"]["w"])[:, 0]
    return _x((b, s, d), seed) + 2.0 * w0 / np.linalg.norm(w0)


def _loads(jp, x, cfg):
    """Tokens routed to each expert by the JAX router."""
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32).reshape(
        -1, x.shape[-1]) @ jp["router"]["w"], axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1])
    return np.bincount(idx.ravel(), minlength=cfg.moe.num_experts)


@pytest.mark.parametrize("variant", ["swiglu", "gelu"])
@pytest.mark.parametrize("b,s", [(2, 32), (2, 256)],
                         ids=["capacity-T", "dropping"])
def test_moe_forward_matches_jax_float32(variant, b, s):
    """Output and aux; at 2 x 32 tokens the capacity is T (64, no token
    dropped), at 2 x 256 it is 192 of 512 and expert 0's load passes it,
    so its overflow tokens are dropped."""
    jcfg, tcfg = _cfgs(mlp_variant=variant)
    t = b * s
    cap = TM._capacity(t, tcfg)
    assert cap == (64 if t == 64 else 192)
    jp, tp = _params(jcfg)
    x = _routed_x(jp, b, s, jcfg.d_model, 1)
    assert (_loads(jp, x, jcfg).max() > cap) == (t > cap)
    (jy, ja), (ty, ta) = _run(jcfg, tcfg, jp, tp, x, "float32")
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=1e-5 * (1 + float(np.abs(jy).max())))
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


@pytest.mark.parametrize("variant", ["swiglu", "gelu"])
@pytest.mark.parametrize("b,s", [(2, 32), (2, 256)],
                         ids=["capacity-T", "dropping"])
def test_moe_forward_matches_jax_bfloat16(variant, b, s):
    jcfg, tcfg = _cfgs(mlp_variant=variant)
    jp, tp = _params(jcfg, seed=1)
    x = _routed_x(jp, b, s, jcfg.d_model, 2)
    assert (_loads(jp, x, jcfg).max() > TM._capacity(b * s, tcfg)) == \
        (s == 256)
    (jy, ja), (ty, ta) = _run(jcfg, tcfg, jp, tp, x, "bfloat16")
    _bf16_close(ty, jy)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_ties_keep_the_jax_tokens(dtype):
    """4 distinct token rows leaning towards expert 0, interleaved and
    each repeated 128 times (T 512): the copies of a row route alike, so
    expert 0's affinities are four values in exact ties, and its capacity
    cut (192) falls inside one row's copies. The output shows which
    copies expert 0 kept: the port keeps those ``jax.lax.top_k`` keeps,
    the lowest indices among equals."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    rows = _routed_x(jp, 1, 4, jcfg.d_model, 3)[0]
    x = np.tile(rows, (128, 1)).reshape(2, 256, jcfg.d_model)
    assert _loads(jp, x, jcfg)[0] == 512 > TM._capacity(512, tcfg)
    (jy, ja), (ty, ta) = _run(jcfg, tcfg, jp, tp, x, dtype)

    def as_first_copy(y):
        y = y.reshape(512, -1)
        return np.array([np.array_equal(y[p], y[p % 4]) for p in range(512)])

    same = as_first_copy(jy)
    assert 0 < (~same).sum() < 512 - 4
    np.testing.assert_array_equal(as_first_copy(ty), same)
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=0,
                                   atol=1e-5 * (1 + float(np.abs(jy).max())))
    else:
        _bf16_close(ty, jy)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


def test_moe_gradients_match_jax():
    """The gradient of sum(y * r) + aux (float32, tokens dropped) for the
    router and the three expert weights, and for x, against jax.grad:
    through the gate and the renormalised routing weights as through the
    ``lax.top_k`` values, and through both aux losses."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=4)
    x = _routed_x(jp, 2, 256, jcfg.d_model, 5)
    assert _loads(jp, x, jcfg).max() > TM._capacity(512, tcfg)
    r = _x((2, 256, jcfg.d_model), 6)

    def jloss(p, xx):
        y, aux = JM.moe_forward(p, xx, jcfg)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {"router": tp["router"]["w"], "wg": tp["wg"], "wu": tp["wu"],
              "wd": tp["wd"]}
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe_forward({"router": {"w": leaves["router"]},
                             **{k: leaves[k] for k in ("wg", "wu", "wd")}},
                            tx, tcfg)
    loss = (y * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(loss, [*leaves.values(), tx])
    want = [jgp["router"]["w"], jgp["wg"], jgp["wu"], jgp["wd"], jgx]
    for name, g, w in zip([*leaves, "x"], grads, want):
        w = _np(w)
        assert float(np.abs(w).max()) > 0, name
        np.testing.assert_allclose(_np(g), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_moe_init_draws_the_jax_tree():
    """``moe_init`` in the JAX names, shapes and dtypes: the router
    float32 even where the experts are bf16."""
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda: JM.moe_init(jax.random.PRNGKey(0), jcfg,
                                              jnp.bfloat16)[0])
    got = TM.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                      "cpu")
    assert tuple(got["router"]["w"].shape) == want["router"]["w"].shape
    assert got["router"]["w"].dtype == torch.float32
    assert want["router"]["w"].dtype == jnp.float32
    for k in ("wg", "wu", "wd"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.bfloat16
