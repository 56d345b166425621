"""The port's ``train/compression.py`` against the JAX package's, on the
same numpy gradients: the int8 and top-k round trips, ``compress_grads``
over three steps with the error feedback carried, and
``compression_ratio``.

Tolerances: the round trips are the same float32 arithmetic (one scale,
one division, a round half to even, one product; a comparison with one
threshold), so every sent value and every error-feedback value agrees
within one float32 ulp (rtol 2**-23 of the tensor's largest |value|);
which elements top-k keeps agrees exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as JC
from repro_torch.train import compression as TC
from repro_torch.train import (
    CompressorConfig, compress_grads, compression_ratio, init_error_feedback,
)

ULP = 2.0 ** -23


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    a, b = got.numpy(), np.asarray(want)
    assert a.dtype == np.float32 and a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=ULP * scale)


def _grads(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2))
            .astype(np.float32) for k, s in shapes.items()}


SHAPES = {"layers.0.ssd.A_log": (6,), "layers.0.ssd.o.w": (6, 8, 16),
          "embed.table": (64, 32), "final_norm.scale": (32,)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_roundtrip_matches_jax(seed):
    """One scale per tensor (largest |x| / 127 + 1e-12), rounded half to
    even: values planted on exact halves of the step round as
    ``jnp.round`` rounds them."""
    x = _grads(seed, {"x": (40, 24)})["x"]
    x.flat[0] = 127.0
    x.flat[1:7] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5]    # scale ~1: halves
    got = TC._int8_roundtrip(_t(x))
    want = JC._int8_roundtrip(jnp.asarray(x))
    _close(got, want)
    q = np.round(x / (127.0 / 127.0 + 1e-12))
    assert list(q.flat[1:7]) == [0.0, 2.0, 2.0, -0.0, -2.0, -2.0]


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1e-6])
def test_topk_roundtrip_matches_jax(frac):
    """The k-th largest |x| (k = frac of the elements, at least 1) is the
    threshold and every element at or above it is kept, ties included:
    planted ties at the threshold keep more than k, as in JAX."""
    x = _grads(3, {"x": (50, 20)})["x"]
    k = max(int(x.size * frac), 1)
    mag = np.sort(np.abs(x).ravel())[::-1]
    ties = np.flatnonzero(np.abs(x).ravel() < mag[k - 1])[:3]
    x.flat[ties] = -mag[k - 1]
    got = TC._topk_roundtrip(_t(x), frac)
    want = np.asarray(JC._topk_roundtrip(jnp.asarray(x), frac))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got != 0).sum()) == int((want != 0).sum()) >= k + 3


@pytest.mark.parametrize("kind,ef", [("int8", True), ("topk", True),
                                     ("int8", False), ("topk", False),
                                     ("none", True)])
def test_compress_grads_matches_jax_over_steps(kind, ef):
    """Three steps of ``compress_grads`` with the error feedback carried
    from each step into the next, in both packages: the sent gradients
    and the new error feedback (target - sent, or unchanged without
    error feedback; both untouched for ``none``)."""
    cfg = CompressorConfig(kind=kind, topk_frac=0.05, error_feedback=ef)
    jcfg = JC.CompressorConfig(kind=kind, topk_frac=0.05,
                               error_feedback=ef)
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    t_ef = init_error_feedback({k: _t(v) for k, v in params.items()})
    j_ef = JC.init_error_feedback({k: jnp.asarray(v)
                                   for k, v in params.items()})
    assert all(e.dtype == torch.float32 and not bool(e.any())
               for e in t_ef.values())
    for step in range(3):
        g = _grads(10 + step, SHAPES)
        t_in = {k: _t(v) for k, v in g.items()}
        t_sent, t_new = compress_grads(cfg, t_in, t_ef)
        j_sent, j_new = JC.compress_grads(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, j_ef)
        assert set(t_sent) == set(t_new) == set(SHAPES)
        for k in SHAPES:
            _close(t_sent[k], j_sent[k])
            _close(t_new[k], j_new[k])
        if kind == "none":
            assert t_sent is t_in and t_new is t_ef
        elif ef and step:
            k = "embed.table"
            np.testing.assert_allclose(
                t_new[k].numpy(),
                (t_in[k] + t_ef[k] - t_sent[k]).numpy(), rtol=0, atol=0)
        t_ef, j_ef = t_new, j_new
    with pytest.raises(ValueError):
        compress_grads(CompressorConfig(kind="fp8"), t_in, t_ef)


def _stacked(seed, layers=3):
    """A JAX tree with a stacked leaf whose layers differ in magnitude by
    10x each (so that one scale a layer would quantize them otherwise),
    and the port's dict of the same numbers, one tensor a layer."""
    rng = np.random.default_rng(seed)
    stack = np.stack([rng.normal(size=(6, 8)) * 10.0 ** i
                      for i in range(layers)]).astype(np.float32)
    table = rng.normal(size=(16, 4)).astype(np.float32)
    jtree = {"layers": {"ssd": {"o": {"w": stack}}},
             "embed": {"table": table}}
    flat = {f"layers.{i}.ssd.o.w": stack[i] for i in range(layers)}
    flat["embed.table"] = table
    return jtree, flat


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_a_stacked_leaf_takes_one_scale_and_threshold(kind):
    """JAX transforms each leaf of its tree, and a stacked leaf holds every
    layer: one int8 scale, one top-k threshold for all of them. The
    port's one tensor a layer is transformed by its JAX leaf
    (``leaves``): ``compress_grads`` over two steps and ``int8_leaves``
    (the dry-run's ``jax.tree.map(_int8_roundtrip, g)``) against JAX's
    on the stacked tree; a transform layer by layer parts from it."""
    cfg = CompressorConfig(kind=kind, topk_frac=0.05)
    jcfg = JC.CompressorConfig(kind=kind, topk_frac=0.05)
    jtree, flat = _stacked(3)
    t_ef = init_error_feedback({k: _t(v) for k, v in flat.items()})
    j_ef = JC.init_error_feedback(jax.tree.map(jnp.asarray, jtree))
    for step in range(2):
        jtree, flat = _stacked(20 + step)
        t_sent, t_ef = compress_grads(
            cfg, {k: _t(v) for k, v in flat.items()}, t_ef)
        j_sent, j_ef = JC.compress_grads(
            jcfg, jax.tree.map(jnp.asarray, jtree), j_ef)
        for i in range(3):
            _close(t_sent[f"layers.{i}.ssd.o.w"],
                   j_sent["layers"]["ssd"]["o"]["w"][i])
            _close(t_ef[f"layers.{i}.ssd.o.w"],
                   j_ef["layers"]["ssd"]["o"]["w"][i])
        _close(t_sent["embed.table"], j_sent["embed"]["table"])
    assert TC.leaves(flat) == {
        "layers.ssd.o.w": [f"layers.{i}.ssd.o.w" for i in range(3)],
        "embed.table": ["embed.table"]}
    stack = jnp.asarray(jtree["layers"]["ssd"]["o"]["w"])
    if kind == "int8":
        got = TC.int8_leaves({k: _t(v) for k, v in flat.items()})
        want = JC._int8_roundtrip(stack)
        alone = TC._int8_roundtrip(_t(flat["layers.0.ssd.o.w"]))
    else:
        got = dict(zip(TC.leaves(flat)["layers.ssd.o.w"], TC._topk_group(
            [_t(flat[f"layers.{i}.ssd.o.w"]) for i in range(3)], 0.05)))
        want = JC._topk_roundtrip(stack, 0.05)
        alone = TC._topk_roundtrip(_t(flat["layers.0.ssd.o.w"]), 0.05)
    for i in range(3):
        _close(got[f"layers.{i}.ssd.o.w"], want[i])
    with pytest.raises(AssertionError):
        _close(alone, want[0])


@pytest.mark.parametrize("kind,frac", [("int8", 0.01), ("topk", 0.01),
                                       ("topk", 0.2), ("none", 0.01)])
def test_compression_ratio_matches_jax(kind, frac):
    assert compression_ratio(CompressorConfig(kind=kind, topk_frac=frac)) \
        == JC.compression_ratio(JC.CompressorConfig(kind=kind,
                                                    topk_frac=frac))


def test_train_step_sends_the_compressed_gradients():
    """``make_train_step``'s ``grad_transform`` carrying ``compress_grads``
    with its error feedback across two steps of reduced mamba2-780m: the
    parameters and moments equal, bit for bit, those of the same two
    steps made by hand (loss, gradients, ``compress_grads``,
    ``adamw_update``). The wiring only: the transform's parity with JAX
    is held above, on the same gradients (two packages' gradients differ
    by float32 noise, which a round trip turns into whole quantization
    steps wherever it straddles a rounding boundary)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.generators import token_batches
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, adamw_init, adamw_update
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import TrainState
    model = build_model(reduced(get_config("mamba2-780m")), device="cpu")
    init = model.init(torch.Generator().manual_seed(0))
    cfg = CompressorConfig(kind="topk", topk_frac=0.05)
    opt_cfg = OptConfig(warmup_steps=1)
    batches = [{k: _t(v) for k, v in b.items()} for b, _ in
               zip(token_batches(512, 2, 40, seed=1), range(2))]

    def copy(params):
        return {k: v.detach().clone().requires_grad_(True)
                for k, v in params.items()}

    ef = [init_error_feedback(init)]

    def transform(grads):
        sent, ef[0] = compress_grads(cfg, grads, ef[0])
        return sent

    step = make_train_step(model, opt_cfg, grad_transform=transform)
    params = copy(init)
    state = TrainState(params=params, opt=adamw_init(params))
    for b in batches:
        state, _ = step(state, b)
    params = copy(init)
    opt, hand_ef = adamw_init(params), init_error_feedback(init)
    for b in batches:
        loss, _ = model.loss(params, b)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        sent, hand_ef = compress_grads(cfg, grads, hand_ef)
        assert any(bool((g != s).any()) for g, s in zip(
            grads.values(), sent.values()))
        params, opt, _ = adamw_update(opt_cfg, params, sent, opt)
    for k in init:
        assert torch.equal(state.params[k].detach(), params[k].detach()), k
        assert torch.equal(state.opt["m"][k], opt["m"][k]), k
        assert torch.equal(ef[0][k], hand_ef[k]), k
