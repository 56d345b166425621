"""The SSD scan's gradient (``kernels/ssd_scan.ssd_scan_bwd``) against the
JAX package's, on the same numpy inputs and cotangents.

The JAX side is ``jax.vjp`` of ``repro.models.ssm.ssd_scan``, the chunked
scan under ``lax.scan`` over ``jax.checkpoint(step)`` that the JAX
training path differentiates (it reaches no Pallas kernel). The port's
side is ``ssd_scan_cuda``, which on the CPU runs K7's plain version
forward and ``ssd_scan_bwd`` backward; it is also held against autograd
straight through ``ssd_scan_plain``, K7's oracle, which the backward
shares no code with.

Chunking: the port pads a ragged tail to its chunk (256 here), while the
JAX function halves its chunk until it divides the length (600 tokens
run in chunks of 8 there); the function is the same, only the rounding
differs. Tolerances: in float32 each gradient within rtol 1e-4 and atol
1e-4 x its largest |value| (the same sums in another order and
chunking); in bfloat16 (xdt, B, C and y in bf16, a and the states
float32) each gradient within 2% of its norm, as the SSD block's bf16
tests of ``test_torch_ssd.py`` hold their outputs (both sides compute in
float32 and round the gradients of the bf16 inputs once, but from
another chunking).
"""
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.kernels import ssd_scan as SS
from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_cuda, \
    ssd_scan_plain
from repro_torch.models import ssm as TS

NAMES = ("xdt", "a", "B", "C", "init_state")


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


def _case(s, dtype, seed=0, b=2, h=3, p=8, n=4):
    """Inputs (xdt, a, B, C, init_state) and cotangents (dy, dstate) as
    float32 numpy, the bf16 ones already rounded to bf16."""
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(b, s, h, p)) * 0.1
    a = -np.abs(rng.normal(size=(b, s, h))) * 0.1
    B = rng.normal(size=(b, s, n))
    C = rng.normal(size=(b, s, n))
    h0 = rng.normal(size=(b, h, p, n))
    dy = rng.normal(size=(b, s, h, p))
    ds = rng.normal(size=(b, h, p, n))
    rnd = (lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16),
                                np.float32)) if dtype == "bfloat16" \
        else (lambda x: x)
    f32 = lambda x: np.asarray(x, np.float32)
    return ([f32(rnd(xdt)), f32(a), f32(rnd(B)), f32(rnd(C)), f32(h0)],
            [f32(rnd(dy)), f32(ds)])


def _jax_grads(ins, cots, dtype, with_state):
    jd = jnp.dtype(dtype)
    xs = [jnp.asarray(ins[0], jd), jnp.asarray(ins[1]),
          jnp.asarray(ins[2], jd), jnp.asarray(ins[3], jd)]
    if with_state:
        xs.append(jnp.asarray(ins[4]))

    def f(*args):
        return JS.ssd_scan(*args[:4], 256,
                           init_state=args[4] if with_state else None)

    (y, st), vjp = jax.vjp(f, *xs)
    grads = vjp((jnp.asarray(cots[0], jd), jnp.asarray(cots[1])))
    return (y, st), grads


def _torch_leaves(ins, dtype, with_state):
    td = getattr(torch, dtype)
    leaves = [torch.from_numpy(ins[0]).to(td), torch.from_numpy(ins[1]),
              torch.from_numpy(ins[2]).to(td),
              torch.from_numpy(ins[3]).to(td)]
    if with_state:
        leaves.append(torch.from_numpy(ins[4]))
    return [t.requires_grad_(True) for t in leaves]


def _close(got, want, dtype, name):
    a, b = _np(got), _np(want)
    assert a.shape == b.shape, name
    assert np.isfinite(a).all(), name
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=name)
    else:
        assert np.linalg.norm(a - b) <= 0.02 * np.linalg.norm(b), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "init-state"])
@pytest.mark.parametrize("s", [64, 40, 600])
def test_scan_grad_matches_jax_vjp(s, with_state, dtype):
    """y, the final state and the gradient of every input (xdt, a, B, C
    and init_state where given) for cotangents on y and on the final
    state, against ``jax.vjp`` of the JAX ``ssd_scan``; each gradient in
    its input's type, as ``jax.vjp`` returns it."""
    ins, cots = _case(s, dtype, seed=s)
    (jy, jst), jg = _jax_grads(ins, cots, dtype, with_state)
    leaves = _torch_leaves(ins, dtype, with_state)
    y, st = ssd_scan_cuda(*leaves[:4], chunk=256,
                          init_state=leaves[4] if with_state else None)
    assert st.requires_grad
    tg = torch.autograd.grad((y, st), leaves,
                             (torch.from_numpy(cots[0]).to(y.dtype),
                              torch.from_numpy(cots[1])))
    _close(y, jy, dtype, "y")
    _close(st, jst, "float32" if dtype == "float32" else dtype, "state")
    for name, g, t, j in zip(NAMES, tg, leaves, jg):
        assert g.dtype == t.dtype and str(j.dtype) == str(t.dtype)[6:], name
        _close(g, j, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(600, 256), (40, 256), (96, 32)],
                         ids=["ragged-600", "short-40", "whole-chunks"])
def test_scan_grad_matches_autograd_through_the_oracle(s, chunk, dtype):
    """The same gradients against autograd straight through
    ``ssd_scan_plain`` (at the same chunk), with an init_state, a
    cotangent on y only, then on the final state only."""
    ins, cots = _case(s, dtype, seed=s + 1)
    for dy, ds in ((cots[0], None), (None, cots[1])):
        got_l = _torch_leaves(ins, dtype, True)
        want_l = _torch_leaves(ins, dtype, True)
        y, st = ssd_scan_cuda(*got_l[:4], chunk=chunk, init_state=got_l[4])
        yr, sr = ssd_scan_plain(*want_l[:4], chunk=chunk,
                                init_state=want_l[4])
        outs, wouts, gout = [], [], []
        if dy is not None:
            outs.append(y)
            wouts.append(yr)
            gout.append(torch.from_numpy(dy).to(y.dtype))
        if ds is not None:
            outs.append(st)
            wouts.append(sr)
            gout.append(torch.from_numpy(ds))
        got = torch.autograd.grad(outs, got_l, gout, allow_unused=True,
                                  materialize_grads=True)
        want = torch.autograd.grad(wouts, want_l, gout, allow_unused=True,
                                   materialize_grads=True)
        for name, g, w in zip(NAMES, got, want):
            _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_decay_gives_zero_not_nan(dtype):
    """Steep decays (a down to -60 a token) make the upper triangle's
    cum_i - cum_j large and positive: exp(where(mask, ldecay, -inf))
    keeps it out, so every gradient is finite and agrees with the JAX
    function's, in bf16 as in float32. In float32 within rtol and atol
    1e-3 x the largest |value|, two float32 ulps of the chunk's |cum| of
    up to 7,680 (2**-11 each): the libraries' cumsums round there, and
    each decay exp(cum_i - cum_j) moves by that relative amount (the
    reading is 4.9e-4, one such ulp)."""
    ins, cots = _case(128, dtype, seed=7)
    ins[1] = ins[1] * 600.0
    (_, _), jg = _jax_grads(ins, cots, dtype, True)
    leaves = _torch_leaves(ins, dtype, True)
    y, st = ssd_scan_cuda(*leaves[:4], chunk=256, init_state=leaves[4])
    tg = torch.autograd.grad((y, st), leaves,
                             (torch.from_numpy(cots[0]).to(y.dtype),
                              torch.from_numpy(cots[1])))
    for name, g, j in zip(NAMES, tg, jg):
        assert bool(torch.isfinite(g).all()), name
        if dtype == "float32":
            np.testing.assert_allclose(
                _np(g), _np(j), rtol=1e-3,
                atol=1e-3 * float(np.abs(_np(j)).max()), err_msg=name)
        else:
            _close(g, j, dtype, name)


def test_scan_bwd_never_calls_the_oracle(monkeypatch):
    """``ssd_scan_bwd`` names no ``ssd_scan_plain``, and runs with the
    oracle broken: the two stay independent code."""
    tree = ast.parse(inspect.getsource(SS.ssd_scan_bwd))
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert "ssd_scan_plain" not in names
    for fn in (SS._chunk_state, SS._chunk_step, SS._chunk_vjp):
        assert "ssd_scan_plain" not in inspect.getsource(fn)

    def broken(*a, **kw):
        raise AssertionError("the backward called K7's oracle")

    ins, cots = _case(70, "float32", seed=3)
    T = [torch.from_numpy(x) for x in ins]
    monkeypatch.setattr(SS, "ssd_scan_plain", broken)
    dx, da, dB, dC, dh = ssd_scan_bwd(*T, torch.from_numpy(cots[0]),
                                      torch.from_numpy(cots[1]), chunk=32)
    assert dx.shape == T[0].shape and dh.shape == T[4].shape
    with pytest.raises(AssertionError, match="oracle"):
        ssd_scan_cuda(*T[:4], chunk=32)


def test_scan_bwd_without_cotangents_or_tokens():
    """No cotangent on either output gives zero gradients; an empty
    sequence passes the final state's cotangent to init_state; the
    gradient of an absent init_state is None."""
    ins, cots = _case(48, "float32", seed=4)
    T = [torch.from_numpy(x) for x in ins]
    out = ssd_scan_bwd(*T[:4], None, None, None, chunk=16)
    assert out[4] is None
    assert all(bool((g == 0).all()) for g in out[:4])
    empty = [t[:, :0] for t in T[:4]]
    ds = torch.from_numpy(cots[1])
    out = ssd_scan_bwd(*empty, T[4], None, ds, chunk=16)
    assert all(g.shape[1] == 0 for g in out[:4])
    assert torch.equal(out[4], ds)


def test_ssd_block_grad_matches_jax():
    """``models/ssm.ssd_forward`` of reduced mamba2-780m (the conv, the
    softplus of dt + dt_bias, A = -exp(A_log), the gate and the norm
    around the scan; 40 tokens, a length its chunk of 32 does not divide)
    differentiated in every parameter and its input against ``jax.grad``
    of the JAX block, for a random cotangent. In float32 each gradient
    within 1e-4 of its norm. In bf16 compute the port's gradients are
    held to the JAX block's float32 ones, within 5% of each norm (the
    model's bf16 limit): the JAX bf16 gradient of ``D`` sums its bf16
    products in bf16 and lies 5% from its own float32 value, the port's
    about 1%."""
    import dataclasses
    from repro.configs import get_config as j_get_config, reduced as \
        j_reduced
    from repro_torch.configs import get_config, reduced
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, 256)).astype(np.float32)
    ct = rng.normal(size=(2, 40, 256)).astype(np.float32)
    want = None
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(j_reduced(j_get_config("mamba2-780m")),
                                   compute_dtype=dtype)
        tcfg = dataclasses.replace(reduced(get_config("mamba2-780m")),
                                   compute_dtype=dtype)
        params = JS.ssd_init(jax.random.PRNGKey(1), jcfg, jnp.float32)[0]
        jd, td = jnp.dtype(dtype), getattr(torch, dtype)
        if want is None:
            def jloss(p, x):
                out = JS.ssd_forward(p, x.astype(jd), jcfg)[0]
                return jnp.sum(out.astype(jnp.float32) * ct)

            jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
                params, jnp.asarray(x))
            want = {"/".join(str(k.key) for k in path): v for path, v in
                    jax.tree_util.tree_flatten_with_path(jgp)[0]}
            want["x"] = jgx
        flat = {"/".join(str(k.key) for k in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in flat.items()}
        tree = {}
        for k, v in tp.items():
            node = tree
            *head, leaf = k.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[leaf] = v
        tx = torch.from_numpy(x).requires_grad_(True)
        out = TS.ssd_forward(tree, tx.to(td), tcfg)[0]
        loss = (out.float() * torch.from_numpy(ct)).sum()
        grads = torch.autograd.grad(loss, [*tp.values(), tx])
        rel = 1e-4 if dtype == "float32" else 0.05
        for name, g in zip([*tp, "x"], grads):
            a, b = _np(g), _np(want[name])
            assert np.isfinite(a).all(), name
            assert np.linalg.norm(a - b) <= rel * np.linalg.norm(b), \
                (dtype, name)


def test_chip_smoke_rehearses_the_training_phases(tmp_path):
    """``chip_smoke.py``'s phases 20-22 and 7b on the CPU at the reduced
    configs (``small=True``): every check and control runs. Here both
    sides of each comparison are plain torch, but not the same code
    (``ssd_scan_bwd`` against autograd through ``ssd_scan_plain``)."""
    import chip_smoke as cs
    dev = torch.device("cpu")
    runs = cs.ssm_train_phases(dev, cs.all_wrappers(), small=True)
    for arch in ("mamba2-780m", "hymba-1.5b"):
        rec = runs[f"{arch}_train"]
        grad = rec["grad_check"]
        assert grad["scan"]["control_ratio"] >= 10
        assert grad["scan"]["grad_rel_err"] <= cs.SCAN_GRAD_RTOL
        assert len(rec["losses"]) == cs.SMALL_SSM_TRAIN["steps"]
        assert all(s > 0 for s in rec["ssd_bwd_s"])
        assert ("control_ratio" in grad) == (arch == "hymba-1.5b")
    modes = runs["remat_modes"]
    assert all(modes[m]["bit_equal"] for m in ("full", "dots",
                                               "remat_group=2"))
    comp = runs["compression"]
    assert comp["int8"]["int8_steps"] <= cs.INT8_STEPS
    assert comp["topk"]["kept"] >= comp["topk"]["k"] > 0
    entry = cs.run_entry(dev, tmp_path, arch="mamba2-780m")
    assert entry["resumed_from"] == cs.ENTRY_RUN["first"]
    assert entry["config"] == "mamba2-780m-smoke"
