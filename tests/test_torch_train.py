"""The port's training path against the JAX package's: the schedule and
AdamW, the train step (one and two micro-batches), the launch loop, the
checkpoints in both directions, the restart loop and the data pipeline.
Inputs are numpy arrays from a seed handed to both; the model weights are
the JAX ones carried across by ``convert``.

Tolerances: the optimizer within rtol 1e-6 and atol 1e-7 (the same fp32
formula; the two libraries may fuse a multiply-add where the other rounds
twice). After a train step (fp32 compute) the metrics within rtol 1e-5,
and each parameter's update within 1% of its norm:
``|p_port - p_jax| <= 1e-2 |p_jax - p_before|``. Elementwise the update is
lr x m/(sqrt(v) + eps), which for a first step is g/(|g| + 1e-8): a
gradient within a few orders of 1e-8 moves its parameter by a fraction of
lr that follows the gradient's fp32 noise between the packages (about
1e-6 of it), so a handful of elements in 10^5 differ by up to a fifth of
lr while the rest agree to 1e-7. The launch loop: losses within 1e-4 (the
JAX entry point prints 4 decimals), parameters as a train step. Checkpoints
restore bit for bit.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.data.generators import token_batches as j_token_batches
from repro.models import build_model as j_build_model
from repro.train import OptConfig as JOptConfig
from repro.train import adamw_init as j_adamw_init
from repro.train import adamw_update as j_adamw_update
from repro.train import make_train_step as j_make_train_step
from repro.train import checkpoint as JC
from repro.train.optimizer import schedule as j_schedule
from repro.train.train_step import init_train_state as j_init_train_state
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.data.generators import token_batches
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.distributed.fault import RestartManager
from repro_torch.models import build_model
from repro_torch.train import OptConfig, adamw_init, adamw_update
from repro_torch.train import checkpoint as TC
from repro_torch.train.optimizer import global_norm, schedule
from repro_torch.train.train_step import (
    TrainState, init_train_state, make_train_step,
)


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _cfgs(arch="starcoder2-7b", **kw):
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _state_pair(arch="starcoder2-7b", **kw):
    """A JAX train state of the reduced ``arch`` (PRNGKey(0)) and the
    port's copy of it, with the port's model."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jm = j_build_model(jcfg)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jstate, tm, convert.train_state_from_jax(
        jax.tree.map(np.asarray, {"params": jstate.params,
                                  "opt": jstate.opt}), device="cpu")


def _assert_update(tparams, jparams, before, tol=1e-2):
    """Each parameter's update in the port within ``tol`` of the JAX
    update, in norm."""
    want = convert.model_params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(want) == set(tparams) == set(before)
    for name, w in want.items():
        w, b = _np(w), _np(before[name])
        err = np.linalg.norm(_np(tparams[name]) - w)
        assert err <= tol * np.linalg.norm(w - b), (name, err)


# ---------------------------------------------------------------- optimizer
def test_schedule_matches_jax():
    cfg = OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = JOptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    got = schedule(cfg, torch.tensor(steps, dtype=torch.int32))
    want = j_schedule(jcfg, jnp.asarray(steps, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(clip):
    """Two steps from nonzero moments, on matrices and vectors: the clip
    by the global norm (active at clip 1), decay on matrices only, the
    bias corrections and the schedule."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "t": (4, 2, 3), "b": (16,), "s": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                    clip_norm=clip)
    jcfg = JOptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                      clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = j_adamw_init(jp)
    tp = {k: _t(v) for k, v in params.items()}
    topt = adamw_init(tp)
    for _ in range(2):
        grads = {k: (rng.normal(size=s) * 3).astype(np.float32)
                 for k, s in shapes.items()}
        jp, jopt, jst = j_adamw_update(jcfg, jp, {k: jnp.asarray(v) for
                                                  k, v in grads.items()},
                                       jopt)
        tp, topt, tst = adamw_update(cfg, tp, {k: _t(v) for k, v in
                                               grads.items()}, topt)
        for k in shapes:
            for a, b in ((tp[k], jp[k]), (topt["m"][k], jopt["m"][k]),
                         (topt["v"][k], jopt["v"][k])):
                np.testing.assert_allclose(_np(a), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)
        assert int(topt["step"]) == int(jopt["step"])
        for s in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tst[s]), float(jst[s]),
                                       rtol=1e-6)


def test_adamw_clips_and_decays_matrices_only():
    """Decay reaches matrices and, as in the JAX tree where layer leaves
    are stacked, a layer's vectors; not a vector outside the layers."""
    params = {"w": torch.ones((4, 4)), "final_norm.scale": torch.ones((4,)),
              "layers.0.ln1.scale": torch.ones((4,))}
    opt = adamw_init(params)
    grads = {"w": torch.full((4, 4), 100.0),
             "final_norm.scale": torch.zeros((4,)),
             "layers.0.ln1.scale": torch.zeros((4,))}
    assert float(global_norm(grads)) == pytest.approx(400.0)
    cfg = OptConfig(lr=1.0, warmup_steps=1, total_steps=10,
                    weight_decay=0.5)
    params, opt, stats = adamw_update(cfg, params, grads, opt)
    assert float(stats["grad_norm"]) == pytest.approx(400.0)
    # a zero gradient and no decay -> unchanged; w: the sign step plus
    # decay of 0.5 x 1; the layer's vector: the decay alone
    assert torch.equal(params["final_norm.scale"], torch.ones(4))
    np.testing.assert_allclose(_np(params["w"]), -0.5, rtol=1e-5)
    np.testing.assert_allclose(_np(params["layers.0.ln1.scale"]), 0.5,
                               rtol=1e-5)


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("mu", [1, 2])
def test_train_step_matches_jax(mu):
    """One step of make_train_step (fp32 compute, the starcoder2 MLP) in
    both packages from the same state and batch."""
    jm, jstate, tm, tstate = _state_pair(
        compute_dtype="float32", mlp_variant="gelu", use_bias=True)
    before = {n: p.detach().clone() for n, p in tstate.params.items()}
    batch = next(token_batches(512, 4, 32, seed=1))
    jstep = jax.jit(j_make_train_step(jm, JOptConfig(warmup_steps=1),
                                      num_microbatches=mu))
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tstep = make_train_step(tm, OptConfig(warmup_steps=1),
                            num_microbatches=mu)
    tstate, tmet = tstep(tstate, {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "ce", "ntok", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    _assert_update(tstate.params, jstate.params, before)
    assert int(tstate.opt["step"]) == int(jstate.opt["step"]) == 1


@pytest.mark.parametrize("arch,mu", [("qwen3-moe-30b-a3b", 1),
                                     ("qwen3-moe-30b-a3b", 2),
                                     ("phi3.5-moe-42b-a6.6b", 1)])
def test_moe_train_step_matches_jax(arch, mu):
    """One step of make_train_step for a reduced MoE config (fp32
    compute; 4 x 32 tokens, capacity 64 of 128, so tokens are dropped;
    each of two micro-batches routes its 64 alone, as in JAX): the loss,
    its aux and the update of every parameter, the router's and the
    experts' included, with the tolerances of the dense step."""
    jm, jstate, tm, tstate = _state_pair(arch, compute_dtype="float32")
    before = {n: p.detach().clone() for n, p in tstate.params.items()}
    batch = next(token_batches(512, 4, 32, seed=1))
    jstep = jax.jit(j_make_train_step(jm, JOptConfig(warmup_steps=1),
                                      num_microbatches=mu))
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tstep = make_train_step(tm, OptConfig(warmup_steps=1),
                            num_microbatches=mu)
    tstate, tmet = tstep(tstate, {k: _t(v) for k, v in batch.items()})
    assert float(tmet["aux"]) > 0
    for k in ("loss", "ce", "aux", "ntok", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    _assert_update(tstate.params, jstate.params, before)


def test_microbatched_step_matches_flat():
    """num_microbatches=2 accumulates fp32 gradients to those of one
    batch (the loss is a mean over equal halves)."""
    _, _, tm, s1 = _state_pair(compute_dtype="float32")
    _, _, _, s2 = _state_pair(compute_dtype="float32")
    before = {n: p.detach().clone() for n, p in s1.params.items()}
    batch = {k: _t(v) for k, v in
             next(token_batches(512, 4, 16, seed=2)).items()}
    s1, m1 = make_train_step(tm, OptConfig(warmup_steps=1))(s1, batch)
    s2, m2 = make_train_step(tm, OptConfig(warmup_steps=1),
                             num_microbatches=2)(s2, batch)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-5)
    for n, b in before.items():
        err = torch.linalg.norm(s2.params[n] - s1.params[n])
        assert err <= 1e-2 * torch.linalg.norm(s1.params[n] - b), n
    with pytest.raises(ValueError):
        make_train_step(tm, num_microbatches=3)(s1, batch)


def test_launch_loop_matches_jax(tmp_path, monkeypatch, capsys):
    """Three steps of each package's launch loop (fp32 compute) on the
    same token_batches, from one initial state: the JAX state written as a
    step-0 checkpoint, which both entry points restore from LATEST."""
    import repro.launch.train as JT
    from repro_torch.launch.train import train
    jcfg, tcfg = _cfgs(compute_dtype="float32")
    monkeypatch.setattr(JT, "reduced", lambda c: jcfg)
    init = j_init_train_state(j_build_model(jcfg), jax.random.PRNGKey(0))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for d in (jdir, tdir):
        JC.save_checkpoint(d, init, step=0)
    monkeypatch.setattr(sys, "argv", [
        "train", "--steps", "3", "--batch", "2", "--seq", "32",
        "--ckpt-dir", str(jdir), "--save-every", "3", "--log-every", "1"])
    JT.main()
    out = capsys.readouterr().out
    jlosses = [float(line.split("loss=")[1].split()[0])
               for line in out.splitlines() if "loss=" in line]
    rec = train(tcfg, steps=3, batch=2, seq=32, ckpt_dir=tdir,
                save_every=3, log_every=1, device="cpu")
    assert rec["resumed_from"] == 0 and rec["restarts"] == 0
    assert rec["last_saved_step"] == 3 and len(jlosses) == 3
    # the JAX entry point prints 4 decimals
    np.testing.assert_allclose(rec["losses"], jlosses, rtol=0, atol=1e-4)
    shapes = jax.eval_shape(lambda: init)
    jfinal = JC.restore_checkpoint(JC.latest_checkpoint(jdir), shapes)
    before = convert.model_params_from_jax(jax.tree.map(np.asarray,
                                                        init.params))
    _assert_update(rec["state"].params, jfinal.params, before)


# -------------------------------------------------------------- checkpoints
def _jax_state_like(jm):
    return jax.eval_shape(lambda: j_init_train_state(
        jm, jax.random.PRNGKey(0)))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jm, jstate, tm, _ = _state_pair(mlp_variant="gelu", use_bias=True)
    jstate.opt["step"] = jnp.asarray(7, jnp.int32)
    ck = JC.AsyncCheckpointer(tmp_path, keep=2)
    ck.save(jstate, 7, block=True)
    like = init_train_state(tm, torch.Generator().manual_seed(5))
    path = TC.latest_checkpoint(tmp_path)
    assert TC.read_manifest(path)["step"] == 7
    got = TC.restore_checkpoint(path, like)
    assert got is like and int(got.opt["step"]) == 7
    want = convert.train_state_from_jax(
        jax.tree.map(np.asarray, {"params": jstate.params,
                                  "opt": jstate.opt}), device="cpu")
    for part in ("m", "v"):
        for n, t in want.opt[part].items():
            assert torch.equal(got.opt[part][n], t), n
    for n, t in want.params.items():
        assert torch.equal(got.params[n].detach(), t.detach()), n
        assert got.params[n].requires_grad


def test_port_checkpoint_restores_into_jax(tmp_path):
    jm, _, tm, _ = _state_pair()
    state = init_train_state(tm, torch.Generator().manual_seed(3))
    state.opt["step"] += 4
    ck = TC.AsyncCheckpointer(tmp_path, keep=2)
    ck.save(state, 4, metadata={"arch": "starcoder2-7b"}, block=True)
    assert ck.last_saved_step == 4
    path = JC.latest_checkpoint(tmp_path)
    assert JC.read_manifest(path)["metadata"] == {"arch": "starcoder2-7b"}
    restored = JC.restore_checkpoint(path, _jax_state_like(jm))
    assert int(restored.opt["step"]) == 4
    want = convert.model_params_to_jax(state.params)
    for a, b in zip(jax.tree.leaves(want),
                    jax.tree.leaves(restored.params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_port_checkpoint_round_trip_is_bit_equal(tmp_path):
    _, _, tm, _ = _state_pair(compute_dtype="float32")
    state = init_train_state(tm, torch.Generator().manual_seed(1))
    batch = {k: _t(v) for k, v in
             next(token_batches(512, 2, 16, seed=4)).items()}
    state, _ = make_train_step(tm, OptConfig(warmup_steps=1))(state, batch)
    snap = {n: p.detach().clone() for n, p in state.params.items()}
    path = TC.save_checkpoint(tmp_path, state, step=1)
    assert TC.latest_checkpoint(tmp_path) == path
    other = init_train_state(build_model(tm.cfg, device="cpu"),
                             torch.Generator().manual_seed(2))
    TC.restore_checkpoint(path, other)
    for n, p in snap.items():
        assert torch.equal(other.params[n].detach(), p), n
        assert torch.equal(other.opt["m"][n], state.opt["m"][n])
        assert torch.equal(other.opt["v"][n], state.opt["v"][n])
    assert int(other.opt["step"]) == 1
    # a plain tree of tensors round-trips too; a missing leaf raises
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    path = TC.save_checkpoint(tmp_path / "tree", tree, step=3)
    like = {"a": torch.zeros(2, 3), "b": [torch.zeros(2)]}
    TC.restore_checkpoint(path, like)
    assert torch.equal(like["a"], tree["a"]) and torch.equal(like["b"][0],
                                                              tree["b"][0])
    with pytest.raises(ValueError, match="missing"):
        TC.restore_checkpoint(path, {"c": torch.zeros(1)})


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = TC.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save({"x": torch.full((3,), float(s))}, s, block=True)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    assert (tmp_path / "LATEST").read_text() == "step_00000004"


def test_restart_manager_resumes_from_latest(tmp_path):
    """The launch loop run to step 2, then asked for 4: the second run
    resumes from LATEST with the first run's final parameters, bit for
    bit, and restarts nothing."""
    from repro_torch.launch import train as LT
    cfg = reduced(get_config("starcoder2-7b"))
    first = LT.train(cfg, steps=2, batch=2, seq=16, ckpt_dir=tmp_path,
                     save_every=1, log_every=1, device="cpu")
    saved = {n: p.detach().clone() for n, p in first["state"].params.items()}
    seen = {}
    real = LT.restore_checkpoint

    def spy(path, like):
        out = real(path, like)
        seen.update({n: p.detach().clone() for n, p in out.params.items()})
        return out

    LT.restore_checkpoint = spy
    try:
        second = LT.train(cfg, steps=4, batch=2, seq=16, ckpt_dir=tmp_path,
                          save_every=1, log_every=1, device="cpu")
    finally:
        LT.restore_checkpoint = real
    assert second["resumed_from"] == 2 and second["restarts"] == 0
    assert len(second["losses"]) == 2 and second["last_saved_step"] == 4
    assert set(seen) == set(saved)
    assert all(torch.equal(seen[n], saved[n]) for n in saved)


def test_restart_manager_restarts_after_a_failure():
    saved = {}
    failed = []

    def step_fn(s, step):
        if step == 5 and not failed:
            failed.append(step)
            raise RuntimeError("worker lost")
        return s + 1

    rm = RestartManager(save_every=2, max_restarts=3)
    out = rm.run(init_state=lambda: 0,
                 restore=lambda: (saved["s"], saved["step"]) if saved
                 else None,
                 step_fn=step_fn,
                 save=lambda s, step: saved.update(s=s, step=step),
                 num_steps=8)
    assert rm.restarts == 1 and out == 8
    rm = RestartManager(save_every=2, max_restarts=1)
    with pytest.raises(RuntimeError, match="always"):
        rm.run(init_state=lambda: 0, restore=lambda: None,
               step_fn=lambda s, step: (_ for _ in ()).throw(
                   RuntimeError("always")),
               save=lambda s, step: None, num_steps=3)


# --------------------------------------------------------------------- data
def test_token_batches_match_jax():
    a, b = token_batches(512, 3, 16, seed=7), j_token_batches(512, 3, 16,
                                                               seed=7)
    for _ in range(3):
        x, y = next(a), next(b)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].dtype == np.int32


def test_prefetch_pipeline_yields_the_source_and_raises_its_error():
    src = token_batches(512, 2, 8, seed=1)
    want = [next(token_batches(512, 2, 8, seed=1)) for _ in range(1)]
    pipe = PrefetchPipeline(src, depth=2, device="cpu")
    got = next(pipe)
    assert isinstance(got["tokens"], torch.Tensor)
    np.testing.assert_array_equal(got["tokens"].numpy(), want[0]["tokens"])
    pipe.close()

    def broken():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise OSError("disk gone")

    pipe = PrefetchPipeline(broken(), device="cpu")
    assert next(pipe)["tokens"].shape == (1, 2)
    with pytest.raises(OSError, match="disk gone"):
        next(pipe)
    pipe = PrefetchPipeline(iter([{"x": np.ones(2)}]), device="cpu",
                            transform=lambda b: {"x": b["x"] * 2})
    assert torch.equal(next(pipe)["x"], torch.full((2,), 2.0,
                                                   dtype=torch.float64))
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(pipe)


def test_convert_round_trips_the_jax_tree():
    jm, jstate, _, tstate = _state_pair(mlp_variant="gelu", use_bias=True)
    back = convert.model_params_to_jax(tstate.params)
    want = jax.tree.map(np.asarray, jstate.params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert isinstance(tstate, TrainState)
    assert all(p.requires_grad for p in tstate.params.values())


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_convert_round_trips_the_moe_tree(arch):
    """A JAX MoE train state into the port and its parameters back, bit
    for bit: ``moe.router.w`` (float32), ``moe.wg``, ``moe.wu`` and
    ``moe.wd`` of every layer, in ``init``'s names and shapes."""
    jm, jstate, tm, tstate = _state_pair(arch)
    names = {n for n in tstate.params if ".moe." in n}
    assert names == {f"layers.{i}.moe.{leaf}" for i in range(2)
                     for leaf in ("router.w", "wg", "wu", "wd")}
    back = convert.model_params_to_jax(tstate.params)
    want = jax.tree.map(np.asarray, jstate.params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert set(tstate.opt["m"]) == set(tstate.params)
    params = tm.init(torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: tuple(t.shape) for n, t in tstate.params.items()}


def test_launch_loop_moe_matches_jax(tmp_path, monkeypatch, capsys):
    """``launch.train`` of phi3.5-moe-42b-a6.6b (its reduced config in
    fp32 compute) against the JAX entry point's three steps on the same
    token_batches from one step-0 checkpoint, as the dense loop above."""
    import repro.launch.train as JT
    from repro_torch.launch.train import train
    arch = "phi3.5-moe-42b-a6.6b"
    jcfg, tcfg = _cfgs(arch, compute_dtype="float32")
    monkeypatch.setattr(JT, "reduced", lambda c: jcfg)
    init = j_init_train_state(j_build_model(jcfg), jax.random.PRNGKey(0))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for d in (jdir, tdir):
        JC.save_checkpoint(d, init, step=0)
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", arch, "--steps", "3", "--batch", "2", "--seq",
        "32", "--ckpt-dir", str(jdir), "--save-every", "3", "--log-every",
        "1"])
    JT.main()
    out = capsys.readouterr().out
    jlosses = [float(line.split("loss=")[1].split()[0])
               for line in out.splitlines() if "loss=" in line]
    rec = train(tcfg, steps=3, batch=2, seq=32, ckpt_dir=tdir,
                save_every=3, log_every=1, device="cpu")
    assert rec["resumed_from"] == 0 and rec["restarts"] == 0
    assert len(jlosses) == 3
    np.testing.assert_allclose(rec["losses"], jlosses, rtol=0, atol=1e-4)
    jfinal = JC.restore_checkpoint(JC.latest_checkpoint(jdir),
                                   jax.eval_shape(lambda: init))
    before = convert.model_params_from_jax(jax.tree.map(np.asarray,
                                                        init.params))
    _assert_update(rec["state"].params, jfinal.params, before)


def test_launch_command_line_always_trains_the_reduced_config(monkeypatch):
    """The JAX entry point's ``--smoke`` is ``store_true`` with default True
    (``launch/train.py:32``), so its command line always trains
    ``reduced(cfg)``; the port's keeps that (ROADMAP Queue 3)."""
    import repro.launch.train as JT
    from repro_torch.launch import train as LT
    seen, jseen = [], []
    monkeypatch.setattr(LT, "train", lambda cfg, **kw: seen.append(cfg.name))
    LT.main(["--arch", "starcoder2-7b", "--smoke"])
    LT.main(["--arch", "starcoder2-7b"])

    def stop(cfg, *a, **kw):
        jseen.append(cfg.name)
        raise SystemExit(0)

    monkeypatch.setattr(JT, "build_model", stop)
    for argv in (["--smoke"], []):
        monkeypatch.setattr(sys, "argv", ["train", "--arch",
                                          "starcoder2-7b", *argv])
        with pytest.raises(SystemExit):
            JT.main()
    assert seen == jseen == ["starcoder2-7b-smoke"] * 2


# ------------------------------------------------- SSM and hybrid training
@pytest.mark.parametrize("arch,mu", [("mamba2-780m", 1), ("mamba2-780m", 2),
                                     ("hymba-1.5b", 1), ("hymba-1.5b", 2)])
def test_ssm_train_step_matches_jax(arch, mu):
    """One step of make_train_step for reduced mamba2-780m and hymba-1.5b
    (fp32 compute, 4 x 48 tokens: a length their chunk of 32 does not
    divide) in both packages from the same state and batch: the metrics
    and the update of every parameter, with the dense step's
    tolerances."""
    jm, jstate, tm, tstate = _state_pair(arch, compute_dtype="float32")
    before = {n: p.detach().clone() for n, p in tstate.params.items()}
    batch = next(token_batches(512, 4, 48, seed=1))
    jstep = jax.jit(j_make_train_step(jm, JOptConfig(warmup_steps=1),
                                      num_microbatches=mu))
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tstep = make_train_step(tm, OptConfig(warmup_steps=1),
                            num_microbatches=mu)
    tstate, tmet = tstep(tstate, {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "ce", "ntok", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    _assert_update(tstate.params, jstate.params, before)
    assert int(tstate.opt["step"]) == int(jstate.opt["step"]) == 1


def test_launch_loop_ssm_matches_jax(tmp_path, monkeypatch, capsys):
    """``launch.train`` with ``--arch mamba2-780m`` (its reduced config in
    fp32 compute) against the JAX entry point's three steps on the same
    token_batches from one step-0 checkpoint, as the dense loop above."""
    import repro.launch.train as JT
    from repro_torch.launch import train as LT
    arch = "mamba2-780m"
    jcfg, tcfg = _cfgs(arch, compute_dtype="float32")
    monkeypatch.setattr(JT, "reduced", lambda c: jcfg)
    init = j_init_train_state(j_build_model(jcfg), jax.random.PRNGKey(0))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for d in (jdir, tdir):
        JC.save_checkpoint(d, init, step=0)
    argv = ["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "32",
            "--save-every", "3", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(jdir)])
    JT.main()
    out = capsys.readouterr().out
    jlosses = [float(line.split("loss=")[1].split()[0])
               for line in out.splitlines() if "loss=" in line]
    seen = {}
    real = LT.train

    def keep(cfg, **kw):
        seen.update(real(tcfg if cfg.name == tcfg.name else cfg,
                         device="cpu", **kw))

    monkeypatch.setattr(LT, "train", keep)
    LT.main([*argv, "--ckpt-dir", str(tdir)])
    assert seen["resumed_from"] == 0 and seen["restarts"] == 0
    assert len(jlosses) == 3
    np.testing.assert_allclose(seen["losses"], jlosses, rtol=0, atol=1e-4)
    jfinal = JC.restore_checkpoint(JC.latest_checkpoint(jdir),
                                   jax.eval_shape(lambda: init))
    before = convert.model_params_from_jax(jax.tree.map(np.asarray,
                                                        init.params))
    _assert_update(seen["state"].params, jfinal.params, before)


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_ssm_checkpoints_cross_both_ways(tmp_path, arch):
    """The SSM tree (``A_log``, ``D``, ``dt_bias``, ``conv_*``, the
    [nh, p, d] ``o``; hymba's attention beside it) through the
    checkpoints: a JAX train state after one step restores into the
    port, and the port's state after one more step restores into JAX,
    parameters and both moments bit for bit."""
    jm, jstate, tm, _ = _state_pair(arch, compute_dtype="float32")
    batch = next(token_batches(512, 2, 32, seed=2))
    jstate, _ = jax.jit(j_make_train_step(jm, JOptConfig(warmup_steps=1)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    JC.save_checkpoint(tmp_path / "jax", jstate, step=1)
    like = init_train_state(tm, torch.Generator().manual_seed(5))
    got = TC.restore_checkpoint(TC.latest_checkpoint(tmp_path / "jax"), like)
    want = convert.train_state_from_jax(
        jax.tree.map(np.asarray, {"params": jstate.params,
                                  "opt": jstate.opt}), device="cpu")
    names = {n.rsplit(".", 1)[-1] for n in got.params if ".ssd." in n}
    assert {"A_log", "D", "dt_bias", "conv_x", "conv_b", "conv_c"} <= names
    assert got.params["layers.0.ssd.o.w"].dim() == 3
    for n, t in want.params.items():
        assert torch.equal(got.params[n].detach(), t.detach()), n
        for part in ("m", "v"):
            assert torch.equal(got.opt[part][n], want.opt[part][n]), n
    state, _ = make_train_step(tm, OptConfig(warmup_steps=1))(
        got, {k: _t(v) for k, v in batch.items()})
    TC.save_checkpoint(tmp_path / "torch", state, step=2)
    back = JC.restore_checkpoint(JC.latest_checkpoint(tmp_path / "torch"),
                                 _jax_state_like(jm))
    assert int(back.opt["step"]) == 2
    for part, tree in (("params", state.params), ("m", state.opt["m"]),
                       ("v", state.opt["v"])):
        jtree = back.params if part == "params" else back.opt[part]
        for a, b in zip(jax.tree.leaves(convert.model_params_to_jax(tree)),
                        jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------- the audio and VLM families
FRONTENDS = ["seamless-m4t-medium", "internvl2-76b"]


def _frontend_batch(cfg, b, s, seed):
    """token_batches' tokens and targets and the family's stub embeddings
    (normal x 0.02 from ``default_rng(seed)``)."""
    batch = dict(next(token_batches(cfg.vocab_size, b, s, seed=seed)))
    key = "patch_embeds" if cfg.family == "vlm" else "frame_embeds"
    batch[key] = (np.random.default_rng(seed).normal(
        size=(b, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch,mu", [("seamless-m4t-medium", 1),
                                     ("seamless-m4t-medium", 2),
                                     ("internvl2-76b", 1)])
def test_frontend_train_step_matches_jax(arch, mu):
    """One step of make_train_step for the reduced seamless-m4t-medium
    (frames through the encoder) and internvl2-76b (patches ahead of the
    text) in fp32 compute, from the same state and batch (micro-batches
    split the stub embeddings with the tokens): the metrics and the
    update of every parameter, the encoder's included, with the dense
    step's tolerances."""
    jm, jstate, tm, tstate = _state_pair(arch, compute_dtype="float32")
    before = {n: p.detach().clone() for n, p in tstate.params.items()}
    batch = _frontend_batch(tm.cfg, 4, 32, seed=1)
    jstep = jax.jit(j_make_train_step(jm, JOptConfig(warmup_steps=1),
                                      num_microbatches=mu))
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tstep = make_train_step(tm, OptConfig(warmup_steps=1),
                            num_microbatches=mu)
    tstate, tmet = tstep(tstate, {k: _t(v) for k, v in batch.items()})
    for k in ("loss", "ce", "ntok", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    _assert_update(tstate.params, jstate.params, before)


def test_adamw_decays_the_jax_set_of_the_encoder_tree():
    """One AdamW step with zero gradients moves exactly the parameters
    that decay: in both packages the same set, every stacked leaf of the
    decoder and the encoder (their norm scales included, rank 2 in the
    JAX tree) and the embedding, and not ``enc_norm`` or ``final_norm``
    (rank 1)."""
    jm, jstate, tm, tstate = _state_pair("seamless-m4t-medium")
    cfg = OptConfig(lr=1e-2, warmup_steps=1, weight_decay=0.5)
    zeros = {n: torch.zeros_like(p) for n, p in tstate.params.items()}
    before = {n: p.detach().clone() for n, p in tstate.params.items()}
    with torch.no_grad():
        params, _, _ = adamw_update(cfg, tstate.params, zeros, tstate.opt)
    moved = {n for n, p in params.items() if not torch.equal(p, before[n])}
    jparams, _, _ = jax.jit(j_adamw_update, static_argnums=0)(
        JOptConfig(lr=1e-2, warmup_steps=1, weight_decay=0.5),
        jstate.params, jax.tree.map(jnp.zeros_like, jstate.params),
        jstate.opt)
    jafter = convert.model_params_from_jax(jax.tree.map(np.asarray,
                                                        jparams))
    jmoved = {n for n, t in jafter.items() if not torch.equal(t, before[n])}
    assert moved == jmoved
    assert set(params) - moved == {"enc_norm.scale", "final_norm.scale"}
    assert "encoder.0.ln1.scale" in moved and "layers.1.ln_x.scale" in moved


@pytest.mark.parametrize("arch", FRONTENDS)
def test_convert_round_trips_the_frontend_trees(arch):
    """A JAX train state of the reduced audio and VLM configs into the
    port and its parameters back, bit for bit: the encoder stacked as
    ``encoder/...`` there and split into ``encoder.<i>.`` here, with
    ``enc_norm`` and each decoder layer's ``xattn`` and ``ln_x``; the
    moments too; in ``init``'s names and shapes."""
    jm, jstate, tm, tstate = _state_pair(arch)
    names = set(tstate.params)
    if arch.startswith("seamless"):
        assert {"enc_norm.scale", "encoder.1.mlp.down.w",
                "layers.0.xattn.o.w"} <= names
    for tree, want in ((tstate.params, jstate.params),
                       (tstate.opt["m"], jstate.opt["m"])):
        back = convert.model_params_to_jax(tree)
        want = jax.tree.map(np.asarray, want)
        assert jax.tree.structure(back) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    params = tm.init(torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in params.items()} == \
        {n: tuple(t.shape) for n, t in tstate.params.items()}


def test_frontend_checkpoints_cross_both_ways(tmp_path):
    """The audio tree (the encoder stacked in the JAX layout) through the
    checkpoints: a JAX train state after one step restores into the port,
    and the port's state after one more step restores into JAX,
    parameters and both moments bit for bit."""
    jm, jstate, tm, _ = _state_pair("seamless-m4t-medium",
                                    compute_dtype="float32")
    batch = _frontend_batch(tm.cfg, 2, 32, seed=2)
    jstate, _ = jax.jit(j_make_train_step(jm, JOptConfig(warmup_steps=1)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    JC.save_checkpoint(tmp_path / "jax", jstate, step=1)
    like = init_train_state(tm, torch.Generator().manual_seed(5))
    got = TC.restore_checkpoint(TC.latest_checkpoint(tmp_path / "jax"), like)
    want = convert.train_state_from_jax(
        jax.tree.map(np.asarray, {"params": jstate.params,
                                  "opt": jstate.opt}), device="cpu")
    assert any(n.startswith("encoder.") for n in got.params)
    for n, t in want.params.items():
        assert torch.equal(got.params[n].detach(), t.detach()), n
        for part in ("m", "v"):
            assert torch.equal(got.opt[part][n], want.opt[part][n]), n
    state, _ = make_train_step(tm, OptConfig(warmup_steps=1))(
        got, {k: _t(v) for k, v in batch.items()})
    TC.save_checkpoint(tmp_path / "torch", state, step=2)
    back = JC.restore_checkpoint(JC.latest_checkpoint(tmp_path / "torch"),
                                 _jax_state_like(jm))
    assert int(back.opt["step"]) == 2
    for part, tree in (("params", state.params), ("m", state.opt["m"]),
                       ("v", state.opt["v"])):
        jtree = back.params if part == "params" else back.opt[part]
        for a, b in zip(jax.tree.leaves(convert.model_params_to_jax(tree)),
                        jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_launch_loop_audio_raises_as_jax(tmp_path, monkeypatch):
    """A JAX fault the port reproduces (ROADMAP Queue 3): the training
    entry point feeds ``token_batches`` only, so for the audio family the
    encoder's ``batch["frame_embeds"]`` raises ``KeyError`` at the first
    step, every restart of ``RestartManager`` (10) meets it again, and
    the error is re-raised: in both packages, with no checkpoint
    written."""
    import repro.launch.train as JT
    from repro_torch.launch import train as LT
    arch = "seamless-m4t-medium"
    argv = ["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16"]
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(tmp_path / "jax")])
    with pytest.raises(KeyError, match="frame_embeds"):
        JT.main()
    seen = []
    real = LT.train

    def on_cpu(cfg, **kw):
        seen.append(cfg.name)
        return real(cfg, device="cpu", **kw)

    monkeypatch.setattr(LT, "train", on_cpu)
    with pytest.raises(KeyError, match="frame_embeds"):
        LT.main([*argv, "--ckpt-dir", str(tmp_path / "torch")])
    assert seen == [f"{arch}-smoke"]
    assert TC.latest_checkpoint(tmp_path / "torch") is None
    assert JC.latest_checkpoint(tmp_path / "jax") is None


def test_launch_loop_vlm_trains_text_only_as_jax(tmp_path, monkeypatch,
                                                 capsys):
    """The same entry point for the VLM family: no ``patch_embeds``, so
    both packages train the decoder on the text alone (the dense path);
    three steps of each from one step-0 checkpoint (fp32 compute) give the
    JAX losses and updates, as the dense loop above."""
    import repro.launch.train as JT
    from repro_torch.launch import train as LT
    arch = "internvl2-76b"
    jcfg, tcfg = _cfgs(arch, compute_dtype="float32")
    monkeypatch.setattr(JT, "reduced", lambda c: jcfg)
    init = j_init_train_state(j_build_model(jcfg), jax.random.PRNGKey(0))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for d in (jdir, tdir):
        JC.save_checkpoint(d, init, step=0)
    argv = ["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "32",
            "--save-every", "3", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(jdir)])
    JT.main()
    out = capsys.readouterr().out
    jlosses = [float(line.split("loss=")[1].split()[0])
               for line in out.splitlines() if "loss=" in line]
    seen = {}
    real = LT.train

    def keep(cfg, **kw):
        seen.update(real(tcfg if cfg.name == tcfg.name else cfg,
                         device="cpu", **kw))

    monkeypatch.setattr(LT, "train", keep)
    LT.main([*argv, "--ckpt-dir", str(tdir)])
    assert seen["resumed_from"] == 0 and seen["restarts"] == 0
    assert len(jlosses) == 3
    np.testing.assert_allclose(seen["losses"], jlosses, rtol=0, atol=1e-4)
    jfinal = JC.restore_checkpoint(JC.latest_checkpoint(jdir),
                                   jax.eval_shape(lambda: init))
    before = convert.model_params_from_jax(jax.tree.map(np.asarray,
                                                        init.params))
    _assert_update(seen["state"].params, jfinal.params, before)
