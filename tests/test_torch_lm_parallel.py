"""The LM half of multi-device training on the port: data-, tensor-,
FSDP- and expert-parallel train steps over a process group, held to the
JAX package's own sharded step and to the port's one-process step.

One world of four gloo ranks on the CPU (``launch.mesh.spawn_world``: a
``FileStore`` under ``tmp_path``, one torch thread a rank, a deadline on
every collective and on the run) runs every mesh of the module in turn,
each mesh a ``Mesh`` over some of its ranks:

- (2, 2), the reduced starcoder2-7b (fp32, GELU MLP with biases; one KV
  head repeated x2 for ``model`` 2): TP, FSDP and DP;
- (1, 4), the same model (KV repeated x4);
- (2, 1) on ranks 0-1, DP and FSDP only, two micro-batches a step;
- (2, 2), the reduced qwen3-moe-30b with ``expert_tp``;
- the elastic round trip: (2, 2)'s state after its two steps
  checkpointed, restored onto (1, 2) on ranks 0-1 through
  ``elastic_reshard``, and two more steps;
- the controls on (2, 2): the ``o`` projection without its ``model``
  reduce, and the CE over the local token count.

Each mesh runs the first batch's logits, loss and gradients, then two
train steps from the JAX weights (``convert.shard_params_from_jax``), and
gathers what it got. One subprocess with four forced host devices runs
the JAX package's sharded step for the same meshes, built as
``launch/dryrun.py:126-176`` builds it, and executes it. The port's
one-process step runs here, beside the world.

The logits, losses and gradients are held at
``test_torch_models.py::test_model_matches_jax_float32``'s tolerances.
The updated parameters are held as ``test_torch_train.py`` holds an
AdamW update against JAX's: each parameter's update within 1% of its
norm. Element by element they are not comparable at the gradients'
tolerance: AdamW divides each gradient element by its own magnitude, so
an element near ``eps`` turns its rounding into the update. Attention's
key bias gets almost no gradient (the softmax ignores a shift common to
the keys, up to RoPE), and at two micro-batches JAX's and the port's
*one-process* steps already part by 9x the gradients' elementwise
tolerance on one element of an MLP bias.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MeshConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import WorldError, make_mesh_from_config, \
    spawn_world
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainState, make_train_step

AXES = ("data", "model")
WORLD = 4
B, S, STEPS = 4, 32, 2
DENSE = dict(arch="starcoder2-7b", compute_dtype="float32",
             mlp_variant="gelu", use_bias=True)
MOE = dict(arch="qwen3-moe-30b-a3b", compute_dtype="float32")
CONFIGS = {"dense": DENSE, "moe": MOE}
#: name -> (config, mesh shape, ranks, micro-batches)
MESHES = {
    "dense22": ("dense", (2, 2), (0, 1, 2, 3), 1),
    "dense14": ("dense", (1, 4), (0, 1, 2, 3), 1),
    "dense21": ("dense", (2, 1), (0, 1), 2),
    "moe22": ("moe", (2, 2), (0, 1, 2, 3), 1),
}
ELASTIC_MESH = (1, 2)
CONTROLS = ("no_o_reduce", "local_ntok")
TIMEOUT_S = 240.0


def port_cfg(kind):
    kw = dict(CONFIGS[kind])
    return dataclasses.replace(reduced(get_config(kw.pop("arch"))), **kw)


def _nest(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def jax_tree(inputs, kind):
    return _nest({k[len(kind) + 1:]: inputs[k] for k in inputs.files
                  if k.startswith(kind + "/")})


def batch_at(inputs, kind, i):
    return {"tokens": torch.from_numpy(inputs[f"tokens_{kind}"][i]),
            "targets": torch.from_numpy(inputs[f"targets_{kind}"][i])}


# ------------------------------------------------------------- the ranks
def _context(kind, shape, ranks):
    mesh_cfg = MeshConfig(shape, AXES)
    cfg = port_cfg(kind)
    mesh = make_mesh_from_config(mesh_cfg, "cpu", ranks=ranks)
    prof = shd.sharding_profile(cfg, mesh_cfg, B, S)
    ctx = shd.ShardCtx(mesh, shd.make_rules(cfg, mesh_cfg, B, S), prof)
    return cfg, mesh, ctx


def _gather(ctx, t, pspec):
    from repro_torch.train.elastic import Placement
    return Placement(ctx.mesh, pspec).gather(t.detach()).numpy()


def _first_batch(model, ctx, params, batch, moe_io=None):
    """Logits, loss and reduced gradients of ``batch``, gathered."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.train.train_step import local_batch, reduce_grads
    lb = local_batch(batch, ctx)
    plain = moe_mod.moe_forward

    def recording(p, x, cfg):
        y, aux = plain(p, x, cfg)
        moe_io.append((x.detach().numpy(), y.detach().numpy()))
        return y, aux

    if moe_io is not None:
        moe_mod.moe_forward = recording
    try:
        with torch.no_grad():
            logits, _ = model.train_logits(params, lb)
    finally:
        moe_mod.moe_forward = plain
    batch_spec = ctx.profile.batch_axes or None
    out = {"logits": _gather(ctx, logits, (batch_spec, None,
                                           ctx.rules[shd.VOCAB]))}
    loss, metrics = model.loss(params, lb)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    grads = reduce_grads(grads, model, ctx)
    specs = model.specs()
    out["loss0"] = float(metrics["loss"])
    out["grads"] = {n: _gather(ctx, g, ctx.pspec(*specs[n]))
                    for n, g in grads.items()}
    return out


def _train(model, ctx, state, inputs, kind, first, mu):
    step = make_train_step(model, num_microbatches=mu)
    losses = []
    for i in range(first, first + STEPS):
        state, metrics = step(state, batch_at(inputs, kind, i))
        losses.append(float(metrics["loss"]))
    return state, losses


def _gathered_params(model, ctx, params):
    return {n: t.numpy() for n, t in convert.model_params_from_jax(
        convert.gather_params_to_jax(params, model, ctx)).items()}


def _run_mesh(name, inputs, rank, results):
    kind, shape, ranks, mu = MESHES[name]
    cfg, mesh, ctx = _context(kind, shape, ranks)
    if not mesh.member:
        return None
    with shd.use_ctx(ctx):
        model = build_model(cfg, kv_repeat=ctx.profile.kv_repeat,
                            device="cpu")
        params = convert.shard_params_from_jax(jax_tree(inputs, kind), model)
        moe_io = [] if kind == "moe" else None
        out = _first_batch(model, ctx, params, batch_at(inputs, kind, 0),
                           moe_io)
        state = TrainState(params=params, opt=adamw_init(params))
        state, out["losses"] = _train(model, ctx, state, inputs, kind, 0, mu)
        out["params"] = _gathered_params(model, ctx, state.params)
    results[name] = out if mesh.rank == 0 else None
    if moe_io is not None:
        results[f"{name}/moe_io/{mesh.rank}"] = dict(
            data=mesh.index("data"), io=moe_io)
    return model, ctx, state


def _elastic(inputs, first, ckpt_dir, rank, results):
    """(2, 2)'s state after two steps, checkpointed, restored onto (1, 2)
    on ranks 0-1 through ``elastic_reshard``; two more steps."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import elastic_reshard
    model, ctx, state = first
    with shd.use_ctx(ctx):
        path = ckpt.save_checkpoint(ckpt_dir, state, STEPS, model=model)
    cfg, mesh, ctx2 = _context("dense", ELASTIC_MESH, (0, 1))
    if not mesh.member:
        return
    full = build_model(cfg, kv_repeat=ctx2.profile.kv_repeat, device="cpu")
    like = TrainState(params={n: t.detach() for n, t in
                              full.init(torch.Generator().manual_seed(1))
                              .items()}, opt=None)
    like.opt = adamw_init(like.params)
    ckpt.restore_checkpoint(path, like)
    with shd.use_ctx(ctx2):
        model2 = build_model(cfg, kv_repeat=ctx2.profile.kv_repeat,
                             device="cpu")
        state2 = elastic_reshard(like, model2, mesh,
                                 MeshConfig(ELASTIC_MESH, AXES), B)
        state2, losses = _train(model2, ctx2, state2, inputs, "dense",
                                STEPS, 1)
        params = _gathered_params(model2, ctx2, state2.params)
        step = int(state2.opt["step"])
    if mesh.rank == 0:
        results["elastic"] = dict(losses=losses, params=params, step=step)


def _controls(inputs, rank, results):
    """The (2, 2) dense mesh's first batch with one collective dropped."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as lyr
    from repro_torch.models import transformer as tr
    for name in CONTROLS:
        kind, shape, ranks, _ = MESHES["dense22"]
        cfg, mesh, ctx = _context(kind, shape, ranks)
        saved = (attn_mod.row_parallel, tr._global_ntok)
        if name == "no_o_reduce":
            attn_mod.row_parallel = lambda p, x, cd, n, m, a: \
                lyr.row_parallel(p, x, cd, n, None, None)
        else:
            tr._global_ntok = lambda ntok, mesh, axes: ntok.detach()
        try:
            with shd.use_ctx(ctx):
                model = build_model(cfg, kv_repeat=ctx.profile.kv_repeat,
                                    device="cpu")
                params = convert.shard_params_from_jax(
                    jax_tree(inputs, kind), model)
                out = _first_batch(model, ctx, params,
                                   batch_at(inputs, kind, 0))
        finally:
            attn_mod.row_parallel, tr._global_ntok = saved
        if mesh.rank == 0:
            results[f"control/{name}"] = out


def _refusals(results):
    """Under a (1, 2) mesh on ranks 0-1: an SSM model refuses to build,
    and a dense model's ``decode_step`` refuses to run."""
    cfg, mesh, ctx = _context("dense", (1, 2), (0, 1))
    if not mesh.member:
        return
    raised = {}
    with shd.use_ctx(ctx):
        try:
            build_model(reduced(get_config("mamba2-780m")), device="cpu")
        except NotImplementedError:
            raised["ssm"] = True
        model = build_model(cfg, kv_repeat=ctx.profile.kv_repeat,
                            device="cpu")
        model.init(torch.Generator().manual_seed(0))
        try:
            model.decode_step(None, torch.zeros((2, 1), dtype=torch.long),
                              {"pos": torch.zeros((), dtype=torch.int32),
                               "layers": {}})
        except NotImplementedError:
            raised["decode_step"] = True
    if mesh.rank == 0:
        results["refusals"] = raised


def world_rank(rank, inputs_path, ckpt_dir):
    """One rank of the module's world: every mesh, the elastic round trip,
    the controls and the refusals, in one order on every rank."""
    inputs = np.load(inputs_path)
    results = {}
    first = None
    for name in MESHES:
        got = _run_mesh(name, inputs, rank, results)
        if name == "dense22":
            first = got
    _elastic(inputs, first, ckpt_dir, rank, results)
    _controls(inputs, rank, results)
    _refusals(results)
    return results


# ------------------------------------------------------ the JAX reference
_JAX_STEP = r'''
import os
import sys
# two cores a process, so that the module's processes do not crowd out
# the suite's other workers
os.sched_setaffinity(0, {int(c) for c in
                         os.environ["JAX_STEP_CORES"].split(",")})
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config, reduced
from repro.configs.base import MeshConfig, ShapeConfig
from repro.distributed import sharding as shd
from repro.models.model import build_model
from repro.train.optimizer import adamw_init
from repro.train.train_step import (TrainState, choose_microbatches,
                                    choose_remat_group, make_train_state_specs,
                                    make_train_step)
import dataclasses, json

spec = json.loads(sys.argv[3])
inputs = np.load(sys.argv[1])
out = {}


def nest(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    return tree


def flat(tree, prefix=""):
    o = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            o.update(flat(v, f"{prefix}{k}/"))
        else:
            o[f"{prefix}{k}"] = np.asarray(v)
    return o


def shardings(mesh, logical, rules):
    return jax.tree.map(
        lambda s: NamedSharding(mesh, shd.logical_to_pspec(s, rules)),
        logical, is_leaf=lambda x: isinstance(x, tuple))


for name, (kind, shape, mu) in spec["meshes"].items():
    kw = dict(spec["configs"][kind])
    cfg = dataclasses.replace(reduced(get_config(kw.pop("arch"))), **kw)
    b, s = spec["batch"], spec["seq"]
    mesh_cfg = MeshConfig(tuple(shape), ("data", "model"))
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    cell = ShapeConfig("world", s, b, "train")
    # launch/dryrun.py:126-176, executed
    profile = shd.sharding_profile(cfg, mesh_cfg, b, s, "train")
    rules = shd.make_rules(cfg, mesh_cfg, b, s, "train")
    mu_probe = choose_microbatches(cfg, cell, mesh_cfg, profile)
    remat_group = choose_remat_group(cfg, cell, mesh_cfg, profile, mu_probe)
    model = build_model(cfg, kv_repeat=profile.kv_repeat,
                        remat_group=remat_group)
    ctx = shd.ShardCtx(mesh=mesh, rules=rules, profile=profile)
    params = nest({k[len(kind) + 1:]: inputs[k] for k in inputs.files
                   if k.startswith(kind + "/")})
    bspec = NamedSharding(mesh, shd.logical_to_pspec(("batch", None),
                                                     rules))
    with shd.use_ctx(ctx):
        p_sh = shardings(mesh, model.specs(), rules)
        state_sh = shardings(mesh, make_train_state_specs(model), rules)
        batch_sh = {"tokens": bspec, "targets": bspec}
        train_step = make_train_step(model, num_microbatches=mu)

        def step_and_grads(state, batch):
            # the step, and the logits and gradients it starts from: one
            # program, one compile
            logits, _ = model.train_logits(state.params, batch)
            (loss, m), g = jax.value_and_grad(model.loss, has_aux=True)(
                state.params, batch)
            new_state, metrics = train_step(state, batch)
            return logits, loss, g, new_state, metrics

        params = jax.device_put(params, p_sh)
        batches = [{"tokens": jax.device_put(
                        jnp.asarray(inputs[f"tokens_{kind}"][i]), bspec),
                    "targets": jax.device_put(
                        jnp.asarray(inputs[f"targets_{kind}"][i]), bspec)}
                   for i in range(spec["steps"])]
        step = jax.jit(step_and_grads, in_shardings=(state_sh, batch_sh),
                       out_shardings=(None, None, p_sh, state_sh, None))
        # placed as the step's output is, so that the second call reuses
        # the first call's program
        state = jax.device_put(
            TrainState(params=params, opt=adamw_init(params)), state_sh)
        losses = []
        for i, bt in enumerate(batches):
            got = step(state, bt)
            if i == 0:
                logits, loss, grads = got[:3]
            state, metrics = got[3:]
            losses.append(float(metrics["loss"]))
    out[f"{name}/logits"] = np.asarray(logits)
    out[f"{name}/loss0"] = np.asarray(loss)
    out[f"{name}/losses"] = np.asarray(losses)
    for k, v in flat(jax.tree.map(np.asarray, grads)).items():
        out[f"{name}/grads/{k}"] = v
    for k, v in flat(jax.tree.map(np.asarray, state.params)).items():
        out[f"{name}/params/{k}"] = v
np.savez(sys.argv[2], **out)
print("ok", len(jax.devices()))
'''


# -------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX weights and batches, the world's results, the JAX sharded
    step's and the port's one-process step's, for every mesh."""
    import jax
    from repro.configs import get_config as j_get_config, reduced as j_reduced
    from repro.models.model import build_model as j_build_model
    from repro_torch.data.generators import token_batches

    tmp = tmp_path_factory.mktemp("lm_world")
    arrays = {}
    for kind, kw in CONFIGS.items():
        kw = dict(kw)
        jcfg = dataclasses.replace(j_reduced(j_get_config(kw.pop("arch"))),
                                   **kw)
        jparams = jax.jit(j_build_model(jcfg).init)(jax.random.PRNGKey(7))
        arrays.update({f"{kind}/{k}": v for k, v in
                       _flat(jax.tree.map(np.asarray, jparams)).items()})
        gen = token_batches(jcfg.vocab_size, B, S, seed=11)
        bs = [next(gen) for _ in range(2 * STEPS)]
        toks = np.stack([b["tokens"] for b in bs])
        tgts = np.stack([b["targets"] for b in bs])
        tgts[:, 0, :9] = -1     # the first data shard counts fewer tokens
        arrays[f"tokens_{kind}"], arrays[f"targets_{kind}"] = toks, tgts
    inputs_path = tmp / "inputs.npz"
    np.savez(inputs_path, **arrays)

    import json
    import threading
    script = tmp / "jax_step.py"
    script.write_text(_JAX_STEP)
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    procs = []
    cores = sorted(os.sched_getaffinity(0))
    for i, names in enumerate([n] for n in MESHES):
        spec = {"meshes": {n: (MESHES[n][0], list(MESHES[n][1]),
                               MESHES[n][3]) for n in names},
                "configs": CONFIGS, "batch": B, "seq": S, "steps": STEPS}
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(inputs_path),
             str(tmp / f"jax{i}.npz"), json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**env, "JAX_STEP_CORES": ",".join(str(cores[j % len(cores)])
                                                   for j in (2 * i,
                                                             2 * i + 1))}))
    ranks = {}

    def run_world():
        try:
            ranks["out"] = spawn_world(world_rank, WORLD,
                                       (str(inputs_path), str(tmp / "ckpt")),
                                       timeout_s=TIMEOUT_S,
                                       workdir=tmp / "world")
        except BaseException as e:   # raised below, in the test's thread
            ranks["error"] = e

    world_thread = threading.Thread(target=run_world)
    world_thread.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = one_process(np.load(inputs_path))
        world_thread.join(TIMEOUT_S)
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if "error" in ranks:
        raise ranks["error"]
    assert "out" in ranks, "the world did not finish"
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.split() == ["ok", "4"]
    got = {}
    for r in ranks["out"]:
        got.update({k: v for k, v in r.items() if v is not None})
    want = {}
    for i in range(len(procs)):
        with np.load(tmp / f"jax{i}.npz") as z:
            want.update({k: z[k] for k in z.files})
    jax_ref = {}
    for name in MESHES:
        def sub(tag):
            pre = f"{name}/{tag}/"
            return convert.model_params_from_jax(_nest(
                {k[len(pre):]: want[k] for k in want
                 if k.startswith(pre)}))
        jax_ref[name] = dict(
            logits=want[f"{name}/logits"], loss0=float(want[f"{name}/loss0"]),
            losses=list(want[f"{name}/losses"]),
            grads={n: t.numpy() for n, t in sub("grads").items()},
            params={n: t.numpy() for n, t in sub("params").items()})
    return dict(got=got, jax=jax_ref, one=one, inputs_path=inputs_path)


def one_process(inputs):
    """The port's one-process logits, loss, gradients and steps (four for
    the elastic reference), for each config and micro-batch depth."""
    out = {}
    for name, (kind, shape, _, mu) in MESHES.items():
        cfg = port_cfg(kind)
        prof = shd.sharding_profile(cfg, MeshConfig(shape, AXES), B, S)
        model = build_model(cfg, kv_repeat=prof.kv_repeat, device="cpu")
        params = convert.shard_params_from_jax(jax_tree(inputs, kind), model)
        b0 = batch_at(inputs, kind, 0)
        with torch.no_grad():
            logits, _ = model.train_logits(params, b0)
        loss, _ = model.loss(params, b0)
        grads = torch.autograd.grad(loss, list(params.values()))
        rec = dict(logits=logits.numpy(), loss0=float(loss),
                   grads={n: g.numpy() for n, g in zip(params, grads)})
        state = TrainState(params=params, opt=adamw_init(params))
        step = make_train_step(model, num_microbatches=mu)
        n_steps = 2 * STEPS if name == "dense22" else STEPS
        losses = []
        for i in range(n_steps):
            state, m = step(state, batch_at(inputs, kind, i))
            losses.append(float(m["loss"]))
            if i == STEPS - 1:
                rec["params"] = {n: t.detach().numpy().copy()
                                 for n, t in state.params.items()}
        rec["losses"] = losses[:STEPS]
        if name == "dense22":
            rec["elastic"] = dict(losses=losses[STEPS:], params={
                n: t.detach().numpy() for n, t in state.params.items()})
        out[name] = rec
    return out


# ----------------------------------------------------------------- checks
def _close(got, want, what):
    """test_model_matches_jax_float32's tolerance: rtol 1e-3 with atol
    1e-5 of the reference's largest magnitude, name by name."""
    assert set(got) == set(want), what
    for n in want:
        scale = float(np.abs(want[n]).max())
        np.testing.assert_allclose(got[n], want[n], rtol=1e-3,
                                   atol=1e-5 * max(scale, 1e-3),
                                   err_msg=f"{what}: {n}")


def _updates_close(got, want, before, what):
    """Each parameter's update within 1% of its norm
    (``test_torch_train.py::_assert_update``)."""
    assert set(got) == set(want) == set(before), what
    for n, w in want.items():
        err = np.linalg.norm(got[n] - w)
        assert err <= 1e-2 * np.linalg.norm(w - before[n]), (what, n, err)


def _initial(world, kind):
    inputs = np.load(world["inputs_path"])
    return {n: t.numpy() for n, t in
            convert.model_params_from_jax(jax_tree(inputs, kind)).items()}


def _hold(world, got, want, what):
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=1e-4, err_msg=what)
    assert abs(got["loss0"] - want["loss0"]) <= 1e-5, what
    _close(got["grads"], want["grads"], f"{what} gradients")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5, err_msg=what)
    kind = MESHES[what.split()[0]][0]
    _updates_close(got["params"], want["params"], _initial(world, kind),
                   f"{what} parameters")


@pytest.mark.parametrize("name", [n for n in MESHES if n != "moe22"])
@pytest.mark.parametrize("ref", ["jax", "one"])
def test_world_matches_reference(world, name, ref):
    """Logits, loss, gradients, the two steps' losses and the updated
    parameters of each dense mesh against JAX's executed sharded step
    and against the port's one-process step."""
    _hold(world, world["got"][name], world[ref][name], f"{name} vs {ref}")


def test_moe_world_matches_jax_sharded_step(world):
    """The MoE mesh against JAX's sharded step only: JAX's expert
    parallelism takes each expert's capacity from the data shard's token
    count, which the one-process step computes from the whole batch."""
    _hold(world, world["got"]["moe22"], world["jax"]["moe22"], "moe22")


def test_moe_layers_match_one_process_moe_forward_per_data_shard(world):
    """Each rank's expert-parallel ``moe_forward``, layer by layer,
    against the one-process ``moe_forward`` of the same data shard's
    tokens with the full weights (JAX's EP semantics: capacity from the
    local count, each expert's top-C among those tokens)."""
    from repro_torch.models.moe import moe_forward
    inputs = np.load(world["inputs_path"])
    cfg = port_cfg("moe")
    full = convert.model_params_from_jax(jax_tree(inputs, "moe"))
    records = {k: v for k, v in world["got"].items() if "/moe_io/" in k}
    assert len(records) == WORLD
    assert {r["data"] for r in records.values()} == {0, 1}
    for key, rec in records.items():
        assert len(rec["io"]) == cfg.num_layers
        for layer, (x, y) in enumerate(rec["io"]):
            p = {"router": {"w": full[f"layers.{layer}.moe.router.w"]},
                 **{w: full[f"layers.{layer}.moe.{w}"]
                    for w in ("wg", "wu", "wd")}}
            with torch.no_grad():
                want, _ = moe_forward(p, torch.from_numpy(x), cfg)
            np.testing.assert_allclose(y, want.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{key} {layer}")


def test_elastic_round_trip_equals_four_one_process_steps(world):
    """Two steps on (2, 2), a checkpoint of the full arrays, the restore
    onto (1, 2) through ``elastic_reshard`` and two more steps: the
    losses and parameters of four one-process steps."""
    got, want = world["got"]["elastic"], world["one"]["dense22"]["elastic"]
    assert got["step"] == 2 * STEPS
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=1e-5)
    _updates_close(got["params"], want["params"], _initial(world, "dense"),
                   "elastic parameters")


def test_refusals_under_a_mesh(world):
    """An SSM family under a (1, 2) mesh, and ``decode_step`` under a
    mesh, raise ``NotImplementedError``."""
    assert world["got"]["refusals"] == {"ssm": True, "decode_step": True}


@pytest.mark.parametrize("control", CONTROLS)
def test_control_fails_the_comparison(world, control):
    """The (2, 2) mesh without the ``o`` projection's ``model`` reduce, or
    with the CE over the local token count, must not meet the one-process
    gradients."""
    with pytest.raises(AssertionError):
        got = world["got"][f"control/{control}"]
        want = world["one"]["dense22"]
        assert abs(got["loss0"] - want["loss0"]) <= 1e-5
        _close(got["grads"], want["grads"], control)


def _fails_on_rank_1(rank):
    import torch.distributed as dist
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.all_reduce(torch.zeros(1))     # rank 1 never joins it
    return rank


def test_a_failing_rank_fails_the_world_within_its_deadline(tmp_path):
    """A rank that raises fails the world with its traceback, and the rank
    left waiting in a collective is terminated, well inside the world's
    deadline: no world can hang the suite."""
    t0 = time.monotonic()
    with pytest.raises(WorldError, match="rank 1 fails"):
        spawn_world(_fails_on_rank_1, 2, timeout_s=60.0, workdir=tmp_path)
    assert time.monotonic() - t0 < 60.0
