"""The port's dry-run (``launch/dryrun.py``) against the JAX package's.

- Every cell of the two production meshes at full width: the profile,
  the state and cache bytes a rank holds and the parameter counts of
  the port's cell (built on ``meta`` as rank 0 of a fake world of 256
  or 512 ranks) equal what JAX's own helpers give in one subprocess
  (``jax.eval_shape`` under ``_shardings_from_logical`` and
  ``_tree_bytes_per_device``, nothing lowered).
- JAX's ``lower_cell`` itself on one reduced cell of each kind at a
  (2, 2) mesh of four placeholder devices, against the port's record of
  the same cell: every key both derive from the configs is equal.
- The SSM family's full-width prefill and decode cells traced on meta
  (the other families' are in ``test_torch_dryrun_cells.py``), the
  prefill in a process of its own beside the file's other tests.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, applicable_shapes, get_config, \
    reduced
from repro_torch.configs.base import MeshConfig, ShapeConfig
from repro_torch.launch import dryrun
from test_torch_dryrun_cells import finish_trace, start_trace, \
    trace_full_width

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
#: the reduced cells of the JAX ``lower_cell`` comparison: (arch, shape)
REDUCED = {
    "train": ("starcoder2-7b", ShapeConfig("train_r", 64, 8, "train")),
    "prefill": ("hymba-1.5b", ShapeConfig("prefill_r", 64, 4, "prefill")),
    "decode": ("qwen3-moe-30b-a3b", ShapeConfig("decode_r", 64, 4,
                                                "decode")),
}
SMALL_MESH = MeshConfig((2, 2), ("data", "model"))
#: the record's keys that each side measures, not derives from the
#: configs: JAX's ``collectives`` are the partitioned HLO's ops, the
#: port's the calls of ``distributed/collectives.py``
MEASURED = ("collectives", "total_s")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# every cell of both production meshes: JAX's helpers, no lowering
_JAX_BYTES = r"""
import json, sys
import jax
import numpy as np
from repro.launch import dryrun as D
from repro.configs import ARCHS, applicable_shapes
from repro.distributed import sharding as shd
from repro.launch.mesh import mesh_config
from repro.models.model import build_model, input_specs
from repro.train.train_step import (choose_microbatches, choose_remat_group,
    init_train_state, make_train_state_specs)

out = {}
for name in ("single", "multi"):
    mcfg = mesh_config(multi_pod=name == "multi")
    devs = np.array(jax.devices()[:mcfg.num_devices]).reshape(mcfg.shape)
    mesh = jax.sharding.Mesh(devs, mcfg.axes)
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch]
        for shape in applicable_shapes(cfg):
            args = (shape.global_batch, shape.seq_len, shape.kind)
            prof = shd.sharding_profile(cfg, mcfg, *args)
            rules = shd.make_rules(cfg, mcfg, *args)
            profile = {
                "attn_tp": prof.attn_tp, "mlp_tp": prof.mlp_tp,
                "vocab_tp": prof.vocab_tp, "expert_tp": prof.expert_tp,
                "ssd_tp": prof.ssd_tp, "kv_repeat": prof.kv_repeat,
                "kv_seq_shard": prof.kv_seq_shard,
                "batch_axes": list(prof.batch_axes),
                "notes": list(prof.notes)}
            group = 0
            if shape.kind == "train":
                mu = choose_microbatches(cfg, shape, mcfg, prof)
                group = choose_remat_group(cfg, shape, mcfg, prof, mu)
                profile["num_microbatches"] = mu
            profile["remat_group"] = group
            model = build_model(cfg, kv_repeat=prof.kv_repeat,
                                remat_group=group)
            ctx = shd.ShardCtx(mesh=mesh, rules=rules, profile=prof)
            rec = {"profile": profile, "model_params": cfg.param_count(),
                   "model_active_params": cfg.active_param_count()}
            key = jax.random.PRNGKey(0)
            with shd.use_ctx(ctx):
                if shape.kind == "train":
                    sds = jax.eval_shape(lambda: init_train_state(model, key))
                    logical = make_train_state_specs(model)
                else:
                    sds = jax.eval_shape(lambda: model.init(key))
                    logical = model.specs()
                rec["state_bytes_per_device"] = D._tree_bytes_per_device(
                    sds, D._shardings_from_logical(mesh, logical, rules))
                if shape.kind == "decode":
                    bsds, blogical = input_specs(cfg, shape, model)
                    bsh = D._shardings_from_logical(mesh, blogical, rules)
                    rec["cache_bytes_per_device"] = D._tree_bytes_per_device(
                        bsds["cache"], bsh["cache"])
            out[f"{name}__{arch}__{shape.name}"] = rec
print(json.dumps(out))
"""

# JAX's lower_cell on the reduced cells at (2, 2): LLVM's backend
# optimizations are off (compiling, not running, is the process's time),
# so the backend starts before the dry-run module rewrites XLA_FLAGS. The
# mesh's axes are Auto, as ``jax.sharding.Mesh`` makes them: the
# installed JAX's ``jax.make_mesh`` (``launch/mesh.py``) makes Explicit
# axes, which the JAX package's ``constrain`` refuses
_JAX_LOWER = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0")
import jax
import numpy as np
jax.devices()
from repro.launch import dryrun as D
from repro.configs import ARCHS, reduced
from repro.configs.base import MeshConfig, ShapeConfig

mcfg = MeshConfig((2, 2), ("data", "model"))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         mcfg.axes)
out = {}
for kind, (arch, shape) in json.loads(sys.argv[1]).items():
    rec = D.lower_cell(reduced(ARCHS[arch]), ShapeConfig(*shape), mcfg, mesh)
    out[kind] = rec
print(json.dumps(out))
"""


def _start(code: str, devices: int, *args) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "REPRO_DRYRUN_DEVICES": str(devices)}
    return subprocess.Popen([sys.executable, "-c", code, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _finish(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_side():
    """Both JAX subprocesses, started together and left to run while the
    port builds its side."""
    spec = {kind: (arch, [s.name, s.seq_len, s.global_batch, s.kind])
            for kind, (arch, s) in REDUCED.items()}
    procs = {"bytes": _start(_JAX_BYTES, 512),
             "lower": _start(_JAX_LOWER, 4, json.dumps(spec))}
    try:
        yield {k: (lambda p=p: _finish(p)) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def _port_cells(name: str) -> dict:
    """Every cell of the mesh ``name``, built on meta as rank 0."""
    mcfg = dryrun.mesh_config_of(name)
    out = {}
    with dryrun.fake_world(mcfg.num_devices):
        mesh = dryrun.make_mesh(name, "meta")
        for arch in sorted(ARCHS):
            cfg = ARCHS[arch]
            for shape in applicable_shapes(cfg):
                out[f"{name}__{arch}__{shape.name}"] = dryrun.build_cell(
                    cfg, shape, mcfg, mesh).rec
    return out


def test_every_production_cell_holds_jax_bytes(jax_side):
    """64 cells (32 a mesh: 10 archs x 3 shapes, and long_500k for
    mamba2-780m and hymba-1.5b): the profile, the micro-batches and remat
    group, the state and cache bytes of rank 0 and the parameter counts
    equal JAX's, exactly."""
    port = {}
    for name in MESHES:
        port.update(_port_cells(name))
    jax = jax_side["bytes"]()
    assert len(port) == 64 and set(port) == set(jax)
    keys = ("profile", "state_bytes_per_device", "model_params",
            "model_active_params")
    for tag, want in jax.items():
        got = port[tag]
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}, tag
        assert got.get("cache_bytes_per_device") == \
            want.get("cache_bytes_per_device"), tag
    # the figures the port's dry-run first met JAX on
    assert port["single__starcoder2-7b__train_4k"][
        "state_bytes_per_device"] == 1_416_579_076
    assert port["single__internvl2-76b__decode_32k"][
        "cache_bytes_per_device"] == 5_368_709_124


def test_jax_lower_cell_records_match(jax_side):
    """The port's record of each reduced cell against JAX's
    ``lower_cell``'s: every key both derive from the configs is equal;
    the measured ones (``MEASURED``) hold each collective's count and
    bytes on both sides."""
    port = {}
    with dryrun.fake_world(SMALL_MESH.num_devices):
        mesh = dryrun.make_mesh_from_config(SMALL_MESH, "meta")
        for kind, (arch, shape) in REDUCED.items():
            port[kind] = dryrun.lower_cell(reduced(get_config(arch)), shape,
                                           SMALL_MESH, mesh)
    jax = jax_side["lower"]()
    for kind, want in jax.items():
        got = port[kind]
        shared = set(got) & set(want)
        assert {"arch", "shape", "kind", "mesh", "chips", "variant",
                "profile", "state_bytes_per_device", "model_params",
                "model_active_params", "collectives"} <= shared, kind
        if kind == "decode":
            assert "cache_bytes_per_device" in shared
        for key in sorted(shared - set(MEASURED)):
            assert got[key] == want[key], (kind, key)
        for rec in (got, want):
            assert rec["collectives"] and all(
                set(v) == {"count", "bytes"} and v["count"] > 0
                for v in rec["collectives"].values()), (kind, rec)


@pytest.fixture(scope="module", autouse=True)
def ssm_prefill():
    """mamba2-780m's full-width prefill, traced in a process of its own
    from the file's first test on."""
    proc = start_trace("mamba2-780m", "prefill_32k")
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_ssm_cells_trace_at_full_width(shape, ssm_prefill):
    """mamba2-780m's decode and prefill on 16 x 16 traced on meta at full
    width (SSD heads over ``model``): the record is whole and the
    sharded step moved data through the mesh's collectives. The prefill
    (last in the file) has traced in its own process meanwhile."""
    rec = finish_trace(ssm_prefill) if shape == "prefill_32k" \
        else trace_full_width("mamba2-780m", shape)
    assert rec["shape"] == shape and rec["profile"]["ssd_tp"]
