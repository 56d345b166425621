"""The port's dry-run (``launch/dryrun.py``) cell by cell, on the CPU.

- ``input_specs`` against the JAX function: the same keys, shapes,
  dtypes and logical axes for every (arch, shape) cell.
- Full-width meta traces of the prefill and decode cells of the dense,
  MoE, hybrid, VLM and audio families on 16 x 16 (the SSM family's are
  in ``test_torch_dryrun.py``), and every family's train cell at reduced
  width on (2, 2).
- At reduced width, a cell realized on the CPU against the same cell on
  meta: equal state bytes, collective counts, flops and peak.
- The command line writes each record and ``skipped.json``; a cell made
  to fail records its traceback and the run exits 1; with no device and
  no CUDA it raises.
- One reduced dense prefill cell's flops against the closed-form count
  of its matrix products, and against ``FlopCounterMode``'s.
- The kernels' one registry of counting wrappers, and ``chip_smoke.py``
  phase 29's replays of kept launches against the plain versions, with
  their controls and their slices, on CPU tensors.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as J_ARCHS
from repro.models.model import build_model as j_build_model
from repro.models.model import input_specs as j_input_specs
from repro_torch.configs import ARCHS, SHAPES_BY_NAME, applicable_shapes, \
    get_config, reduced, skipped_cells
from repro_torch.configs.base import MeshConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models.model import build_model, input_specs

ROOT = Path(__file__).resolve().parents[1]
SMALL_MESH = MeshConfig((2, 2), ("data", "model"))
#: reduced shapes of each kind (the names are the cells')
SMALL_SHAPES = {"train": ShapeConfig("train_4k", 64, 8, "train"),
                "prefill": ShapeConfig("prefill_32k", 64, 4, "prefill"),
                "decode": ShapeConfig("decode_32k", 64, 4, "decode")}
#: one arch of each family
FAMILIES = {"dense": "starcoder2-7b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-780m", "hybrid": "hymba-1.5b",
            "vlm": "internvl2-76b", "audio": "seamless-m4t-medium"}
CELLS = [(arch, s.name) for arch in sorted(ARCHS)
         for s in applicable_shapes(ARCHS[arch])]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one full-width cell traced on meta as rank 0 of 16 x 16, its record
# printed: the SSM and hybrid prefills (the plain SSD scan's 128 chunks a
# layer, each elementwise op through PyTorch's Python meta functions)
# trace in a process of their own while the file's other tests run
_TRACE = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import dryrun
mcfg = dryrun.mesh_config_of("single")
with dryrun.fake_world(mcfg.num_devices):
    rec = dryrun.lower_cell(get_config(sys.argv[1]),
                            SHAPES_BY_NAME[sys.argv[2]], mcfg,
                            dryrun.make_mesh("single", "meta"))
print(json.dumps(rec))
"""


def start_trace(arch: str, shape: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.Popen([sys.executable, "-c", _TRACE, arch, shape],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def finish_trace(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return check_full_width(json.loads(out.strip().splitlines()[-1]))


def trace_full_width(arch: str, shape: str) -> dict:
    """The cell traced on meta as rank 0 of 16 x 16, in this process."""
    mcfg = dryrun.mesh_config_of("single")
    with dryrun.fake_world(mcfg.num_devices):
        mesh = dryrun.make_mesh("single", "meta")
        rec = dryrun.lower_cell(get_config(arch), SHAPES_BY_NAME[shape],
                                mcfg, mesh)
    return check_full_width(rec)


def check_full_width(rec: dict) -> dict:
    """A full-width record whole: bytes, a peak at least the state,
    flops, and every collective of the sharded step counted with its
    bytes."""
    assert rec["state_bytes_per_device"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["state_bytes"]
    assert rec["cost"]["flops"] > 0
    # both are the plain versions' work, and the record says so
    assert rec["memory"]["peak_of"] == dryrun.PLAIN_PEAK
    assert rec["cost"]["flops_of"] == dryrun.PLAIN_FLOPS
    assert rec["collectives"]
    assert all(v["count"] > 0 and v["bytes"] > 0
               for v in rec["collectives"].values())
    if rec["kind"] == "decode":
        assert rec["cache_bytes_per_device"] > 0
        assert rec["decode_pos"] == SHAPES_BY_NAME[rec["shape"]].seq_len - 1
    return rec


@pytest.fixture(scope="module", autouse=True)
def hybrid_prefill():
    """hymba-1.5b's full-width prefill, traced in a process of its own
    from the file's first test on."""
    proc = start_trace(FAMILIES["hybrid"], "prefill_32k")
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    """Keys, shapes, dtypes and logical axes of every input of the cell,
    the decode cache's included (one device, so the cache is whole)."""
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    cell = SHAPES_BY_NAME[shape]
    batch, specs = input_specs(cfg, cell, build_model(cfg, device="meta"))
    jbatch, jspecs = j_input_specs(jcfg, cell, j_build_model(jcfg))
    assert specs == jspecs
    jshapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jbatch)
    assert _shapes(batch) == jshapes
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        batch, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("shape,family", [
    (shape, family) for shape in ("prefill_32k", "decode_32k")
    for family in ("dense", "moe", "hybrid", "vlm", "audio")
    if (shape, family) != ("prefill_32k", "hybrid")])
def test_full_width_cells_trace(family, shape):
    """The family's prefill and decode on 16 x 16, traced on meta (the
    hybrid's prefill in ``test_full_width_hybrid_prefill_traces``)."""
    trace_full_width(FAMILIES[family], shape)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_train_cells_trace(family):
    """Every family's train cell at reduced width on (2, 2), traced on
    meta: the state is rank 0's parameter shards, two moments of their
    size and the int32 step, and the step's gradients are reduced over
    the data shards."""
    cfg = reduced(get_config(FAMILIES[family]))
    shape = SMALL_SHAPES["train"]
    args = (shape.global_batch, shape.seq_len, shape.kind)
    with dryrun.fake_world(SMALL_MESH.num_devices):
        mesh = dryrun.make_mesh_from_config(SMALL_MESH, "meta")
        rec = dryrun.lower_cell(cfg, shape, SMALL_MESH, mesh)
        prof = shd.sharding_profile(cfg, SMALL_MESH, *args)
        with shd.use_ctx(shd.ShardCtx(
                mesh, shd.make_rules(cfg, SMALL_MESH, *args), prof)):
            params = build_model(cfg, kv_repeat=prof.kv_repeat,
                                 device="meta").init(torch.Generator())
    shards = sum(p.numel() * p.element_size() for p in params.values())
    assert rec["state_bytes_per_device"] == 3 * shards + 4
    assert rec["profile"]["num_microbatches"] >= 1
    assert rec["collectives"]["grad_all_reduce"]["count"] > 0
    assert rec["cost"]["flops"] > 0


@pytest.mark.parametrize("family,kind", [
    ("dense", "train"), ("ssm", "train"), ("moe", "prefill"),
    ("audio", "prefill"), ("hybrid", "decode"), ("vlm", "decode")])
def test_cpu_realizes_what_meta_traces(family, kind):
    """The same reduced cell realized on the CPU (values from the seed)
    and traced on meta: the state and cache bytes, every collective's
    count and bytes, the flops and the peak are equal."""
    cfg = reduced(get_config(FAMILIES[family]))
    shape = SMALL_SHAPES[kind]
    recs = {}
    with dryrun.fake_world(SMALL_MESH.num_devices):
        for dev in ("meta", "cpu"):
            mesh = dryrun.make_mesh_from_config(SMALL_MESH, dev)
            recs[dev] = dryrun.lower_cell(cfg, shape, SMALL_MESH, mesh)
    meta, cpu = recs["meta"], recs["cpu"]
    assert cpu["device"] == "cpu" and meta["device"] == "meta"
    for key in ("state_bytes_per_device", "cache_bytes_per_device",
                "collectives", "cost", "memory", "profile"):
        assert cpu.get(key) == meta.get(key), key


def test_cli_writes_records_and_skipped(tmp_path, capsys):
    """One cell from the command line: its record and ``skipped.json``
    as JAX writes them."""
    dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                 "--mesh", "single", "--device", "meta",
                 "--out", str(tmp_path)])
    assert "dry-run complete: 1 ok, 0 failed" in capsys.readouterr().out
    rec = json.loads((tmp_path / "single__mamba2-780m__long_500k.json")
                     .read_text())
    assert rec["arch"] == "mamba2-780m" and rec["chips"] == 256
    assert rec["mesh"] == {"shape": [16, 16], "axes": ["data", "model"]}
    assert rec["total_s"] > 0 and rec["cache_bytes_per_device"] == 4_847_620
    skipped = json.loads((tmp_path / "skipped.json").read_text())
    assert skipped == [{"arch": a, "shape": s, "reason": r}
                       for a, s, r in skipped_cells()]
    assert len(skipped) == 8


def test_cli_records_a_failing_cell_and_exits_1(tmp_path, capsys):
    """Three micro-batches do not split mamba2-780m's 16 rows a data
    shard: the cell's record holds the error and its traceback, and the
    run exits 1, as JAX's does."""
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "mamba2-780m", "--shape", "train_4k",
                     "--mesh", "single", "--device", "meta", "--mu", "3",
                     "--out", str(tmp_path)])
    assert exc.value.code == 1
    assert "dry-run complete: 0 ok, 1 failed" in capsys.readouterr().out
    err = json.loads((tmp_path / "single__mamba2-780m__train_4k.json")
                     .read_text())
    assert "micro-batches" in err["error"]
    assert "Traceback" in err["traceback"] and "local_batch" in \
        err["traceback"]


def test_no_device_and_no_cuda_raises(tmp_path):
    """The default is the card; where CUDA is missing the entry point
    raises and writes nothing, never tracing on meta instead."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_dense_prefill_flops_are_its_products():
    """Reduced starcoder2-7b (2 layers, d 256, 4 heads and 1 KV head of
    64, SwiGLU d_ff 512, vocab 512) prefilling 4 x 64 on (2, 2), rank 0:
    2 rows, 2 query heads, the KV head repeated x2 and sliced to 1, d_ff
    and vocab halved. The flops are 2 m n k of each product, exactly, and
    ``FlopCounterMode`` counts the same."""
    cfg = reduced(get_config("starcoder2-7b"))
    shape = SMALL_SHAPES["prefill"]
    b, s, d, dh = 2, shape.seq_len, cfg.d_model, cfg.resolved_head_dim
    t = b * s
    hq, ff, vp = 2, cfg.d_ff // 2, cfg.vocab_size // 2
    layer = (2 * t * d * hq * dh              # q
             + 2 * 2 * t * d * dh             # k and v: the one KV head
             + 2 * 2 * b * hq * s * s * dh    # scores and readout
             + 2 * t * hq * dh * d            # o
             + 3 * 2 * t * d * ff)            # gate, up, down
    closed = cfg.num_layers * layer + 2 * b * d * vp   # the last token
    with dryrun.fake_world(SMALL_MESH.num_devices):
        mesh = dryrun.make_mesh_from_config(SMALL_MESH, "meta")
        rec = dryrun.lower_cell(cfg, shape, SMALL_MESH, mesh)
        cell = dryrun.build_cell(cfg, shape, SMALL_MESH, mesh)
        with FlopCounterMode(display=False) as counter:
            with shd.use_ctx(cell.ctx):
                cell.run()
    assert rec["profile"]["kv_repeat"] == 2
    assert rec["cost"]["flops"] == closed == 159_645_696
    assert counter.get_total_flops() == closed


def test_full_width_hybrid_prefill_traces(hybrid_prefill):
    """hymba-1.5b's prefill on 16 x 16, traced on meta (last in the file:
    its process has traced while the other tests ran): the attention is
    DP-only (25 heads), so no ``model`` reduce of its output."""
    rec = finish_trace(hybrid_prefill)
    assert rec["arch"] == "hymba-1.5b" and rec["kind"] == "prefill"
    assert not rec["profile"]["attn_tp"] and rec["profile"]["mlp_tp"]


def test_counting_wrappers_are_the_seven_and_zero_every_count():
    """One registry of the kernels' counting wrappers, K1 to K7, which the
    dry-run and ``chip_smoke.py`` share: ``zero_launches`` clears the
    count, the counts by design and the segment folds' counts by shard."""
    import chip_smoke as cs
    from repro_torch import kernels
    fns = kernels.counting_wrappers()
    assert list(fns) == [f"K{i}" for i in range(1, 8)]
    assert cs.all_wrappers() == fns
    saved = {k: (f.launches, dict(f.launches_by_design),
                 dict(getattr(f, "launches_by_shard", {})))
             for k, f in fns.items()}
    try:
        for f in fns.values():
            f.launches = 3
            for d in f.launches_by_design:
                f.launches_by_design[d] = 2
            if hasattr(f, "launches_by_shard"):
                f.launches_by_shard[0] = {"smem": 1}
        kernels.zero_launches(fns.values())
        for k, f in fns.items():
            assert f.launches == 0, k
            assert set(f.launches_by_design.values()) == {0}, k
            assert getattr(f, "launches_by_shard", {}) == {}, k
    finally:
        for k, f in fns.items():
            f.launches = saved[k][0]
            f.launches_by_design.update(saved[k][1])
            if hasattr(f, "launches_by_shard"):
                f.launches_by_shard.update(saved[k][2])


@pytest.mark.parametrize("budget,held", [
    (2 ** 40, ["whole"]),
    (2 * 128 * 128 * 4, ["row 0, q heads 0-1", "row 1, q heads 2-3"]),
    (128 * 128 * 4, ["row 0, q heads 0-0", "row 1, q heads 3-3"]),
])
def test_phase_29_replays_hold_and_their_controls_fail(monkeypatch, budget,
                                                       held):
    """Phase 29's ``dryrun_replays`` on CPU tensors (each wrapper then
    takes its plain version): a causal windowed K5 launch of 2 x 128
    tokens, 4 heads over 2 KV heads of 64, in bf16, its K6 launch and a
    K7 launch of 2 x 256 tokens pass, each control (keys and values
    swapped; the second half of the scan without the first half's
    state) is rejected, and a launch whose plain scores pass the budget
    is held on its first and last row's first and last head (K5 one,
    K6 a KV head's group; K6 refused where a group passes it)."""
    import chip_smoke as cs
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    g = torch.Generator().manual_seed(0)

    def bf16(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16)

    q, k, v, do = bf16(2, 128, 4, 64), bf16(2, 128, 2, 64), \
        bf16(2, 128, 2, 64), bf16(2, 128, 4, 64)
    kw = dict(causal=True, window=32, kv_valid_len=None)
    o, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      return_lse=True, **kw)
    kept = {"K5 a": dict(args=(q, k, v), kw=kw),
            "K6 a": dict(args=(q, k, v, o.to(torch.bfloat16), do, lse),
                         kw=kw),
            "K7 a": dict(xdt=torch.randn(2, 256, 3, 64, generator=g),
                         a=-torch.rand(2, 256, 3, generator=g),
                         B=torch.randn(2, 256, 16, generator=g),
                         C=torch.randn(2, 256, 16, generator=g), chunk=64,
                         init_state=None, design=None)}
    monkeypatch.setattr(cs, "REPLAY_SCORE_BYTES", budget)
    if held[0].endswith("0-0"):
        with pytest.raises(cs.SmokeFailure, match="beyond"):
            cs.dryrun_replays({"K6 a": kept.pop("K6 a")})
    out = cs.dryrun_replays(kept)
    assert out["K5 a"]["held_on"] == held
    assert out["K5 a"]["control_ratio"] >= cs.flash_limits().CONTROL_FACTOR
    if "K6 a" in out:
        assert out["K6 a"]["held_on"] == held
        assert out["K6 a"]["control_ratio"] >= \
            cs.flash_limits().CONTROL_FACTOR
    assert out["K7 a"]["max_abs_err"] == 0.0
