"""Slot sharding on the port: ``tests/test_slot_sharding.py``'s cases, held
against the JAX package on the same seeded numpy inputs.

The port's mesh may name a device more than once, so the sharded paths
run here on 2-, 4- and 8-entry meshes of the one CPU (the JAX package
reaches them with ``--xla_force_host_platform_device_count=8``, which
the subprocess case at the end uses to hold the port's 8-entry mesh to
JAX's own sharded folds). In this process JAX has one device, so the
in-process references are its unsharded ``ref`` and dense folds and its
unsharded engine.

Tolerances: ``count``, ``min`` and ``max`` exact; ``sum`` within rtol
1e-5 and atol 1e-6; engine results within rtol 1e-4 and atol 1e-5, as
the JAX test's.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batch_exec as jbx
import repro.kernels.ref as jref
from repro.configs.base import AionConfig as JAionConfig
from repro.core import StreamEngine as JStreamEngine
from repro.core import TumblingWindows as JTumbling
from repro.core.events import EventBatch as JEventBatch
from repro.core.operators import make_operator as jmake_operator
from repro.core.triggers import DeltaTTrigger as JDelta
from repro.distributed.sharding import shard_of_window as jshard_of_window

import repro_torch.core.batch_exec as tbx
from repro_torch.configs.base import AionConfig
from repro_torch.core import StreamEngine, TumblingWindows
from repro_torch.core.events import EventBatch
from repro_torch.core.operators import make_operator
from repro_torch.core.triggers import DeltaTTrigger
from repro_torch.core.windows import WindowId
from repro_torch.distributed.sharding import (
    SlotMesh, make_slot_mesh, shard_of_window,
)
from repro_torch.kernels import segment_aggregate_batched
from repro_torch.kernels import ops
from repro_torch.kernels.segment_aggregate import (
    next_pow2, pack_rows_shard_major, segment_aggregate_batched_sharded,
    segment_aggregate_batched_splitk_sharded,
    segment_aggregate_block_table_sharded,
)

import test_torch_engine as E

# the module, not the entry point the package re-exports under its name
jsa = importlib.import_module("repro.kernels.segment_aggregate")

CPU = torch.device("cpu")
WINDOW = 10.0
N_WINDOWS = 12
MESH_SIZES = [2, 4, 8]
STATS = ("sum", "count", "min", "max")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int) -> SlotMesh:
    return make_slot_mesh(devices=["cpu"] * n)


def _hold(got: dict, want: dict, tag: str = "") -> None:
    """count, min and max exact (inf where the reference has inf); sum
    within rtol 1e-5 and atol 1e-6."""
    assert set(got) == set(want), tag
    for k in want:
        a = np.asarray(got[k].numpy() if isinstance(got[k], torch.Tensor)
                       else got[k], np.float64)
        b = np.asarray(want[k], np.float64)
        assert a.shape == b.shape, (tag, k)
        if k == "sum":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{tag} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} {k}")


# ------------------------------------------------------------- placement
def test_plan_slot_placement_round_robins_device_ranges():
    slot_of, num_slots, slots_per = tbx.plan_slot_placement(10, 4)
    assert slots_per == 4 and num_slots == 16
    assert slot_of == [0, 4, 8, 12, 1, 5, 9, 13, 2, 6]
    for i, s in enumerate(slot_of):
        d = i % 4
        assert d * slots_per <= s < (d + 1) * slots_per
    assert len(set(slot_of)) == len(slot_of)


def test_plan_slot_placement_single_device_identity():
    slot_of, num_slots, slots_per = tbx.plan_slot_placement(5, 1)
    assert slot_of == [0, 1, 2, 3, 4]
    assert num_slots == slots_per == 8


@pytest.mark.parametrize("num_devices", range(1, 9))
def test_placements_equal_jax(num_devices):
    """``plan_slot_placement``, ``plan_slot_placement_pooled`` and
    ``pack_rows_shard_major`` (ownership and balanced) equal the JAX
    package's on a grid of window counts."""
    rng = np.random.default_rng(num_devices)
    for n in range(0, 40):
        assert tbx.plan_slot_placement(n, num_devices) == \
            jbx.plan_slot_placement(n, num_devices)
        starts = np.sort(rng.choice(500, n, replace=False)) * WINDOW
        twids = [WindowId(float(s), float(s) + WINDOW) for s in starts]
        jwids = [jbx.WindowId(float(s), float(s) + WINDOW) for s in starts]
        assert tbx.plan_slot_placement_pooled(twids, num_devices) == \
            jbx.plan_slot_placement_pooled(jwids, num_devices)
        slots_per = int(rng.integers(1, 5))
        slots = rng.integers(0, num_devices * slots_per, n)
        for balance in (False, True):
            got, rows = pack_rows_shard_major(slots, num_devices, slots_per,
                                              balance=balance)
            want, jrows = jsa.pack_rows_shard_major(
                slots, num_devices, slots_per, balance=balance)
            assert rows == jrows
            assert [list(p) for p in got] == [list(p) for p in want]


def test_shard_of_window_equals_jax():
    rng = np.random.default_rng(0)
    starts = rng.uniform(-1e6, 1e6, 1000)
    spans = rng.choice([1.0, 10.0, 30.0, 60.0, 0.25], 1000)
    for n in range(1, 9):
        for s, w in zip(starts, spans):
            assert shard_of_window(s, s + w, n) == \
                jshard_of_window(s, s + w, n)


def test_pack_rows_shard_major_groups_and_pads():
    slots = np.array([0, 3, 0, 7, 2, 3])        # slots_per=2, 4 devices
    per, rows = pack_rows_shard_major(slots, 4, 2)
    assert [list(p) for p in per] == [[0, 2], [1, 4, 5], [], [3]]
    assert rows == 4
    per, rows = pack_rows_shard_major(np.array([0, 0, 0]), 2, 2)
    assert rows == 4
    per, rows = pack_rows_shard_major(np.arange(5), 2, 1, balance=True)
    assert [list(p) for p in per] == [[0, 2, 4], [1, 3]] and rows == 4


def test_make_slot_mesh_single_device_is_none():
    assert make_slot_mesh(1) is None
    if not torch.cuda.is_available():
        assert make_slot_mesh(0) is None          # the one CPU
    assert make_slot_mesh(1, devices=["cpu"] * 4) is None
    mesh = make_slot_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_name == "slots"
    assert make_slot_mesh(2, devices=["cpu"] * 4).size == 2
    assert hash(mesh) == hash(cpu_mesh(4)) and mesh == cpu_mesh(4)


def test_next_pow2():
    assert [next_pow2(i) for i in (0, 1, 2, 3, 5, 8, 9)] == \
        [1, 1, 2, 4, 8, 8, 16]


# ------------------------------------------------------------ empty batch
def test_batch_executor_empty_items_is_noop():
    eng = _make_engine("average", batched=True, sharded=True)
    before = (eng.metrics.batch_executions, eng.metrics.live_executions,
              eng.metrics.late_executions, eng.metrics.exec_seconds)
    assert eng.batch_exec.execute([], now=0.0) == {}
    after = (eng.metrics.batch_executions, eng.metrics.live_executions,
             eng.metrics.late_executions, eng.metrics.exec_seconds)
    assert before == after
    eng.close()


@pytest.mark.parametrize("mesh_size", [0, 4])
def test_batched_kernel_empty_batch_is_identity(mesh_size):
    mesh = cpu_mesh(mesh_size) if mesh_size else None
    out = segment_aggregate_batched(
        torch.zeros((0, 16, 2)), torch.zeros((0, 16), dtype=torch.int32),
        4, mesh=mesh)
    assert out["sum"].shape == (0, 4, 2) and out["count"].shape == (0, 4)
    out = segment_aggregate_batched(
        torch.zeros((0, 16, 2)), torch.zeros((0, 16), dtype=torch.int32),
        4, slot_ids=torch.zeros((0,), dtype=torch.int32), num_slots=8,
        mesh=mesh)
    assert out["sum"].shape == (8, 4, 2)
    assert float(out["sum"].sum()) == 0.0 and float(out["count"].sum()) == 0
    assert bool(torch.all(out["min"] == float("inf")))
    assert bool(torch.all(out["max"] == float("-inf")))


def test_ref_batched_empty_batch_is_identity():
    out = ops.segment_aggregate_batched(
        torch.zeros((0, 8, 1)), torch.zeros((0, 8), dtype=torch.int32), 3,
        slot_ids=torch.zeros((0,), dtype=torch.int32), num_slots=4,
        backend="ref", mesh=cpu_mesh(2))
    assert out["sum"].shape == (4, 3, 1)
    assert float(out["count"].sum()) == 0.0


# ----------------------------------------------------------- engine parity
def _make_engine(op_name, batched, sharded, block=64, width=2, num_keys=8,
                 pkg="torch", mesh_size=4, **aion_kw):
    """``test_slot_sharding._make_engine`` for either package: the port's
    sharded engines run on a ``mesh_size``-entry mesh of the CPU."""
    kw = {"num_keys": num_keys} if op_name == "stock" else \
        {"num_segments": num_keys} if op_name == "lrb" else {}
    if pkg == "jax":
        return JStreamEngine(
            assigner=JTumbling(WINDOW),
            operator=jmake_operator(op_name, block, width, **kw),
            aion=JAionConfig(block_size=block, batched_execution=batched,
                             slot_sharding=sharded, **aion_kw),
            value_width=width, device_budget_bytes=64 << 20,
            trigger=JDelta(executions=2))
    return StreamEngine(
        assigner=TumblingWindows(WINDOW),
        operator=make_operator(op_name, block, width, device="cpu", **kw),
        aion=AionConfig(block_size=block, batched_execution=batched,
                        slot_sharding=sharded, **aion_kw),
        value_width=width, device_budget_bytes=64 << 20,
        trigger=DeltaTTrigger(executions=2), device="cpu",
        slot_devices=["cpu"] * mesh_size if sharded else None)


def _late_heavy_run(eng, seed: int = 7, pkg="torch"):
    batch = JEventBatch if pkg == "jax" else EventBatch
    rng = np.random.default_rng(seed)
    horizon = N_WINDOWS * WINDOW
    n = 3600
    eng.ingest(batch(rng.integers(0, 8, n), rng.uniform(0, horizon, n),
                     rng.normal(size=(n, 2)).astype(np.float32)), now=0.0)
    eng.advance_watermark(horizon, now=horizon)
    if pkg == "jax":
        # the JAX side steps with its I/O thread idle: its ingest loses
        # events appended while that thread stages the same block
        # (ROADMAP Queue 3, item 18)
        assert eng.io.drain()
    nl = 1000
    eng.ingest(batch(rng.integers(0, 8, nl),
                     rng.uniform(0, horizon - WINDOW, nl),
                     rng.normal(size=(nl, 2)).astype(np.float32)),
               now=horizon + 1.0)
    for t in np.linspace(horizon + 1,
                         horizon + 1 + 2 * eng.cleanup.current_bound(), 25):
        eng.poll(t)
    results = {(w.start, w.end): r for w, r in eng.results.items()}
    metrics = eng.metrics
    eng.close()
    return results, metrics


def _assert_equal_results(got, want, tag):
    assert set(got) == set(want)
    for wid in want:
        g, w = got[wid], want[wid]
        if isinstance(w, dict):
            for k in w:
                np.testing.assert_allclose(
                    np.asarray(g[k], np.float64),
                    np.asarray(w[k], np.float64), rtol=1e-4, atol=1e-5,
                    err_msg=f"{tag} {wid} field {k!r}")
        else:
            assert g == pytest.approx(w, rel=1e-4, abs=1e-5), f"{tag} {wid}"


@pytest.mark.parametrize("op_name", ["average", "stock", "lrb"])
def test_sharded_matches_unsharded_and_reference(op_name):
    got_s, m_s = _late_heavy_run(_make_engine(op_name, True, True))
    got_u, m_u = _late_heavy_run(_make_engine(op_name, True, False))
    want, m_r = _late_heavy_run(_make_engine(op_name, False, False))
    jax_b, jm = _late_heavy_run(_make_engine(op_name, True, False,
                                             pkg="jax"), pkg="jax")
    _assert_equal_results(got_s, got_u, f"{op_name} sharded-vs-unsharded")
    _assert_equal_results(got_s, want, f"{op_name} sharded-vs-reference")
    _assert_equal_results(got_s, jax_b, f"{op_name} sharded-vs-jax")
    assert m_s.sharded_batch_executions >= 1
    assert m_s.batch_executions == m_u.batch_executions \
        == jm.batch_executions
    assert m_u.sharded_batch_executions == 0
    assert m_r.batch_executions == 0
    assert m_s.live_executions == m_u.live_executions \
        == m_r.live_executions == N_WINDOWS


def test_slot_sharding_is_safe_noop_on_single_device():
    """slot_sharding=True clamped to one entry (``slot_shard_devices=1``,
    or an engine on the CPU given no slot devices) builds no mesh and
    folds unsharded, with the same results."""
    eng = _make_engine("average", True, True, slot_shard_devices=1)
    assert eng.slot_mesh is None and eng.pool.num_shards == 1
    got, m = _late_heavy_run(eng)
    want, _ = _late_heavy_run(_make_engine("average", True, False))
    assert m.sharded_batch_executions == 0
    assert m.batch_executions >= 1
    _assert_equal_results(got, want, "single-device noop")
    eng = StreamEngine(
        assigner=TumblingWindows(WINDOW),
        operator=make_operator("average", 64, 2, device="cpu"),
        aion=AionConfig(block_size=64, slot_sharding=True), value_width=2,
        device="cpu")
    assert eng.slot_mesh is None
    eng.close()


def test_sharded_more_windows_than_slots_per_device():
    """More due windows than mesh entries: several windows share each
    device's slot range and the padded layout still folds correctly."""
    eng = _make_engine("average", True, True, mesh_size=8)
    rng = np.random.default_rng(3)
    n_win = 2 * 8 + 3
    horizon = n_win * WINDOW
    n = 4000
    b = EventBatch(rng.integers(0, 8, n), rng.uniform(0, horizon, n),
                   rng.normal(size=(n, 2)).astype(np.float32))
    eng.ingest(b, now=0.0)
    eng.advance_watermark(horizon, now=horizon)
    assert eng.metrics.batch_executions == 1
    assert eng.metrics.sharded_batch_executions == 1
    assert eng.metrics.live_executions == n_win
    ts = b.timestamps
    for i in range(n_win):
        sel = (ts >= i * WINDOW) & (ts < (i + 1) * WINDOW)
        if not sel.any():
            continue
        want = float(np.mean(b.values[sel, 0]))
        assert eng.results[WindowId(i * WINDOW, (i + 1) * WINDOW)] == \
            pytest.approx(want, rel=1e-4, abs=1e-5)
    eng.close()


@pytest.mark.parametrize("sharded", [False, True])
def test_device_stacking_matches_host_stacking(sharded):
    results = {}
    for device_stacking in (True, False):
        eng = _make_engine("stock", True, sharded,
                           device_stacking=device_stacking)
        got, m = _late_heavy_run(eng, seed=13)
        assert m.batch_executions >= 1
        assert (m.sharded_batch_executions > 0) == sharded
        results[device_stacking] = got
    _assert_equal_results(results[True], results[False],
                          f"device-vs-host stack (sharded={sharded})")


@pytest.mark.parametrize("pooled,splitk", [(False, 2), (True, 2),
                                           (True, 0)])
def test_sharded_splitk_layouts_match_jax(pooled, splitk):
    """Split-K under sharding: the stacked fold deals rows round-robin
    (the row-balanced K1 fold), the pooled one chunks per shard (K3 on
    each shard); both equal the JAX package's unsharded run."""
    kw = dict(block_pool=pooled, splitk_chunk_rows=splitk, block=16)
    got, m = _late_heavy_run(_make_engine("stock", True, True, **kw))
    want, _ = _late_heavy_run(_make_engine("stock", True, False, pkg="jax",
                                           **kw), pkg="jax")
    _assert_equal_results(got, want, f"splitk pooled={pooled}")
    assert m.sharded_batch_executions > 0
    assert (m.splitk_launches > 0) == bool(splitk)


def test_jax_checkpoint_restores_into_a_sharded_engine(tmp_path):
    """A manifest checkpoint of the (unsharded) JAX engine restores
    through ``engine_state_from_jax`` into a port engine sharded over a
    4-entry mesh, which finishes the stream with the JAX results."""
    import shutil
    from repro_torch.convert import engine_state_from_jax
    half = len(E.STEPS) // 2
    eng = E._engine("jax", tmp_path / "a")
    E._feed("jax", eng, E.STEPS[:half])
    snap = eng.checkpoint_state(include_stored_data=False)
    eng.close()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    jeng = E._engine("jax", tmp_path / "a")
    jeng.restore_state(snap)
    E._feed("jax", jeng, E.STEPS[half:])
    want, _ = E._close_out("jax", jeng)
    teng = _sharded_port_engine(tmp_path / "b")
    assert teng.pool.num_shards == 4
    teng.restore_state(engine_state_from_jax(snap))
    E._feed("torch", teng, E.STEPS[half:])
    sharded = teng.metrics
    got, counts = E._close_out("torch", teng)
    E._agree(got, want)
    E._agree(got, E._oracle(), alerts=False)
    assert sharded.sharded_batch_executions > 0
    assert counts["pooled_rows"] > 0


def _sharded_port_engine(spill_dir):
    """``test_torch_engine._engine("torch", ...)`` with slot sharding on
    a 4-entry mesh of the CPU."""
    from repro_torch.core.cleanup import PredictiveCleanup

    class NoPurge(PredictiveCleanup):
        def should_purge(self, window_end, watermark):
            return False

    aion = AionConfig(block_size=E.CAP, pool_slots=12,
                      store_segment_bytes=32 << 10, slot_sharding=True)
    return StreamEngine(
        assigner=TumblingWindows(E.WINDOW),
        operator=make_operator("stock", E.CAP, E.WIDTH, num_keys=E.KEYS,
                               device="cpu"),
        aion=aion, value_width=E.WIDTH,
        cleanup=NoPurge(initial_bound=60.0, min_history=1 << 62),
        trigger=DeltaTTrigger(executions=2),
        device_budget_bytes=1 << 16, host_budget_bytes=1 << 14,
        spill_dir=spill_dir, device="cpu", slot_devices=["cpu"] * 4)


# -------------------------------------------------------- kernel layout
def _batched_case(num_devices, seed=None, slots_per=2, rows_per=4, n=48,
                  w=2, s=5):
    rng = np.random.default_rng(num_devices if seed is None else seed)
    num_slots = num_devices * slots_per
    b = num_devices * rows_per
    slots = np.concatenate([
        rng.integers(d * slots_per, (d + 1) * slots_per, rows_per)
        for d in range(num_devices)]).astype(np.int32)
    vals = rng.normal(size=(b, n, w)).astype(np.float32)
    ids = rng.integers(0, s, (b, n)).astype(np.int32)
    fills = rng.integers(0, n + 1, b)            # includes all-invalid rows
    valid = np.arange(n)[None, :] < fills[:, None]
    return vals, ids, valid, slots, num_slots, s


def _jax_np(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("num_devices", MESH_SIZES)
def test_sharded_kernel_parity_all_backends(num_devices):
    vals, ids, valid, slots, num_slots, s = _batched_case(num_devices)
    kw = dict(valid=valid, slot_ids=slots, num_slots=num_slots)
    tkw = {k: torch.from_numpy(np.asarray(v)) if k != "num_slots" else v
           for k, v in kw.items()}
    mesh = cpu_mesh(num_devices)
    out_s = segment_aggregate_batched(torch.from_numpy(vals),
                                      torch.from_numpy(ids), s, mesh=mesh,
                                      **tkw)
    out_u = segment_aggregate_batched(torch.from_numpy(vals),
                                      torch.from_numpy(ids), s, **tkw)
    jkw = {k: jnp.asarray(v) if k != "num_slots" else v
           for k, v in kw.items()}
    ref = _jax_np(jref.ref_segment_aggregate_batched(
        jnp.asarray(vals), jnp.asarray(ids), s, **jkw))
    dense = _jax_np(jsa.segment_aggregate_batched_dense(
        jnp.asarray(vals), jnp.asarray(ids), s, **jkw))
    _hold(out_s, _jax_np({k: out_u[k].numpy() for k in STATS}),
          "vs unsharded")
    _hold(out_s, ref, "vs JAX ref")
    _hold(out_s, dense, "vs JAX dense")


def _table_case(num_devices, seed=0, pool_per=6, cap=24, w=3, s=4,
                slots_per=2, rows_per=5):
    rng = np.random.default_rng(seed + num_devices)
    p = num_devices * pool_per
    arena = rng.normal(size=(p, cap, w)).astype(np.float32)
    r = num_devices * rows_per
    table = np.concatenate([
        rng.integers(d * pool_per, (d + 1) * pool_per, rows_per)
        for d in range(num_devices)]).astype(np.int32)
    slots = np.concatenate([
        rng.integers(d * slots_per, (d + 1) * slots_per, rows_per)
        for d in range(num_devices)]).astype(np.int32)
    ids = rng.integers(0, s, (r, cap)).astype(np.int32)
    fills = rng.integers(0, cap + 1, r)
    valid = np.arange(cap)[None, :] < fills[:, None]
    return arena, ids, table, valid, slots, num_devices * slots_per, s


@pytest.mark.parametrize("chunk_rows", [0, 1, 3])
@pytest.mark.parametrize("num_devices", MESH_SIZES)
def test_block_table_sharded_parity(num_devices, chunk_rows):
    """K2 (K3 where chunk_rows > 0) on every shard's arena tile against
    the JAX package's unsharded ref and dense block-table folds, whole
    and with the first value column only."""
    arena, ids, table, valid, slots, ns, s = _table_case(num_devices)
    mesh = cpu_mesh(num_devices)
    for num_cols in (None, 1):
        got = segment_aggregate_block_table_sharded(
            torch.from_numpy(arena), torch.from_numpy(ids),
            torch.from_numpy(table), s, valid=torch.from_numpy(valid),
            slot_ids=torch.from_numpy(slots), num_slots=ns, mesh=mesh,
            num_cols=num_cols, chunk_rows=chunk_rows)
        jargs = (jnp.asarray(arena), jnp.asarray(ids), jnp.asarray(table), s)
        jkw = dict(valid=jnp.asarray(valid), slot_ids=jnp.asarray(slots),
                   num_slots=ns, num_cols=num_cols)
        _hold(got, _jax_np(jref.ref_segment_aggregate_block_table(
            *jargs, **jkw)), f"ref cols={num_cols}")
        if chunk_rows:
            dense = jsa.segment_aggregate_block_table_splitk_dense(
                *jargs, chunk_rows, **jkw)
        else:
            dense = jsa.segment_aggregate_block_table_dense(*jargs, **jkw)
        _hold(got, _jax_np(dense), f"dense cols={num_cols}")
        # the ops entry point routes the mesh; 'ref' ignores it
        fn = ops.segment_aggregate_block_table_splitk if chunk_rows \
            else ops.segment_aggregate_block_table
        extra = (chunk_rows,) if chunk_rows else ()
        for backend in ("auto", "ref"):
            out = fn(torch.from_numpy(arena), torch.from_numpy(ids),
                     torch.from_numpy(table), s, *extra,
                     valid=torch.from_numpy(valid),
                     slot_ids=torch.from_numpy(slots), num_slots=ns,
                     backend=backend, mesh=mesh, num_cols=num_cols)
            _hold(out, {k: v.numpy() for k, v in got.items()}, backend)


@pytest.mark.parametrize("num_devices", MESH_SIZES)
def test_splitk_sharded_balanced_parity(num_devices):
    """The row-balanced fold: rows dealt round-robin with no ownership
    precondition, slots that need not divide the mesh, D full partials
    merged — equal to the JAX package's unsharded fold."""
    rng = np.random.default_rng(40 + num_devices)
    b, n, w, s, ns = 3 * num_devices, 32, 2, 5, 3
    vals = rng.normal(size=(b, n, w)).astype(np.float32)
    ids = rng.integers(0, s, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) < 0.8
    slots = rng.integers(0, ns, b).astype(np.int32)
    got = ops.segment_aggregate_batched(
        torch.from_numpy(vals), torch.from_numpy(ids), s,
        valid=torch.from_numpy(valid), slot_ids=torch.from_numpy(slots),
        num_slots=ns, mesh=cpu_mesh(num_devices), splitk=4)
    want = _jax_np(jref.ref_segment_aggregate_batched(
        jnp.asarray(vals), jnp.asarray(ids), s, valid=jnp.asarray(valid),
        slot_ids=jnp.asarray(slots), num_slots=ns))
    _hold(got, want, "balanced vs JAX ref")


def test_sharded_kernel_rejects_indivisible_layout():
    mesh = cpu_mesh(2)
    with pytest.raises(ValueError, match="divide"):
        segment_aggregate_batched_sharded(
            torch.zeros((3, 8, 1)), torch.zeros((3, 8), dtype=torch.int32),
            2, slot_ids=torch.zeros((3,), dtype=torch.int32), num_slots=4,
            mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        segment_aggregate_batched_sharded(
            torch.zeros((4, 8, 1)), torch.zeros((4, 8), dtype=torch.int32),
            2, slot_ids=torch.zeros((4,), dtype=torch.int32), num_slots=3,
            mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        segment_aggregate_batched_splitk_sharded(
            torch.zeros((3, 8, 1)), torch.zeros((3, 8), dtype=torch.int32),
            2, slot_ids=torch.zeros((3,), dtype=torch.int32), num_slots=3,
            mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        segment_aggregate_block_table_sharded(
            torch.zeros((4, 8, 1)), torch.zeros((3, 8), dtype=torch.int32),
            torch.zeros((3,), dtype=torch.int32), 2,
            slot_ids=torch.zeros((3,), dtype=torch.int32), num_slots=4,
            mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        segment_aggregate_block_table_sharded(
            torch.zeros((5, 8, 1)), torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros((2,), dtype=torch.int32), 2,
            slot_ids=torch.zeros((2,), dtype=torch.int32), num_slots=2,
            mesh=mesh)
    with pytest.raises(ValueError, match="tiles"):      # 3 tiles for 2
        segment_aggregate_block_table_sharded(
            (torch.zeros((2, 8, 1)),) * 3,
            torch.zeros((2, 8), dtype=torch.int32),
            torch.zeros((2,), dtype=torch.int32), 2,
            slot_ids=torch.zeros((2,), dtype=torch.int32), num_slots=2,
            mesh=mesh)


def test_sharded_kernel_masks_misplaced_rows():
    """A row whose slot (or pool slot) lives on another shard contributes
    nothing rather than corrupting a resident slot."""
    mesh = cpu_mesh(2)
    vals = torch.ones((2, 8, 1))
    ids = torch.zeros((2, 8), dtype=torch.int32)
    slots = torch.tensor([1, 1], dtype=torch.int32)
    out = segment_aggregate_batched_sharded(vals, ids, 1, slot_ids=slots,
                                            num_slots=2, mesh=mesh)
    assert float(out["count"][0, 0]) == 0.0
    assert float(out["count"][1, 0]) == 8.0
    assert float(out["sum"][1, 0, 0]) == 8.0
    # block table: row 0 names pool slot 3 (shard 1's tile) on shard 0,
    # row 1 is well placed (pool slot 2, window slot 1)
    arena = torch.ones((4, 8, 1))
    out = segment_aggregate_block_table_sharded(
        arena, ids, torch.tensor([3, 2], dtype=torch.int32), 1,
        slot_ids=torch.tensor([0, 1], dtype=torch.int32), num_slots=2,
        mesh=mesh)
    assert out["count"].flatten().tolist() == [0.0, 8.0]


def test_fold_batch_takes_the_mesh():
    """Every operator's ``fold_batch(mesh=)`` equals its unsharded fold on
    shard-major rows, stacked and through the table; the bigram scatter
    shards, and falls back unsharded where rows do not divide the mesh."""
    rng = np.random.default_rng(5)
    mesh = cpu_mesh(4)
    cap, w, b, ns = 16, 3, 8, 8
    keys = torch.from_numpy(rng.integers(0, 50, (b, cap)).astype(np.int32))
    values = torch.from_numpy(rng.uniform(0, 9, (b, cap, w))
                              .astype(np.float32))
    fills = torch.from_numpy(rng.integers(0, cap + 1, b).astype(np.int32))
    slots = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7], dtype=torch.int32)
    table = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7], dtype=torch.int32)
    data = {"keys": keys, "values": values}
    for name, kw in (("average", {}), ("stock", {"num_keys": 8}),
                     ("lrb", {"num_segments": 8}), ("percentile", {}),
                     ("bigrams", {"vocab": 4}), ("bigrams", {"vocab": 40})):
        op = make_operator(name, cap, w, device="cpu", **kw)
        for tbl in (None, table):
            want = op.run_batch(data, fills, slots, ns, table=tbl)
            got = op.run_batch(data, fills, slots, ns, table=tbl, mesh=mesh)
            for g, x in zip(got, want):
                if isinstance(x, dict):
                    for k in x:
                        np.testing.assert_allclose(
                            np.asarray(g[k], np.float64),
                            np.asarray(x[k], np.float64), rtol=1e-5,
                            atol=1e-6, err_msg=f"{name} {k}")
                else:
                    np.testing.assert_allclose(np.asarray(g, np.float64),
                                               np.asarray(x, np.float64),
                                               rtol=1e-5, atol=1e-6)
    op = make_operator("bigrams", cap, w, vocab=40, device="cpu")
    want = op.run_batch(data, fills[:6], slots[:6], ns, table=table[:6])
    got = op.run_batch({k: v[:6] for k, v in data.items()}, fills[:6],
                       slots[:6], ns, mesh=mesh)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


# --------------------------------------- JAX's sharded folds, 8 devices
_JAX_SHARDED = r"""
import importlib, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.distributed.sharding import make_slot_mesh
sa = importlib.import_module("repro.kernels.segment_aggregate")
args = np.load(sys.argv[1])
mesh = make_slot_mesh(8)
assert mesh is not None and mesh.size == 8, jax.devices()
out = {}
def put(tag, res):
    for k, v in res.items():
        out[f"{tag}/{k}"] = np.asarray(v)
put("batched", sa.segment_aggregate_batched_sharded(
    jnp.asarray(args["vals"]), jnp.asarray(args["ids"]), 5,
    valid=jnp.asarray(args["valid"]), slot_ids=jnp.asarray(args["slots"]),
    num_slots=int(args["num_slots"]), mesh=mesh))
put("splitk", sa.segment_aggregate_batched_splitk_sharded(
    jnp.asarray(args["vals"]), jnp.asarray(args["ids"]), 5,
    valid=jnp.asarray(args["valid"]), slot_ids=jnp.asarray(args["bslots"]),
    num_slots=3, mesh=mesh))
for chunk in (0, 2):
    put(f"table{chunk}", sa.segment_aggregate_block_table_sharded(
        jnp.asarray(args["arena"]), jnp.asarray(args["tids"]),
        jnp.asarray(args["table"]), 4, valid=jnp.asarray(args["tvalid"]),
        slot_ids=jnp.asarray(args["tslots"]),
        num_slots=int(args["tnum_slots"]), mesh=mesh, num_cols=2,
        chunk_rows=chunk))
np.savez(sys.argv[2], **out)
print("ok", len(jax.devices()))
"""


def test_port_mesh_matches_jax_sharded_folds_on_8_devices(tmp_path):
    """JAX's own sharded folds, run in a process with eight forced host
    devices, against the port's 8-entry mesh on the same inputs (the
    misplaced rows of the inputs included)."""
    vals, ids, valid, slots, num_slots, _ = _batched_case(8, seed=21)
    slots[3] = slots[-1]                         # one misplaced row
    bslots = np.random.default_rng(2).integers(0, 3, len(slots))
    arena, tids, table, tvalid, tslots, tns, _ = _table_case(8, seed=9)
    table[0] = table[-1]                         # a misplaced pool slot
    np.savez(tmp_path / "in.npz", vals=vals, ids=ids, valid=valid,
             slots=slots, num_slots=num_slots, bslots=bslots, arena=arena,
             tids=tids, table=table, tvalid=tvalid, tslots=tslots,
             tnum_slots=tns)
    script = tmp_path / "jax_sharded.py"
    script.write_text(_JAX_SHARDED)
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["ok", "8"]
    want = np.load(tmp_path / "out.npz")

    def jax_out(tag):
        return {k.split("/")[1]: want[k] for k in want.files
                if k.startswith(tag + "/")}

    mesh = cpu_mesh(8)
    t = torch.from_numpy
    _hold(segment_aggregate_batched_sharded(
        t(vals), t(ids), 5, valid=t(valid), slot_ids=t(slots),
        num_slots=num_slots, mesh=mesh), jax_out("batched"), "batched")
    _hold(segment_aggregate_batched_splitk_sharded(
        t(vals), t(ids), 5, valid=t(valid), slot_ids=t(bslots),
        num_slots=3, mesh=mesh), jax_out("splitk"), "splitk")
    for chunk in (0, 2):
        _hold(segment_aggregate_block_table_sharded(
            t(arena), t(tids), t(table), 4, valid=t(tvalid),
            slot_ids=t(tslots), num_slots=tns, mesh=mesh, num_cols=2,
            chunk_rows=chunk), jax_out(f"table{chunk}"), f"table{chunk}")
    assert json.dumps(sorted(jax_out("batched"))) == json.dumps(
        sorted(STATS))


# ------------------------------------------------------------ tenancy
@pytest.mark.parametrize("pipelined", [False, True])
def test_multi_tenant_engine_shards_over_slot_devices(pipelined, tmp_path):
    """``MultiTenantEngine(slot_devices=)``: the shared arena splits into
    one tile a mesh entry, every tenant engine folds over the mesh, and
    each tenant's results equal the JAX ``MultiTenantEngine``'s
    (unsharded) on the same streams."""
    import test_torch_tenancy as T
    got = {}
    for pkg in ("torch", "jax"):
        cfg = T.PKGS[pkg][0]
        aion = cfg.AionConfig(block_size=64, pipelined_execution=pipelined,
                              slot_sharding=pkg == "torch")
        kw = {"slot_devices": ["cpu"] * 4} if pkg == "torch" else {}
        mt = T._mt(pkg, aion, T._specs(aion, pkg),
                   device_budget_bytes=256 << 20,
                   spill_dir=tmp_path / pkg, **kw)
        if pkg == "torch":
            assert mt.pool.num_shards == 4
            assert all(e.slot_mesh.size == 4 for e in mt.engines.values())
        ends = {n: T._drive_one(mt.engine(n), T.SEEDS[n], T.WIDTHS[n],
                                pkg=pkg) for n in mt.engines}
        got[pkg] = {n: T._final_results(mt.engine(n), ends[n], pkg)
                    for n in mt.engines}
        if pkg == "torch":
            assert all(e.metrics.sharded_batch_executions > 0
                       for e in mt.engines.values())
            assert sum(e.metrics.pooled_rows
                       for e in mt.engines.values()) > 0
            if pipelined:
                assert mt.pipeline.stats["rounds"] > 0
        assert mt.executor.stats["errors"] == 0
        mt.close()
    for name in T.WIDTHS:
        T._close(got["torch"][name], got["jax"][name])


# ------------------------------------------------- chip_smoke's phase 27
def test_chip_smoke_phase_27_rehearsal(tmp_path):
    """Phase 27 at a small rate, width and pool, with chunks of 4 rows:
    every sub-phase meets its oracle, folds sharded, folds live rows on
    every shard of the kernels it names, and replays its largest sharded
    call against the plain unsharded fold."""
    import chip_smoke as cs
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    small = {"27b": dict(pool_slots=256, splitk=4),
             "27e": dict(pool_slots=256, splitk=4,
                         aion_kw={"block_pool": False})}
    runs = tuple((p, t, s, small.get(p, kw), need)
                 for p, t, s, kw, need in cs.SHARDED_RUNS)
    out = cs.sharded_phases(
        CPU, tmp_path, {"27a": 3, "27b": 2, "27c": 1.5, "27d": 0.5,
                        "27e": 0.5}, 1.0, dict(zip(cs.KERNELS,
                                                   sa.KERNEL_WRAPPERS)),
        ["cpu"] * cs.SHARDS, runs=runs, rate=300, width=8,
        host_budget=1 << 16, device_budget=64 << 20)
    assert [t for _, t, *_ in cs.SHARDED_RUNS] == list(out)
    for (_, tag, _, _, need), rec in zip(runs, out.values()):
        assert rec["counts"]["sharded_batch_executions"] > 0, tag
        for key in need:
            assert min(rec["shard_live_rows"][key]) > 0, (tag, key)
            assert key in rec["replays"], (tag, key)
    assert out["sharded_pooled"]["counts"]["pipeline_rounds"] > 0
    assert out["sharded_balanced"]["counts"]["splitk_launches"] > 0
    assert out["sharded_stacked"]["counts"]["pooled_rows"] == 0
