"""The differential soak on the port: ``tests/test_soak_differential.py``'s
rows, run through ``repro_torch``'s ``StreamEngine`` on the CPU on the
same seed, event stream, budgets and mid-stream checkpoint/restore, and
held to the same numpy oracles with the same tolerances (the means within
``rel=2e-4, abs=2e-4``; stock min and max within 1e-5; percentiles within
1e-5). The rows with ``sharded=True`` run on a ``SHARDS``-entry slot mesh
of the CPU (the JAX package shards them only under a forced host device
count, and is a checked no-op on one device), and must have folded
sharded. Besides, one stream with no faults goes through both packages'
engines and the per-window results agree within the soak's tolerances.

The harness (``drive``) is shared with ``tests/test_torch_chaos.py``.
"""
import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

import test_soak_differential as J
import torch

WINDOW, N_EVENTS, CHUNK, MAX_LATE, SEED = (J.WINDOW, J.N_EVENTS, J.CHUNK,
                                           J.MAX_LATE, J.SEED)
CHAOS_OPS = J._CHAOS_OPS
REL = ABS = 2e-4
#: entries of the port's slot mesh in the sharded rows (one CPU, named
#: this many times)
SHARDS = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def package(name: str) -> SimpleNamespace:
    """The modules a soak needs, from the port (``torch``) or the JAX
    package (``jax``), and the keyword that puts an engine on the CPU."""
    if name == "torch":
        from repro_torch import core, storage, testing
        from repro_torch.configs.base import AionConfig
        from repro_torch.core.triggers import DeltaTTrigger
        from repro_torch.distributed.fault import EngineRecovery
        dev = {"device": "cpu"}
    else:
        from repro import core, storage, testing
        from repro.configs.base import AionConfig
        from repro.core.triggers import DeltaTTrigger
        from repro.distributed.fault import EngineRecovery
        dev = {}
    return SimpleNamespace(core=core, storage=storage, testing=testing,
                           AionConfig=AionConfig,
                           DeltaTTrigger=DeltaTTrigger,
                           EngineRecovery=EngineRecovery, dev=dev)


def cleanup(pkg):
    """The soak's purge-free cleanup with its fixed 60 s horizon."""
    class NoPurge(pkg.core.PredictiveCleanup):
        def should_purge(self, window_end, watermark):
            return False
    return NoPurge(initial_bound=60.0, min_history=1 << 62)


def make_engine(pkg, op_name, batched, sharded, spill_dir, width,
                pooled=False, store="log", pipelined=False,
                prefetch="fixed", splitk=0, fault_rate=0.0, fault_seed=0):
    """``test_soak_differential._make_engine`` for either package."""
    extra = {}
    if fault_rate > 0:
        extra = dict(io_retry_backoff=0.0, breaker_error_threshold=2)
    aion = pkg.AionConfig(block_size=256, batched_execution=batched,
                          slot_sharding=sharded, block_pool=pooled,
                          store_backend=store,
                          store_segment_bytes=128 << 10,
                          pipelined_execution=pipelined,
                          prefetch_backend=prefetch,
                          splitk_chunk_rows=splitk, **extra)
    store_obj = None
    if fault_rate > 0:
        inner = pkg.storage.make_store("log", spill_dir,
                                       segment_bytes=128 << 10)
        inj = pkg.testing.FaultInjector(
            seed=fault_seed, rates={op: fault_rate for op in CHAOS_OPS},
            max_consecutive=2)
        store_obj = pkg.testing.FaultyBlockStore(inner, inj)
    kw = {"num_keys": 8} if op_name == "stock" else {}
    eng = pkg.core.StreamEngine(
        assigner=pkg.core.TumblingWindows(WINDOW),
        operator=pkg.core.make_operator(op_name, aion.block_size, width,
                                        **kw, **pkg.dev),
        aion=aion, value_width=width, cleanup=cleanup(pkg),
        trigger=pkg.DeltaTTrigger(executions=2),
        device_budget_bytes=1 << 17 if fault_rate > 0 else 1 << 20,
        host_budget_bytes=1 << 16 if fault_rate > 0 else 1 << 19,
        spill_dir=spill_dir, store=store_obj, **pkg.dev,
        **({"slot_devices": ["cpu"] * SHARDS} if sharded and pkg.dev
           else {}))
    if store_obj is not None:
        eng._fault_injector = store_obj.injector
    return eng


def barrier(eng) -> None:
    """Wait until the engine's pipeline and I/O thread are idle: the JAX
    side of a comparison steps through it, since the JAX engine loses
    events that ingest appends while its I/O thread spills or stages the
    same block (ROADMAP Queue 3, item 18)."""
    if eng.pipeline is not None:
        assert eng.pipeline.drain()
    assert eng.io.drain()


def final_sweep(pkg, eng, now) -> None:
    """``test_soak_differential._final_sweep``."""
    eng.flush_deferred(now)
    if eng.pipeline is not None:
        assert eng.pipeline.drain(), "fold pipeline failed to drain"
    assert eng.io.drain(), "I/O executor failed to drain"
    items = [pkg.core.BatchWorkItem(wid, eng.windows[wid], True)
             for wid in sorted(eng.windows)]
    if eng.batching_enabled and len(items) > 1:
        eng.batch_exec.execute(items, now)
    else:
        for it in items:
            eng.execute_window(it.wid, now, late=True)


def drive(op_name, batched, sharded, spill_dir, width=1, pooled=False,
          store="log", pipelined=False, prefetch="fixed", splitk=0,
          fault_rate=0.0, fault_seed=0, pkg="torch", step_barrier=False):
    """``test_soak_differential._drive`` for either package: the same
    stream of ``N_EVENTS`` events from ``SEED``, the checkpoint and
    restore into a fresh engine at the half (under ``paused()`` with
    faults on), the same close-out. Returns (results keyed by
    ``(start, end)``, the oracle's events, counter totals)."""
    p = package(pkg)
    rng = np.random.default_rng(SEED)
    totals = J._SoakTotals()
    args = (op_name, batched, sharded)
    eng = make_engine(p, *args, spill_dir / "a", width, pooled, store,
                      pipelined, prefetch, splitk, fault_rate, fault_seed)
    all_events = []
    now = wm = 0.0
    emitted = 0
    restored = False
    while emitted < N_EVENTS:
        n = min(CHUNK, N_EVENTS - emitted)
        u = rng.random(n)
        delay = np.where(
            u < 0.65, rng.uniform(0.0, 2.0, n),
            np.where(u < 0.90, rng.uniform(0.0, MAX_LATE, n),
                     rng.uniform(MAX_LATE * 0.6, MAX_LATE, n)))
        ts = np.maximum(now - delay, 0.0)
        batch = p.core.EventBatch(
            rng.integers(0, 8, n), ts,
            rng.normal(size=(n, width)).astype(np.float32))
        all_events.append((batch.keys.copy(), batch.timestamps.copy(),
                           batch.values.copy()))
        eng.ingest(batch, now)
        emitted += n
        if rng.random() < 0.7:
            wm = max(wm, now - rng.uniform(0.0, 5.0))
            eng.advance_watermark(wm, now)
        eng.poll(now)
        if step_barrier:
            barrier(eng)
        now += rng.uniform(1.0, 4.0)
        if not restored and emitted >= N_EVENTS // 2:
            restored = True
            inj = getattr(eng, "_fault_injector", None)
            with inj.paused() if inj is not None else \
                    contextlib.nullcontext():
                snap = eng.checkpoint_state()
                totals.absorb(eng)
                eng.close()
            eng = make_engine(p, *args, spill_dir / "b", width, pooled,
                              store, pipelined, prefetch, splitk,
                              fault_rate, fault_seed + 1)
            inj = getattr(eng, "_fault_injector", None)
            with inj.paused() if inj is not None else \
                    contextlib.nullcontext():
                eng.restore_state(snap)
    wm = now + MAX_LATE
    eng.advance_watermark(wm, now)
    for t in np.linspace(now, now + 70.0, 8):
        eng.poll(t)
    final_sweep(p, eng, now + 70.0)
    results = {(w.start, w.end): r for w, r in eng.results.items()}
    totals.absorb(eng)
    eng.close()
    keys = np.concatenate([k for k, _, _ in all_events])
    tss = np.concatenate([t for _, t, _ in all_events])
    vals = np.concatenate([v for _, _, v in all_events])
    return results, (keys, tss, vals), totals


def _keyed(oracle: dict) -> dict:
    return {(w.start, w.end): r for w, r in oracle.items()}


def oracle_average(events) -> dict:
    return _keyed(J._oracle_average(*events))


def hold_average(results, want) -> None:
    assert set(results) == set(want)
    for wid in want:
        assert results[wid] == pytest.approx(want[wid], rel=REL,
                                             abs=ABS), wid


def hold_stock(results, events) -> None:
    want = _keyed(J._oracle_stock(*events))
    assert set(results) == set(want)
    for wid, w in want.items():
        got = results[wid]
        present = w["min"] < np.inf
        np.testing.assert_allclose(np.asarray(got["mean"])[present],
                                   w["mean"][present], rtol=REL, atol=ABS,
                                   err_msg=str(wid))
        np.testing.assert_allclose(np.asarray(got["min"])[present],
                                   w["min"][present], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(got["max"])[present],
                                   w["max"][present], rtol=1e-5, atol=1e-5)


# ------------------------------------------ test_soak_differential's rows
@pytest.mark.parametrize("batched,pooled,store", [
    (True, True, "log"), (True, False, "log"), (False, False, "log"),
    (True, True, "npz"),
])
def test_soak_differential_average(tmp_path, batched, pooled, store):
    results, events, totals = drive("average", batched, False, tmp_path,
                                    pooled=pooled, store=store)
    hold_average(results, oracle_average(events))
    assert totals.ingested == N_EVENTS
    assert totals.ingested_late > N_EVENTS // 10
    assert totals.late_executions > 0
    if batched:
        assert totals.batch_executions > 0
    else:
        assert totals.batch_executions == 0
    assert totals.sharded_batch_executions == 0
    if pooled and batched:
        assert totals.pooled_rows > 0
    else:
        assert totals.pooled_rows == 0


@pytest.mark.parametrize("pooled", [True, False])
def test_soak_differential_stock_spill_pressure(tmp_path, pooled):
    results, events, totals = drive("stock", True, False, tmp_path,
                                    pooled=pooled)
    hold_stock(results, events)
    assert totals.ingested == N_EVENTS
    if pooled:
        assert totals.pooled_rows > 0


@pytest.mark.parametrize("pooled", [True, False])
def test_soak_differential_pipelined(tmp_path, pooled):
    results, events, totals = drive("average", True, False, tmp_path,
                                    pooled=pooled, pipelined=True)
    hold_average(results, oracle_average(events))
    assert totals.ingested == N_EVENTS
    assert totals.ingested_late > N_EVENTS // 10
    assert totals.pipeline_rounds > 0
    assert totals.io_errors == 0
    if pooled:
        assert totals.pooled_rows > 0


@pytest.mark.parametrize("batched,pipelined", [
    (True, False), (True, True), (False, False),
])
def test_soak_differential_learned_prefetch(tmp_path, batched, pipelined):
    results, events, totals = drive("average", batched, False, tmp_path,
                                    pipelined=pipelined, prefetch="learned")
    hold_average(results, oracle_average(events))
    assert totals.ingested == N_EVENTS
    assert totals.ingested_late > N_EVENTS // 10
    assert totals.io_errors == 0


@pytest.mark.parametrize("splitk", [8, 0])
def test_soak_differential_splitk(tmp_path, splitk):
    results, events, totals = drive("stock", True, False, tmp_path,
                                    pooled=True, splitk=splitk)
    hold_stock(results, events)
    assert totals.ingested == N_EVENTS
    if splitk:
        assert totals.splitk_launches > 0
    else:
        assert totals.splitk_launches == 0


@pytest.mark.parametrize("splitk", [0, 8])
def test_soak_differential_percentile(tmp_path, splitk):
    results, events, totals = drive("percentile", True, False, tmp_path,
                                    pooled=True, splitk=splitk)
    want = _keyed(J._oracle_percentile(*events))
    assert set(results) == set(want)
    for wid, w in want.items():
        for q, v in w.items():
            assert results[wid][q] == pytest.approx(v, rel=1e-5,
                                                    abs=1e-5), (wid, q)
    assert totals.ingested == N_EVENTS
    assert totals.batch_executions > 0
    if splitk:
        assert totals.splitk_launches > 0


# ----------------------------------- test_soak_differential's sharded rows
@pytest.mark.parametrize("batched,pooled,store", [
    (True, True, "log"), (True, False, "log"), (False, False, "log"),
    (True, False, "npz"),
])
def test_soak_differential_average_sharded(tmp_path, batched, pooled,
                                           store):
    results, events, totals = drive("average", batched, True, tmp_path,
                                    pooled=pooled, store=store)
    hold_average(results, oracle_average(events))
    assert totals.ingested == N_EVENTS
    assert totals.ingested_late > N_EVENTS // 10
    assert totals.late_executions > 0
    if batched:
        assert totals.batch_executions > 0
        assert totals.sharded_batch_executions > 0
    else:
        assert totals.batch_executions == 0
        assert totals.sharded_batch_executions == 0
    if pooled:
        assert totals.pooled_rows > 0
    else:
        assert totals.pooled_rows == 0


@pytest.mark.parametrize("pooled", [True, False])
def test_soak_differential_stock_spill_pressure_sharded(tmp_path, pooled):
    results, events, totals = drive("stock", True, True, tmp_path,
                                    pooled=pooled)
    hold_stock(results, events)
    assert totals.ingested == N_EVENTS
    assert totals.sharded_batch_executions > 0
    if pooled:
        assert totals.pooled_rows > 0


@pytest.mark.parametrize("pooled", [True, False])
def test_soak_differential_splitk_sharded(tmp_path, pooled):
    """Split-K over the sharded layouts: per-shard chunks (K3 on each
    shard) with the pool, the row-balanced stacked fold without it."""
    results, events, totals = drive("stock", True, True, tmp_path,
                                    pooled=pooled, splitk=8)
    hold_stock(results, events)
    assert totals.ingested == N_EVENTS
    assert totals.sharded_batch_executions > 0
    assert totals.splitk_launches > 0


@pytest.mark.parametrize("pooled", [True, False])
def test_soak_differential_pipelined_sharded(tmp_path, pooled):
    """``test_soak_differential_pipelined``'s row on the slot mesh: every
    round folds sharded on the pipeline's worker (the pooled one through
    the epoch-checked pin strategy)."""
    results, events, totals = drive("average", True, True, tmp_path,
                                    pooled=pooled, pipelined=True)
    hold_average(results, oracle_average(events))
    assert totals.ingested == N_EVENTS
    assert totals.ingested_late > N_EVENTS // 10
    assert totals.pipeline_rounds > 0
    assert totals.sharded_batch_executions > 0
    assert totals.io_errors == 0
    assert (totals.pooled_rows > 0) == pooled


# --------------------------------------------------- the two engines agree
def test_both_engines_agree_without_faults(tmp_path):
    """One stream with no faults through both packages' engines (batched,
    pooled, spilling, restored at the half): the per-window results agree
    within the soak's tolerances, and each meets the oracle. The JAX side
    steps with its threads idle (``barrier``)."""
    got, events, t_port = drive("average", True, False, tmp_path / "t",
                                pooled=True)
    ref, ref_events, t_jax = drive("average", True, False, tmp_path / "j",
                                   pooled=True, pkg="jax",
                                   step_barrier=True)
    for a, b in zip(events, ref_events):
        np.testing.assert_array_equal(a, b)
    hold_average(got, ref)
    hold_average(got, oracle_average(events))
    assert t_port.ingested == t_jax.ingested == N_EVENTS
    assert t_port.pooled_rows > 0 and t_jax.pooled_rows > 0
