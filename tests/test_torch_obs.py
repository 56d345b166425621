"""The port's observability layer (``repro_torch.obs``: registry, trace,
export, and the surfaces built on it: ``TransferExecutor.stats``,
``StoreHealth``, ``StreamEngine.observability()`` and
``MultiTenantEngine.observability()``) against the JAX package's: the
counterparts of ``tests/test_obs.py``'s 18 cases on the port, and one
sequence of registry operations through both packages whose snapshot,
Prometheus text and JSON must be identical.

The port keeps the JAX layout with one divergence: the fold's entry in
``observability()["fold"]`` is ``launch_shapes`` (distinct fold launch
shapes), where the JAX package reports its jit cache's ``cache_size``.
The JAX case that injects store failures through ``repro.testing``
(not ported yet) uses a store here that raises ``TransientStoreError``
on its first two reads. Everything runs on the CPU; counts are exact.
"""
import json
import threading

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.configs.base import AionConfig
from repro_torch.core import (
    EventBatch, StreamEngine, TumblingWindows, make_operator,
)
from repro_torch.core.health import StoreHealth
from repro_torch.core.pipeline import MultiTenantEngine, TenantSpec
from repro_torch.core.staging import TransferExecutor
from repro_torch.obs import (
    BoundedSeries, MetricsRegistry, NULL_SPAN, StatsMap, Tracer,
)
from repro_torch.storage.blockstore import TransientStoreError
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n, width=1, seed=0, lo=0.0, hi=10.0, keys=8):
    rng = np.random.default_rng(seed)
    return EventBatch(rng.integers(0, keys, n), rng.uniform(lo, hi, n),
                      rng.normal(size=(n, width)).astype(np.float32))


def _engine(tmp_path, store=None, **aion_kw):
    aion = AionConfig(block_size=32, **aion_kw)
    return StreamEngine(
        assigner=TumblingWindows(10.0),
        operator=make_operator("average", aion.block_size, 1,
                               device="cpu"),
        aion=aion, value_width=1,
        spill_dir=None if store is not None else tmp_path, store=store,
        device="cpu")


# ============================================================= registry
def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("obs_test_ops", "ops")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("obs_test_level")
    g.set(3)
    g.set(1)
    assert g.value == 1
    h = reg.histogram("obs_test_lat", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    snap = h.default.snapshot()
    assert snap["count"] == 3
    assert snap["sum"] == pytest.approx(5.55)


def test_labels_are_distinct_children():
    reg = MetricsRegistry()
    fam = reg.counter("obs_test_tasks", labelnames=("tenant",))
    fam.labels("a").inc(2)
    fam.labels("b").inc(5)
    assert fam.labels("a").value == 2
    assert fam.labels("b").value == 5
    assert fam.labels("a") is fam.labels("a")


def test_registry_rejects_kind_and_label_conflicts():
    reg = MetricsRegistry()
    reg.counter("obs_test_x")
    with pytest.raises(TypeError):
        reg.gauge("obs_test_x")
    reg.counter("obs_test_y", labelnames=("tenant",))
    with pytest.raises(ValueError):
        reg.counter("obs_test_y", labelnames=("shard",))


def test_bounded_series_caps_and_stays_a_list():
    s = BoundedSeries(maxlen=8)
    for i in range(100):
        s.append(i)
    assert len(s) <= 8
    assert s[-1] == 99
    assert isinstance(s, list)
    unbounded = BoundedSeries(0)
    unbounded.extend(range(100))
    assert len(unbounded) == 100


def test_statsmap_behaves_like_the_legacy_dict():
    reg = MetricsRegistry()
    st = StatsMap(reg, "obs_test_io")
    st.register_many(["staged", "errors"])
    st.register_raw("last_error")
    st["staged"] += 3
    st.inc("staged")
    assert st["staged"] == 4
    st["last_error"] = "disk on fire"
    assert "disk on fire" in st["last_error"]
    st.update({"new_counter": 7})
    assert st["new_counter"] == 7
    assert st.get("missing", 42) == 42
    snap = st.copy()
    assert isinstance(snap, dict) and snap["staged"] == 4
    assert st == snap
    assert reg.snapshot()["obs_test_io_staged"] == 4


def _registry_ops(obs):
    """One sequence of registry operations: counters, labelled children,
    gauges, histograms, a StatsMap with raw and auto-registered keys, a
    bounded series and a poll-time callback."""
    reg = obs.MetricsRegistry()
    c = reg.counter("p_ops", "operations")
    c.inc(3)
    fam = reg.counter("p_tasks", "tasks", labelnames=("tenant", "class"))
    fam.labels("a", "stage").inc(2)
    fam.labels("b", "destage").inc(7)
    reg.gauge("p_level", "rung").set(2)
    h = reg.histogram("p_lat", "latency", buckets=(0.01, 0.1, 1.0),
                      labelnames=("tenant",))
    for v in (0.005, 0.05, 0.5, 5.0, 0.05):
        h.labels("a").observe(v)
    st = obs.StatsMap(reg, "p_io", labels={"tenant": "a"})
    st.register_many(["staged", "errors"])
    st.register_raw("last_error", None)
    st["staged"] += 5
    st.inc("errors")
    st["last_error"] = "boom"
    st.update({"extra": 9})
    reg.register_callback(lambda: {"p_free_slots": 17})
    s = obs.BoundedSeries(maxlen=4)
    s.extend(range(10))
    return reg, list(s), st.copy()


def test_registry_snapshot_and_exports_match_the_jax_package():
    jreg, jseries, jst = _registry_ops(jobs)
    treg, tseries, tst = _registry_ops(tobs)
    assert treg.snapshot() == jreg.snapshot()
    assert tobs.to_prometheus(treg) == jobs.to_prometheus(jreg)
    assert json.loads(tobs.to_json(treg)) == json.loads(jobs.to_json(jreg))
    assert tseries == jseries
    assert tst == jst


# ===================================== satellite 1: executor stat races
def test_executor_stats_exact_under_concurrent_hammering():
    ex = TransferExecutor(sequential_io=False, max_pool_workers=8)
    threads, per_thread = 16, 50
    try:
        handles = []
        hlock = threading.Lock()

        def hammer(k):
            for i in range(per_thread):
                if (k + i) % 2:
                    h = ex.submit(0, lambda: None)
                else:
                    def boom():
                        raise IOError("injected")
                    h = ex.submit(0, boom)
                with hlock:
                    handles.append(h)
        ts = [threading.Thread(target=hammer, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert ex.drain(timeout=60)
        total = threads * per_thread
        fails = sum(1 for k in range(threads)
                    for i in range(per_thread) if not (k + i) % 2)
        assert ex.stats["executed"] == total
        assert ex.stats["errors"] == fails
    finally:
        ex.shutdown()


# ==================================== satellite 2: bounded metrics lists
def test_health_transitions_bounded():
    h = StoreHealth(error_threshold=1, cooldown_ticks=1,
                    max_transitions=16)
    for _ in range(200):
        h.tick(5)
        h.tick(0)
        h.tick(0)
    assert len(h.transitions) <= 16
    assert isinstance(h.transitions, BoundedSeries)


def test_engine_wires_health_transitions_cap(tmp_path):
    eng = _engine(tmp_path, breaker_error_threshold=2,
                  health_transitions_max=8)
    assert eng.health is not None
    assert eng.health.transitions.maxlen == 8
    assert eng.metrics.ladder_transitions is eng.health.transitions
    eng.close()


# =============================================================== tracing
def test_sample_rate_zero_records_nothing(tmp_path):
    eng = _engine(tmp_path)
    eng.ingest(_batch(64), now=1.0)
    eng.advance_watermark(10.0, now=2.0)
    eng.poll(3.0)
    eng.close()
    assert eng.tracer.records() == []
    assert eng.tracer.stats()["spans_started"] == 0
    assert not eng.tracer.root("x").sampled


def test_trace_ring_is_bounded():
    tr = Tracer(sample_rate=1.0, capacity=4)
    for i in range(10):
        tr.root(f"s{i}").end()
    st = tr.stats()
    assert st["ring_len"] == 4
    assert st["spans_dropped"] == 6


def test_fold_round_span_parents_watermark_advance_across_threads(
        tmp_path):
    """The fold runs on the port's pipeline worker thread; its span
    parents back to the submitting watermark-advance span."""
    eng = _engine(tmp_path, trace_sample_rate=1.0,
                  pipelined_execution=True)
    eng.ingest(_batch(600, hi=40.0), now=1.0)
    eng.advance_watermark(50.0, now=2.0)
    assert eng.pipeline.drain(timeout=30.0)
    eng.close()
    recs = {r["span"]: r for r in eng.tracer.records()}
    folds = [r for r in recs.values() if r["name"] == "fold_round"]
    assert folds, "no fold_round span recorded"
    for f in folds:
        parent = recs[f["parent"]]
        assert parent["name"] == "watermark_advance"
        assert f["thread"] != parent["thread"]
        assert f["trace"] == parent["trace"]
        assert f["attrs"]["windows"] >= 1
        assert any(e["name"] == "emit" for e in f["events"])


class _FlakyReads:
    """A store whose first ``fails`` reads raise ``TransientStoreError``
    (the JAX case injects the same through ``repro.testing``)."""

    def __init__(self, store, fails):
        self._store = store
        self.fails = fails

    def __getattr__(self, name):
        return getattr(self._store, name)

    def get(self, window_key, block_id):
        if self.fails:
            self.fails -= 1
            raise TransientStoreError("injected transient get")
        return self._store.get(window_key, block_id)


def test_retried_io_span_records_each_backoff_attempt(tmp_path):
    from repro_torch.storage import make_store
    store = _FlakyReads(make_store("log", tmp_path / "store"), 0)
    eng = _engine(tmp_path, store=store, trace_sample_rate=1.0,
                  io_retry_limit=4, io_retry_backoff=0.001)
    eng.ingest(_batch(256), now=1.0)
    state = next(iter(eng.windows.values()))
    for blk in list(state.blocks):
        eng.io.destage_block_sync(blk)
    eng.io.spill_blocks_sync(list(state.blocks))
    store.fails = 2                        # two failures, then success
    root = eng.tracer.root("test_demand")
    h = eng.io.request_stage(state, demand=True, parent=root)
    assert h.wait_checked(30.0)
    root.end()
    assert eng.io.drain(timeout=30)
    eng.close()
    lines = [json.loads(line)
             for line in eng.tracer.export_jsonl().splitlines()]
    stages = [r for r in lines if r["name"] == "io.demand_stage"]
    assert stages, "no demand-stage span exported"
    retries = [e for r in stages for e in r["events"]
               if e["name"] == "retry"]
    assert len(retries) == 2
    assert [e["attempt"] for e in retries] == [1, 2]
    for e in retries:
        assert e["op"] == "get"
        assert e["delay"] > 0
        assert "Transient" in e["error"]


def test_late_event_path_reconstructs_from_jsonl(tmp_path):
    eng = _engine(tmp_path, trace_sample_rate=1.0,
                  pipelined_execution=True)
    eng.ingest(_batch(600, hi=40.0), now=1.0)
    eng.advance_watermark(50.0, now=2.0)
    assert eng.pipeline.drain(timeout=30.0)
    eng.ingest(_batch(64, seed=3, hi=10.0), now=3.0)
    eng.poll(200.0)
    assert eng.pipeline.drain(timeout=30.0)
    assert eng.io.drain(timeout=30)
    eng.close()
    recs = [json.loads(line)
            for line in eng.tracer.export_jsonl().splitlines()]
    by_span = {r["span"]: r for r in recs}
    ingests = [r for r in recs if r["name"] == "ingest"
               and r["attrs"].get("late", 0) > 0]
    assert ingests, "no late ingest span"
    trace_id = ingests[-1]["trace"]
    family = [r for r in recs if r["trace"] == trace_id]
    assert "io.late_write" in {r["name"] for r in family}
    for r in family:
        if r["name"] == "io.late_write":
            assert by_span[r["parent"]]["name"] == "ingest"
            assert r["thread"] != by_span[r["parent"]]["thread"]


# ======================================================== observability
def test_observability_matches_legacy_surfaces(tmp_path):
    eng = _engine(tmp_path, breaker_error_threshold=4)
    for i in range(6):
        eng.ingest(_batch(200, seed=i, hi=40.0), now=float(i))
    eng.advance_watermark(50.0, now=7.0)
    eng.poll(8.0)
    eng.poll(60.0)
    assert eng.io.drain(timeout=30)
    snap = eng.observability()
    assert snap["engine"]["ingested"] == eng.metrics.ingested
    assert snap["engine"]["live_executions"] == \
        eng.metrics.live_executions
    assert snap["io"] == eng.io.stats.copy()
    assert snap["executor"] == eng.io.executor.stats.copy()
    assert snap["store"] == eng.store.stats.copy()
    assert snap["health"]["level"] == eng.health.level
    assert snap["trace"]["sample_rate"] == 0.0
    assert snap["pipeline"] == {}
    if eng.pool is not None:
        assert snap["pool"]["pool_slots"] == eng.pool.pool_slots
    assert "launch_shapes" in snap["fold"]
    eng.close()


def test_prometheus_export_format(tmp_path):
    eng = _engine(tmp_path)
    eng.ingest(_batch(64), now=1.0)
    eng.advance_watermark(10.0, now=2.0)
    eng.poll(3.0)
    text = eng.observability(export="prometheus")
    lines = text.splitlines()
    assert any(line.startswith("# TYPE aion_engine_ingested_total counter")
               for line in lines)
    assert any(line.startswith(
        'aion_engine_ingested_total{tenant="default"}') for line in lines)
    assert any("aion_fold_round_seconds_bucket" in line
               and 'le="+Inf"' in line for line in lines)
    assert any(line.startswith("aion_fold_round_seconds_count")
               for line in lines)
    js = json.loads(eng.observability(export="json"))
    assert js['aion_engine_ingested{tenant="default"}'] == 64
    with pytest.raises(ValueError):
        eng.observability(export="xml")
    eng.close()


def test_pool_occupancy_via_registry_callback(tmp_path):
    eng = _engine(tmp_path)
    assert eng.pool is not None
    snap = json.loads(eng.observability(export="json"))
    assert snap["aion_pool_slots"] == eng.pool.pool_slots
    assert snap["aion_pool_free_slots"] == eng.pool.free_slots()
    eng.close()


def test_multitenant_observability_covers_everything(tmp_path):
    aion = AionConfig(block_size=32)
    mt = MultiTenantEngine(
        [TenantSpec(name="a", assigner=TumblingWindows(10.0),
                    operator=make_operator("average", 32, 1, device="cpu")),
         TenantSpec(name="b", assigner=TumblingWindows(10.0),
                    operator=make_operator("average", 32, 1,
                                           device="cpu"))],
        spill_dir=tmp_path, aion=aion, device="cpu")
    mt.ingest("a", _batch(128, seed=1), now=1.0)
    mt.ingest("b", _batch(64, seed=2), now=1.0)
    mt.advance_watermark(20.0, now=2.0)
    mt.poll(3.0)
    snap = mt.observability()
    assert set(snap["tenants"]) == {"a", "b"}
    assert snap["tenants"]["a"]["engine"]["ingested"] == 128
    assert snap["tenants"]["b"]["engine"]["ingested"] == 64
    assert "tenant_fairness" in snap and "executor" in snap
    reg = snap["registry"]
    assert reg['aion_engine_ingested{tenant="a"}'] == 128
    assert reg['aion_engine_ingested{tenant="b"}'] == 64
    prom = mt.observability(export="prometheus")
    assert 'tenant="a"' in prom and 'tenant="b"' in prom
    mt.close()


def test_tracing_overhead_disabled_is_free(tmp_path):
    eng = _engine(tmp_path)
    assert eng.tracer.root("a") is NULL_SPAN
    assert eng.tracer.child(NULL_SPAN, "b") is NULL_SPAN
    assert eng.tracer.child(None, "c") is NULL_SPAN
    eng.close()
