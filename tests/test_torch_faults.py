"""The self-healing I/O path on the port: ``tests/test_faults.py``'s 25
cases through ``repro_torch`` on the CPU (the error taxonomy,
``FaultInjector`` and ``FaultyBlockStore``, ``IOScheduler._with_retries``,
``StoreHealth``, the degradation ladder in ``StreamEngine``, the pipeline
round retry, the coalesced-commit unwind, the drain's aggregated errors
and the executor's dispatch hook), then the injector's decisions against
the JAX injector's (10,000 calls an operation, three seeds, with a
schedule, ``max_consecutive``, ``poison``/``heal`` and ``paused``) and a
crashed store with a torn tail, written by either package, reopened in
both with the same truncated bytes and records.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.configs.base import AionConfig
from repro_torch.core import (
    EventBatch, StreamEngine, TumblingWindows, make_operator,
)
from repro_torch.core.batch_exec import BatchWorkItem
from repro_torch.core.buckets import Block, MemoryBudget, Tier
from repro_torch.core.health import (
    LEVEL_BACKPRESSURE, LEVEL_HEALTHY, LEVEL_SHED_PREFETCH,
    LEVEL_SHED_READAHEAD, LEVEL_SYNC_ROUNDS, MAX_LEVEL, StoreHealth,
)
from repro_torch.core.staging import (
    IOScheduler, PRIO_STAGE, StagingError, TransferExecutor,
)
from repro_torch.storage import (
    PermanentStoreError, TransientStoreError, is_transient_error,
    make_store,
)
from repro_torch.testing import FaultInjector, FaultyBlockStore


def _batch(n, width=1, seed=0, lo=0.0, hi=10.0):
    rng = np.random.default_rng(seed)
    return EventBatch(rng.integers(0, 8, n), rng.uniform(lo, hi, n),
                      rng.normal(size=(n, width)).astype(np.float32))


def _filled_block(capacity=32, width=1, key=(0.0, 10.0), seed=0):
    blk = Block.new(capacity, width)
    blk.window_key = key
    blk.append(_batch(capacity, width, seed), 0)
    return blk


# ------------------------------------------------------- error taxonomy
def test_transient_vs_permanent_classification():
    assert is_transient_error(TransientStoreError("flaky"))
    assert is_transient_error(OSError("generic io"))
    assert is_transient_error(TimeoutError("slow"))
    assert is_transient_error(ConnectionError("reset"))
    assert not is_transient_error(PermanentStoreError("corrupt"))
    assert not is_transient_error(ValueError("not io at all"))
    # the permanent error is NOT an OSError subclass sneaking through
    assert not isinstance(PermanentStoreError("x"), OSError)


# --------------------------------------------------------- FaultInjector
def test_injector_is_deterministic_per_seed():
    a = FaultInjector(seed=7, rates={"get": 0.5})
    b = FaultInjector(seed=7, rates={"get": 0.5})
    seq_a = [a.should_fail("get") for _ in range(64)]
    seq_b = [b.should_fail("get") for _ in range(64)]
    assert seq_a == seq_b
    assert any(seq_a) and not all(seq_a)   # rate actually draws both ways


def test_injector_schedule_and_fail_next():
    inj = FaultInjector(schedule={"put": [1, 3]})
    assert [inj.should_fail("put") for _ in range(4)] == \
        [False, True, False, True]
    inj.fail_next("commit", n=2)
    assert inj.should_fail("commit") and inj.should_fail("commit")
    assert not inj.should_fail("commit")


def test_injector_max_consecutive_bounds_streaks():
    # rate 1.0 would fail forever; max_consecutive=2 forces every third
    # call through — which is what makes retry success deterministic
    inj = FaultInjector(rates={"get": 1.0}, max_consecutive=2)
    seq = [inj.should_fail("get") for _ in range(6)]
    assert seq == [True, True, False, True, True, False]


def test_injector_paused_and_poison():
    inj = FaultInjector(rates={"get": 1.0})
    with inj.paused():
        assert not inj.should_fail("get")
    with pytest.raises(TransientStoreError):
        inj.maybe_fail("get")
    inj.poison(("get",))
    with pytest.raises(PermanentStoreError):
        inj.maybe_fail("get")
    inj.heal()
    with pytest.raises(TransientStoreError):   # back to rate-driven
        inj.maybe_fail("get")
    assert inj.stats["injected"] == 3


# ------------------------------------------------------ FaultyBlockStore
def test_faulty_store_injects_and_delegates(tmp_path):
    inner = make_store("log", tmp_path)
    inj = FaultInjector()
    store = FaultyBlockStore(inner, inj)
    blk = _filled_block()
    inj.fail_next("put")
    with pytest.raises(TransientStoreError):
        store.put(blk.window_key, blk.block_id, blk.host_data, blk.fill)
    # next call goes through, and inner-store state is visible through
    # the wrapper (delegated attributes)
    store.put(blk.window_key, blk.block_id, blk.host_data, blk.fill)
    store.commit()
    assert store.current_fill(blk.window_key, blk.block_id) == blk.fill
    got = store.get(blk.window_key, blk.block_id)
    np.testing.assert_array_equal(got["keys"][:blk.fill],
                                  blk.host_data["keys"][:blk.fill])
    assert store.durable_writes            # delegated class attribute
    store.close()


def test_faulty_store_crash_torn_tail_recovers(tmp_path):
    inner = make_store("log", tmp_path)
    store = FaultyBlockStore(inner, FaultInjector())
    durable = _filled_block(seed=1)
    store.put(durable.window_key, durable.block_id,
              durable.host_data, durable.fill)
    store.commit()                         # acknowledged
    lost = _filled_block(seed=2)
    store.put(lost.window_key, lost.block_id,
              lost.host_data, lost.fill)   # never committed
    store.crash(torn_tail_bytes=7)         # kill -9 with a torn tail
    reopened = make_store("log", tmp_path)
    try:
        # WAL recovery: the acknowledged record survives byte-exact, the
        # unacknowledged tail (incl. the torn bytes) is gone
        assert reopened.current_fill(durable.window_key,
                                     durable.block_id) == durable.fill
        got = reopened.get(durable.window_key, durable.block_id)
        np.testing.assert_array_equal(
            got["values"][:durable.fill],
            durable.host_data["values"][:durable.fill])
        assert reopened.get(lost.window_key, lost.block_id) is None
    finally:
        reopened.close()


# ------------------------------------------------------- retry machinery
def test_with_retries_recovers_transient_failures():
    io = IOScheduler(MemoryBudget(1 << 20), io_retry_limit=4,
                     io_retry_backoff=0.0, device="cpu")
    try:
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise TransientStoreError("flaky")
            return "ok"
        assert io._with_retries(flaky, "get") == "ok"
        assert calls["n"] == 3
        assert io.stats["retries"] == 2
        assert io.stats["gave_up"] == 0
    finally:
        io.shutdown()


def test_with_retries_exhaustion_surfaces_and_counts():
    io = IOScheduler(MemoryBudget(1 << 20), io_retry_limit=3,
                     io_retry_backoff=0.0, device="cpu")
    try:
        def always():
            raise TransientStoreError("dead disk")
        with pytest.raises(TransientStoreError):
            io._with_retries(always, "get")
        assert io.stats["retries"] == 3    # the full budget was spent
        assert io.stats["gave_up"] == 1    # then surfaced honestly
    finally:
        io.shutdown()


def test_with_retries_permanent_error_skips_retries():
    io = IOScheduler(MemoryBudget(1 << 20), io_retry_limit=5, device="cpu")
    try:
        calls = {"n": 0}

        def corrupt():
            calls["n"] += 1
            raise PermanentStoreError("bad checksum")
        with pytest.raises(PermanentStoreError):
            io._with_retries(corrupt, "get")
        assert calls["n"] == 1             # retrying corruption is futile
        assert io.stats["retries"] == 0
        assert io.stats["gave_up"] == 0    # gave_up counts transient only
    finally:
        io.shutdown()


def test_with_retries_shed_ok_sheds_instead_of_raising():
    io = IOScheduler(MemoryBudget(1 << 20), io_retry_limit=1,
                     io_retry_backoff=0.0, device="cpu")
    try:
        def always():
            raise TransientStoreError("sweep failed")
        assert io._with_retries(always, "readahead", shed_ok=True) is None
        assert io.stats["readahead_shed"] == 1
        assert io.stats["gave_up"] == 0    # shed, not given up
    finally:
        io.shutdown()


def test_io_retry_limit_zero_disables_retries():
    io = IOScheduler(MemoryBudget(1 << 20), io_retry_limit=0, device="cpu")
    try:
        with pytest.raises(TransientStoreError):
            io._with_retries(
                lambda: (_ for _ in ()).throw(TransientStoreError("x")),
                "get")
        assert io.stats["retries"] == 0
    finally:
        io.shutdown()


def test_demand_fetch_retries_through_faulty_store(tmp_path):
    """End-to-end: a block spilled to a flaky store demand-loads through
    the retry budget — no error escapes, gave_up stays 0."""
    inner = make_store("log", tmp_path)
    inj = FaultInjector(seed=3, rates={"get": 0.9}, max_consecutive=2)
    store = FaultyBlockStore(inner, inj)
    io = IOScheduler(MemoryBudget(1 << 20), store=store,
                     io_retry_limit=4, io_retry_backoff=0.0, device="cpu")
    try:
        blk = _filled_block()
        with inj.paused():
            io.spill_blocks_sync([blk])
        assert blk.tier == Tier.STORAGE
        for _ in range(8):                 # several flaky demand reads
            blk.tier = Tier.STORAGE if blk.host_data is None else blk.tier
            data = io.fetch_block_host(blk)
            assert data is not None
        assert io.stats["retries"] > 0
        assert io.stats["gave_up"] == 0
    finally:
        io.shutdown()


# ----------------------------------------------------------- StoreHealth
def test_health_climbs_one_rung_per_bad_tick():
    h = StoreHealth(error_threshold=4, cooldown_ticks=2)
    for expect in (1, 2, 3, 4):
        assert h.tick(10) == expect
    assert h.tick(10) == MAX_LEVEL         # clamped at the top
    assert h.transitions == [(0, 1), (1, 2), (2, 3), (3, 4)]


def test_health_cooldown_reverses_in_order():
    h = StoreHealth(error_threshold=4, cooldown_ticks=2)
    h.tick(10); h.tick(10)                 # -> level 2
    assert h.tick(0) == 2                  # 1 clean tick: not yet
    assert h.tick(0) == 1                  # 2 clean ticks: step down
    assert h.tick(3) == 1                  # sub-threshold noise: hold
    assert h.tick(0) == 1
    assert h.tick(0) == 0
    assert h.transitions == [(0, 1), (1, 2), (2, 1), (1, 0)]


def test_health_disabled_when_threshold_zero():
    h = StoreHealth(error_threshold=0)
    for _ in range(10):
        assert h.tick(1000) == LEVEL_HEALTHY
    assert h.transitions == []


# ----------------------------------------------- engine ladder integration
def _ladder_engine(tmp_path, **kw):
    kw.setdefault("breaker_error_threshold", 4)
    kw.setdefault("breaker_cooldown_ticks", 1)
    aion = AionConfig(block_size=32, pipelined_execution=True, **kw)
    return StreamEngine(
        assigner=TumblingWindows(10.0),
        operator=make_operator("average", aion.block_size, 1, device="cpu"),
        aion=aion, value_width=1, spill_dir=tmp_path, device="cpu")


def test_ladder_sheds_in_order_and_reverses(tmp_path):
    """The whole ladder, rung by rung: readahead sheds first, then
    prefetch, then pipelined rounds demote, then ingest backpressures —
    and clean ticks walk it all back with nothing lost."""
    eng = _ladder_engine(tmp_path)
    assert eng.health is not None and eng.round_backup is not None

    def bump(n=10):
        eng.io.stats["retries"] += n       # simulated error/retry burst

    # rung 1: speculative readahead drives shed (same poll that climbed)
    bump(); eng.poll(1.0)
    assert eng.health.level == LEVEL_SHED_READAHEAD
    assert eng.metrics.shed_readahead_drives >= 1

    # rung 2: pipelined next-round prefetch sheds
    bump(); eng.poll(1.1)
    assert eng.health.level == LEVEL_SHED_PREFETCH
    eng.ingest(_batch(64, seed=5), now=1.2)
    wid, state = next(iter(eng.windows.items()))
    for blk in list(state.blocks):         # force blocks cold (p-bucket)
        eng.io.destage_block_sync(blk)
    assert state.p_blocks()
    eng.prefetch_round([BatchWorkItem(wid, state, False)])
    assert eng.metrics.shed_prefetch_rounds == 1

    # rung 3: the watermark round folds synchronously, not pipelined
    bump(); eng.poll(1.3)
    assert eng.health.level == LEVEL_SYNC_ROUNDS
    eng.advance_watermark(10.0, now=1.4)
    assert eng.metrics.demoted_sync_rounds == 1
    assert not eng.result_futures          # nothing went to the pipeline
    assert wid in eng.results              # but the window DID fold

    # rung 4: ingest defers instead of admitting
    bump(); eng.poll(1.5)
    assert eng.health.level == LEVEL_BACKPRESSURE
    late = _batch(48, seed=6)
    assert eng.ingest(late, now=1.6) == len(late)
    assert eng.metrics.deferred_events == len(late)
    ingested_before = eng.metrics.ingested

    # recovery: clean ticks walk back down; the first sub-top poll
    # readmits everything that was deferred
    eng.poll(1.7)
    assert eng.health.level == LEVEL_SYNC_ROUNDS
    assert eng.metrics.readmitted_events == len(late)
    assert eng.metrics.ingested == ingested_before + len(late)
    for t in (1.8, 1.9, 2.0):
        eng.poll(t)
    assert eng.health.level == LEVEL_HEALTHY

    # the transition log IS the shed-order evidence
    assert eng.metrics.ladder_transitions[:4] == \
        [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert eng.metrics.ladder_transitions[-1] == (1, 0)
    assert eng.io.stats["gave_up"] == 0
    eng.close()


def test_backpressure_trickles_at_top_rung(tmp_path):
    """Sustained pressure must not starve deferred events forever: one
    oldest batch readmits per poll even while the rung holds."""
    eng = _ladder_engine(tmp_path)
    for t in (0.1, 0.2, 0.3, 0.4):         # climb to the top rung
        eng.io.stats["retries"] += 10
        eng.poll(t)
    assert eng.health.level == LEVEL_BACKPRESSURE
    b1, b2 = _batch(16, seed=1), _batch(16, seed=2)
    eng.ingest(b1, now=0.5)
    eng.ingest(b2, now=0.5)
    assert eng.metrics.deferred_events == 32
    eng.io.stats["retries"] += 10          # pressure persists
    eng.poll(0.6)
    assert eng.health.level == LEVEL_BACKPRESSURE
    assert eng.metrics.readmitted_events == 16      # b1 trickled through
    eng.flush_deferred()                   # drain barrier gets the rest
    assert eng.metrics.readmitted_events == 32
    assert eng.metrics.ingested == 32
    eng.close()


def test_close_flushes_deferred_ingest(tmp_path):
    eng = _ladder_engine(tmp_path)
    for t in (0.1, 0.2, 0.3, 0.4):
        eng.io.stats["retries"] += 10
        eng.poll(t)
    b = _batch(24, seed=9)
    assert eng.ingest(b, now=0.5) == 24
    eng.close()                            # must fold, not drop
    assert eng.metrics.ingested == 24
    assert eng.metrics.readmitted_events == 24


def test_ladder_disabled_by_config(tmp_path):
    eng = _ladder_engine(tmp_path, breaker_error_threshold=0)
    assert eng.health is None
    eng.io.stats["retries"] += 1000
    eng.poll(1.0)
    assert eng.metrics.degradation_level == 0
    assert eng.ingest(_batch(8), now=1.1) == 0     # never defers
    eng.close()


# ---------------------------------------------------- pipeline round retry
def test_pipeline_round_retries_once_and_wins(tmp_path):
    """A transiently-failing fold round retries through the backup
    executor and succeeds — the futures resolve with results, not
    errors, and close() sees a clean pipeline."""
    aion = AionConfig(block_size=32, pipelined_execution=True)
    eng = StreamEngine(
        assigner=TumblingWindows(10.0),
        operator=make_operator("average", aion.block_size, 1, device="cpu"),
        aion=aion, value_width=1, spill_dir=tmp_path, device="cpu")
    assert eng.pipeline is not None and eng.round_backup is not None
    real = eng.batch_exec.execute
    state = {"fails": 1}

    def flaky_execute(items, now):
        if state["fails"] > 0:
            state["fails"] -= 1
            raise IOError("injected transient fold failure")
        return real(items, now)
    eng.batch_exec.execute = flaky_execute
    eng.ingest(_batch(64, seed=4), now=1.0)
    eng.advance_watermark(10.0, now=2.0)
    assert eng.pipeline.drain(timeout=30.0, raise_on_error=True)
    assert eng.pipeline.stats["round_retries"] == 1
    assert eng.pipeline.stats["round_retry_wins"] == 1
    for fut in eng.result_futures.values():
        assert fut.result(timeout=5.0) is not None
    eng.batch_exec.execute = real
    eng.close()


# ---------------------------------------- satellite: coalescer unwind
def test_failed_coalesced_commits_requeue_exactly_once(tmp_path):
    """Two failing coalesced flushes over the same blocks must re-queue
    each host copy exactly once: no double-registered ``_host_bytes``,
    no duplicate spill-LRU entries — and after the store heals the same
    blocks spill through cleanly."""
    inner = make_store("log", tmp_path)
    inj = FaultInjector()
    store = FaultyBlockStore(inner, inj)
    io = IOScheduler(MemoryBudget(1 << 20), store=store,
                     host_budget_bytes=0, wal_coalesce=True,
                     io_retry_limit=2, io_retry_backoff=0.0, device="cpu")
    try:
        assert io._coalescer is not None
        blocks = [_filled_block(seed=s, key=(0.0, 10.0)) for s in (1, 2)]
        for b in blocks:
            io._account_host(b)
        expected_bytes = sum(b.nbytes for b in blocks)
        assert io._host_bytes == expected_bytes

        inj.poison(("commit",))            # flushes fail, permanently
        for _ in range(2):                 # two failing flush cycles
            io._maybe_spill()              # pops candidates, queues flush
            assert io.drain(timeout=10.0)
            assert io._host_bytes == expected_bytes        # not doubled
            lru = list(io._host_lru)
            for b in blocks:
                assert lru.count(b) == 1                   # exactly once
                assert b.tier == Tier.HOST                 # copy kept
        assert io._pending_spill_bytes == 0

        inj.heal()
        io._maybe_spill()
        assert io.drain(timeout=10.0)
        for b in blocks:
            assert b.tier == Tier.STORAGE
        assert io._host_bytes == 0
        assert not io._host_lru
    finally:
        io.shutdown()


# ------------------------------------- satellite: aggregate drain errors
def test_drain_aggregates_all_failures_deterministically():
    ex = TransferExecutor(sequential_io=True)
    try:
        for msg in ("err-c", "err-a", "err-b"):
            ex.submit(0, lambda m=msg: (_ for _ in ()).throw(IOError(m)))
        ex.submit(0, lambda: None)         # a clean task changes nothing
        with pytest.raises(StagingError) as ei:
            ex.drain(timeout=10.0, raise_on_error=True)
        text = str(ei.value)
        assert "3 I/O task(s) failed" in text
        # sorted -> deterministic across thread interleavings
        assert text.index("err-a") < text.index("err-b") < \
            text.index("err-c")
        # failures reported once: a second raising drain is clean
        ex.drain(timeout=10.0, raise_on_error=True)
    finally:
        ex.shutdown()


def test_drain_aggregates_failures_pooled_mode():
    ex = TransferExecutor(sequential_io=False, max_pool_workers=4)
    try:
        for i in range(4):
            ex.submit(0, lambda i=i: (_ for _ in ()).throw(
                IOError(f"pool-err-{i}")))
        with pytest.raises(StagingError, match="4 I/O task"):
            ex.drain(timeout=10.0, raise_on_error=True)
    finally:
        ex.shutdown()


# --------------------------------------------- executor dispatch hook
def test_executor_fault_hook_injects_dispatch_failures():
    ex = TransferExecutor(sequential_io=True)
    try:
        inj = FaultInjector(schedule={"executor": [0]})
        ex.fault_hook = inj.executor_hook
        ran = []
        h1 = ex.submit(0, lambda: ran.append(1))
        assert h1.wait(5.0)
        assert isinstance(h1.error, TransientStoreError)
        assert not ran                     # body never ran: hook fired first
        h2 = ex.submit(0, lambda: ran.append(2))
        assert h2.wait_checked(5.0)
        assert ran == [2]
        assert ex.stats["errors"] == 1
    finally:
        ex.shutdown()


# ------------------------------------------- the same decisions as the JAX
def _decisions(testing, seed):
    """10,000 decisions an operation: rates, a schedule, ``fail_next``,
    ``max_consecutive``, a poisoned stretch and a paused one."""
    inj = testing.FaultInjector(
        seed=seed, rates={"get": 0.3, "put": 0.1, "commit": 0.5,
                          "readahead": 0.25, "executor": 0.05},
        max_consecutive=2 + seed % 3,
        schedule={"put": [3, 4, 5, 900], "delete": [0, 7, 7000]})
    out = {op: [] for op in testing.FAULT_OPS}
    for i in range(10_000):
        if i == 2_000:
            inj.poison(("get", "commit"))
        if i == 2_500:
            inj.heal()
        if i == 4_000:
            inj.fail_next("readahead", n=5)
        for op in testing.FAULT_OPS:
            if 6_000 <= i < 6_300:
                with inj.paused():
                    out[op].append(inj.should_fail(op))
            else:
                out[op].append(inj.should_fail(op))
    return out, dict(inj.stats)


@pytest.mark.parametrize("seed", [0, 77, 1234])
def test_injector_decisions_match_the_jax_injector(seed):
    import repro.testing.faults as jtesting
    import repro_torch.testing.faults as ttesting
    assert ttesting.FAULT_OPS == jtesting.FAULT_OPS
    got, got_stats = _decisions(ttesting, seed)
    want, want_stats = _decisions(jtesting, seed)
    for op in ttesting.FAULT_OPS:
        assert got[op] == want[op], op
        assert any(got[op]) and not all(got[op]), op
    assert got_stats == want_stats


# ------------------------ a crashed store, reopened by either package
def _crash_store(pkg, path):
    """A log store with two acknowledged records and one that is not,
    crashed with 7 bytes torn off its tail (``FaultyBlockStore.crash``)."""
    from repro import storage as js, testing as jt
    from repro_torch import storage as ts, testing as tt
    storage, testing = (js, jt) if pkg == "jax" else (ts, tt)
    store = testing.FaultyBlockStore(
        storage.make_store("log", path), testing.FaultInjector())
    want = {}
    for seed in (1, 2):
        blk = _filled_block(seed=seed, key=(0.0, 10.0))
        store.put(blk.window_key, blk.block_id, blk.host_data, blk.fill)
        want[(blk.window_key, blk.block_id)] = blk
    store.commit()
    lost = _filled_block(seed=3, key=(10.0, 20.0))
    store.put(lost.window_key, lost.block_id, lost.host_data, lost.fill)
    store.crash(torn_tail_bytes=7)
    return want, (lost.window_key, lost.block_id)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_crashed_store_reopens_alike_in_both(tmp_path, writer):
    import shutil
    from repro import storage as js
    from repro_torch import storage as ts
    want, lost = _crash_store(writer, tmp_path / "a")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    reopened = {"jax": js.make_store("log", tmp_path / "a"),
                "torch": ts.make_store("log", tmp_path / "b")}
    try:
        stats = {k: (s.stats["recovery_truncated_bytes"],
                     s.stats["recovered_records"])
                 for k, s in reopened.items()}
        assert stats["jax"] == stats["torch"]
        assert stats["torch"][0] > 0
        for s in reopened.values():
            assert sorted(s.keys()) == sorted(want)
            assert s.get(*lost) is None
            for key, blk in want.items():
                assert s.current_fill(*key) == blk.fill
                got = s.get(*key)
                for k in ("keys", "timestamps", "values"):
                    np.testing.assert_array_equal(
                        got[k][:blk.fill], blk.host_data[k][:blk.fill])
    finally:
        for s in reopened.values():
            s.close()
