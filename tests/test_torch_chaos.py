"""The chaos soaks on the port: ``tests/test_soak_differential.py``'s
``test_soak_differential_chaos_faults[True/False]`` and
``test_soak_differential_chaos_restart`` through ``repro_torch`` on the
CPU, on the same seeds, fault rates, budgets and oracle tolerances, and
the CPU rehearsals of ``chip_smoke.py`` phases 15 (the stock deployment
over a store failing a quarter of its calls) and 16 (crash and recovery)
through ``chip_smoke.run_stream`` and ``chip_smoke.crash_recovery`` at a
small rate and width, with the pool's books and the dead engine's arena
checked as on the card (on the CPU the arena's release is read as the
pool's tensors becoming unreachable).
"""

import numpy as np
import pytest

from test_torch_soak import (
    CHAOS_OPS, MAX_LATE, N_EVENTS, SEED, WINDOW, cleanup, drive,
    final_sweep, hold_average, oracle_average, package,
)
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


@pytest.mark.parametrize("pipelined", [True, False])
def test_soak_differential_chaos_faults(tmp_path, pipelined):
    """A quarter of the store's get/put/commit/readahead calls fail: the
    retries absorb every one (``max_consecutive=2`` below the retry
    limit), the ladder sheds readahead first and moves one rung at a
    time, and every window meets the oracle.

    The stream steps with the engine's I/O thread idle (``step_barrier``):
    how many store calls the I/O thread makes, and so how many faults
    are injected, follows its pace against the driving loop, which the
    machine's load sets
    (``test_chaos_fault_count_follows_the_io_threads_pace``)."""
    results, events, totals = drive(
        "average", True, False, tmp_path, pooled=True,
        pipelined=pipelined, fault_rate=0.25, fault_seed=77,
        step_barrier=True)
    hold_average(results, oracle_average(events))
    assert totals.ingested == N_EVENTS
    assert totals.injected_faults > 100
    assert totals.io_retries > 0
    assert totals.io_gave_up == 0
    assert totals.io_staged_blocks > 0
    assert totals.ladder_transitions, "breaker never engaged"
    assert totals.ladder_transitions[0] == (0, 1)
    for frm, to in totals.ladder_transitions:
        assert abs(to - frm) == 1
    assert totals.shed_readahead_drives > 0
    assert totals.deferred_events == totals.readmitted_events


def test_chaos_fault_count_follows_the_io_threads_pace(tmp_path,
                                                       monkeypatch):
    """Why the chaos rows step with the I/O thread idle: slowed by 2 ms a
    store call, an I/O thread that the loop does not wait for makes so few
    calls that fewer than 100 faults are injected (the rows' own floor)
    and the breaker barely moves; stepping with it idle, the same slowed
    thread injects as many as the rows inject at full speed."""
    import test_torch_soak as T
    real = T.make_engine

    def slowed(*a, **kw):
        eng = real(*a, **kw)
        eng._fault_injector.latency = 2e-3
        return eng

    monkeypatch.setattr(T, "make_engine", slowed)
    counts = {}
    for barrier in (False, True):
        _, _, totals = drive("average", True, False, tmp_path / str(barrier),
                             pooled=True, pipelined=True, fault_rate=0.25,
                             fault_seed=77, step_barrier=barrier)
        counts[barrier] = totals.injected_faults
    assert counts[False] < 100 < counts[True], counts


def test_soak_differential_chaos_restart(tmp_path):
    """A permanent store failure poisons the engine mid-run;
    ``EngineRecovery`` restores the last manifest checkpoint into a fresh
    engine over the reopened store, the ledger replays the events after
    it, and every window meets the oracle."""
    p = package("torch")
    from repro_torch.core import PipelineError, StagingError, Tier

    store_dir = tmp_path / "chaos"
    inj = p.testing.FaultInjector(seed=5,
                                  rates={op: 0.05 for op in CHAOS_OPS},
                                  max_consecutive=2)

    def factory():
        inner = p.storage.make_store("log", store_dir,
                                     segment_bytes=128 << 10)
        aion = p.AionConfig(block_size=256, batched_execution=True,
                            block_pool=True, pipelined_execution=True,
                            store_segment_bytes=128 << 10,
                            io_retry_backoff=0.0,
                            breaker_error_threshold=4)
        eng = p.core.StreamEngine(
            assigner=p.core.TumblingWindows(WINDOW),
            operator=p.core.make_operator("average", aion.block_size, 1,
                                          **p.dev),
            aion=aion, value_width=1, cleanup=cleanup(p),
            trigger=p.DeltaTTrigger(executions=2),
            device_budget_bytes=1 << 16, host_budget_bytes=1 << 15,
            spill_dir=store_dir,
            store=p.testing.FaultyBlockStore(inner, inj), **p.dev)
        eng._fault_injector = inj
        return eng

    recovery = p.EngineRecovery(factory, max_restarts=3)
    rng = np.random.default_rng(SEED)
    eng = factory()
    n_events, chunk = 6000, 500
    ledger, all_events = [], []
    now, wm, emitted, chunks = 0.0, 0.0, 0, 0
    crashed = False

    def emit_chunk():
        nonlocal now, wm, emitted, chunks
        n = min(chunk, n_events - emitted)
        u = rng.random(n)
        delay = np.where(u < 0.65, rng.uniform(0.0, 2.0, n),
                         rng.uniform(0.0, MAX_LATE, n))
        ts = np.maximum(now - delay, 0.0)
        batch = p.core.EventBatch(rng.integers(0, 8, n), ts,
                                  rng.normal(size=(n, 1))
                                  .astype(np.float32))
        all_events.append((batch.keys.copy(), batch.timestamps.copy(),
                           batch.values.copy()))
        ledger.append((emitted, batch, now))
        eng.ingest(batch, now)
        emitted += n
        chunks += 1
        if rng.random() < 0.7:
            wm = max(wm, now - rng.uniform(0.0, 5.0))
            eng.advance_watermark(wm, now)
        eng.poll(now)
        now += rng.uniform(1.0, 4.0)

    while emitted < n_events:
        emit_chunk()
        if chunks % 3 == 0:
            with inj.paused():
                recovery.checkpoint(eng, token=(emitted, now, wm))
        if not crashed and emitted >= n_events // 2:
            crashed = True
            with inj.paused():
                if eng.pipeline is not None:
                    eng.pipeline.drain()
                eng.io.drain()
                for st in eng.windows.values():
                    for blk in list(st.blocks):
                        if blk.tier == Tier.DEVICE:
                            eng.io.destage_block_sync(blk)
                eng.io.spill_blocks_sync(
                    [b for st in eng.windows.values() for b in st.blocks
                     if b.tier == Tier.HOST and b.fill > 0])
            inj.poison(("get",))
            with pytest.raises((PipelineError, StagingError)):
                eng.advance_watermark(now + MAX_LATE, now)
                eng.poll(now)
                eng.close()
            inj.heal()
            eng.pipeline.close()
            eng.io.drain(timeout=30.0)
            eng.io.shutdown()
            with inj.paused():
                eng, (ck_emitted, ck_now, ck_wm) = recovery.restore()
            now, wm = max(now, ck_now), ck_wm
            for start, batch, _ in ledger:
                if start >= ck_emitted:
                    eng.ingest(batch, now)
            eng.poll(now)

    assert crashed and recovery.restarts == 1
    wm = now + MAX_LATE
    eng.advance_watermark(wm, now)
    for t in np.linspace(now, now + 70.0, 8):
        eng.poll(t)
    final_sweep(p, eng, now + 70.0)
    results = {(w.start, w.end): r for w, r in eng.results.items()}
    assert eng.io.stats["gave_up"] == 0
    assert eng.metrics.ingested > 0
    eng.close()
    events = tuple(np.concatenate([e[i] for e in all_events])
                   for i in range(3))
    hold_average(results, oracle_average(events))


# ------------------------------------------ phases 15 and 16, CPU rehearsal
def _run(tmp_path, **kw):
    import chip_smoke as cs
    return dict(windows=3.0, pool_slots=64, splitk=0, seed=cs.SEED + 2,
                spill_root=tmp_path, rate=400.0, width=8,
                device_budget=64 << 20, host_budget=1 << 16, **kw)


@pytest.mark.parametrize("pipelined", [False, True])
def test_chip_smoke_phase_15_rehearsal(tmp_path, pipelined):
    """Phase 15 at a small rate and width: the stock deployment over a
    store failing a quarter of its calls, every window held to
    ``stock_oracle``, and every check the phase takes (``chaos_checks``:
    no event lost, no retry given up, the ladder's order, the pool's
    books)."""
    import chip_smoke as cs
    with cs.LaunchRecorder() as recorder:
        rec = cs.chaos_stream("cpu", pipelined=pipelined, **_run(tmp_path))
    cs.chaos_checks("15", rec, recorder)
    assert rec["books"]["slots"] == 64
    assert rec["injected"]["injected"] == sum(
        rec["injected"].get(op, 0) for op in cs.CHAOS_OPS)
    assert bool(rec["pipeline"]) is pipelined


def test_chip_smoke_phase_16_rehearsal(tmp_path):
    """Phase 16 at a small rate and width: checkpoints every 10 s, the
    poisoned engine raises, the store crashes with a torn tail, the dead
    engine's arena is unreachable (its tensors' weak references are dead:
    the CPU's reading of the memory check), the restore and the replay,
    and every window held."""
    import chip_smoke as cs
    with cs.LaunchRecorder() as recorder:
        rec = cs.crash_recovery("cpu", **_run(tmp_path))
    cs.recovery_checks("16", rec, recorder)
    d = rec["drill"]
    assert d["replayed_events"] > 0 and d["checkpoints"] >= 4
    assert d["memory_before"] is None       # no card: no device reading
    assert rec["io_final"]["gave_up"] == 0


def test_chip_smoke_phase_16_rejects_a_kept_engine(tmp_path):
    """The control of phase 16's memory check: a caller that keeps the
    dead engine keeps its arena, and the drill refuses to restore."""
    import chip_smoke as cs
    kept = []
    with pytest.raises(cs.SmokeFailure, match="still reachable"):
        cs.crash_recovery("cpu", on_engine=kept.append, **_run(tmp_path))
    assert len(kept) == 1
    kept[0].close()
