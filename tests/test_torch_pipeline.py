"""The port's pipelined engine (``repro_torch.core.pipeline``) against the
JAX package's: the counterparts of ``tests/test_pipeline.py``'s ten cases
on the port, the pipelined engine against the JAX pipelined engine and
the port's synchronous engine (with and without spill), a grid of
``pipelined x prefetch_backend x block_pool`` against the JAX engine and a
numpy oracle on one seeded stock stream, the epoch check on an arena
written in place (a slot recycled between classify and dispatch),
``BackupExecutor`` against the JAX one, and the CPU rehearsal of
``chip_smoke.py`` phases 13 and 13b.

Everything runs on the CPU (``device="cpu"``); rounds are held open with
``threading.Event``s, never with sleeps. Tolerances: the average
operator's window means within 1e-5 absolute (``test_pipeline.py``'s);
the stock grid as ``tests/test_torch_engine.py`` holds it (min, max and
per-key counts exact, means within rtol 1e-5 and atol 1e-5 x max|v|).
"""
import threading

import numpy as np
import pytest

import repro.configs.base as jcfg
import repro.core as jcore
import repro.core.batch_exec as jbx
import repro.core.block_pool as jpool
import repro.core.buckets as jbuckets
import repro.core.cleanup as jcleanup
import repro.core.staging as jstaging
import repro.core.triggers as jtrig
import repro.distributed.fault as jfault
import repro.storage as jstorage
import repro_torch.configs.base as tcfg
import repro_torch.core as tcore
import repro_torch.core.batch_exec as tbx
import repro_torch.core.block_pool as tpool
import repro_torch.core.buckets as tbuckets
import repro_torch.core.cleanup as tcleanup
import repro_torch.core.staging as tstaging
import repro_torch.core.triggers as ttrig
import repro_torch.distributed.fault as tfault
import repro_torch.storage as tstorage
from repro_torch.core.pipeline import EnginePipeline, PipelineError

PKGS = {"jax": (jcfg, jcore, jbx, jcleanup, jtrig),
        "torch": (tcfg, tcore, tbx, tcleanup, ttrig)}
BatchWorkItem = tbx.BatchWorkItem
MEAN_ATOL = 1e-5


def _dev(pkg):
    return {} if pkg == "jax" else {"device": "cpu"}


def _batch(n, width=1, seed=0, lo=0.0, hi=10.0, pkg="torch"):
    rng = np.random.default_rng(seed)
    return PKGS[pkg][1].EventBatch(
        rng.integers(0, 8, n), rng.uniform(lo, hi, n),
        rng.normal(size=(n, width)).astype(np.float32))


def _engine(pipelined, tmp_path=None, pkg="torch", **aion_kw):
    cfg, core = PKGS[pkg][:2]
    aion = cfg.AionConfig(block_size=64, pipelined_execution=pipelined,
                          **aion_kw)
    return core.StreamEngine(
        assigner=core.TumblingWindows(10.0),
        operator=core.make_operator("average", aion.block_size, 1,
                                    **_dev(pkg)),
        aion=aion, value_width=1, spill_dir=tmp_path, **_dev(pkg))


def _barrier(eng):
    """Wait until the engine's pipeline and I/O thread are idle. The JAX
    side of a comparison steps through it: the JAX engine loses events
    that ingest appends while its I/O thread spills or stages the same
    block (ROADMAP Queue 3, item 18), so it is kept from overlapping
    ingest with its I/O to give the reference answer."""
    if eng.pipeline is not None:
        assert eng.pipeline.drain()
    assert eng.io.drain()


def _drive(eng, n_rounds=15, seed=7, pkg="torch"):
    """``tests/test_pipeline.py``'s stream, then a forced final sweep of
    every window: both modes converge to the fold over ALL events."""
    core, bx = PKGS[pkg][1], PKGS[pkg][2]
    rng = np.random.default_rng(seed)
    now = 0.0
    for _ in range(n_rounds):
        n = 150
        ts = rng.uniform(max(now - 12, 0), now + 1, n)
        eng.ingest(core.EventBatch(rng.integers(0, 6, n), ts,
                                   rng.normal(size=(n, 1))
                                   .astype(np.float32)), now)
        eng.advance_watermark(now - 4, now)
        eng.poll(now)
        if pkg == "jax":
            _barrier(eng)
        now += 3.0
    eng.advance_watermark(now + 100, now)
    if eng.pipeline is not None:
        assert eng.pipeline.drain()
    assert eng.io.drain()
    items = [bx.BatchWorkItem(wid=wid, state=st, late=True)
             for wid, st in sorted(eng.windows.items())]
    return {(w.start, w.end): r
            for w, r in eng.batch_exec.execute(items, now).items()}


def _stream_oracle(n_rounds=15, seed=7):
    """The mean of every window's values over the whole ``_drive``
    stream."""
    rng = np.random.default_rng(seed)
    now, ts_all, v_all = 0.0, [], []
    for _ in range(n_rounds):
        n = 150
        ts = rng.uniform(max(now - 12, 0), now + 1, n)
        rng.integers(0, 6, n)
        ts_all.append(ts)
        v_all.append(rng.normal(size=(n, 1)).astype(np.float32)[:, 0])
        now += 3.0
    ts, v = np.concatenate(ts_all), np.concatenate(v_all)
    start = np.floor(ts / 10.0) * 10.0
    return {(s, s + 10.0): float(v[start == s].astype(np.float64).mean())
            for s in np.unique(start)}


def _close(got, want):
    assert set(got) == set(want)
    for wid in want:
        np.testing.assert_allclose(got[wid], want[wid], atol=MEAN_ATOL,
                                   err_msg=str(wid))


# ------------------------------------------- tests/test_pipeline.py's cases
def test_pipelined_matches_sync():
    e_sync = _engine(False)
    e_pipe = _engine(True)
    r_sync = _drive(e_sync)
    r_pipe = _drive(e_pipe)
    _close(r_pipe, r_sync)
    assert e_pipe.metrics.pipeline_rounds > 0
    assert e_pipe.io.stats["errors"] == 0
    e_sync.close()
    e_pipe.close()


def test_pipelined_matches_sync_with_spill(tmp_path):
    e_sync = _engine(False, tmp_path / "sync")
    e_pipe = _engine(True, tmp_path / "pipe")
    r_sync = _drive(e_sync, seed=11)
    r_pipe = _drive(e_pipe, seed=11)
    _close(r_pipe, r_sync)
    e_sync.close()
    e_pipe.close()


@pytest.mark.parametrize("spill", [False, True])
def test_pipelined_matches_jax_pipelined_and_oracle(spill, tmp_path):
    """The port's pipelined engine, the JAX pipelined engine and the
    port's synchronous engine on one stream, each against the numpy
    oracle over all events."""
    got = {}
    for pkg, pipelined in (("torch", True), ("jax", True),
                           ("torch", False)):
        d = tmp_path / f"{pkg}{int(pipelined)}" if spill else None
        eng = _engine(pipelined, d, pkg=pkg)
        got[(pkg, pipelined)] = _drive(eng, seed=11, pkg=pkg)
        if pipelined:
            assert eng.metrics.pipeline_rounds > 0
        eng.close()
    want = _stream_oracle(seed=11)
    _close(got[("torch", True)], got[("jax", True)])
    _close(got[("torch", True)], got[("torch", False)])
    for r in got.values():
        _close(r, want)


def test_pipelined_engine_under_a_short_switch_interval(tmp_path):
    """Ingest, the I/O thread and the fold worker interleaved as finely
    as the interpreter allows (switch interval 1 us), with spill: every
    window still equals the numpy oracle, and every submitted round ran
    (a lost update in the round or in-flight bookkeeping breaks one of
    the two)."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        eng = _engine(True, tmp_path / "pipe")
        got = _drive(eng, seed=11)
        assert eng.pipeline.pending_rounds == 0
        assert eng.pipeline.stats["rounds"] == eng.metrics.pipeline_rounds
        assert not any(eng.pipeline.window_in_flight(w)
                       for w in eng.windows)
        eng.close()
    finally:
        sys.setswitchinterval(old)
    _close(got, _stream_oracle(seed=11))


def _hold(eng, started=None):
    """Wrap ``eng.batch_exec.execute`` so that every round waits for the
    returned event (and sets ``started`` when it begins)."""
    release = threading.Event()
    real = eng.batch_exec.execute

    def held(items, now):
        if started is not None:
            started.set()
        assert release.wait(30.0)
        return real(items, now)
    eng.batch_exec.execute = held
    return release, real


def test_watermark_returns_before_fold_completes():
    eng = _engine(True)
    eng.ingest(_batch(300, seed=1), now=1.0)
    started = threading.Event()
    release, real = _hold(eng, started)
    eng.advance_watermark(20.0, now=2.0)   # closes window [0, 10)
    # the round is on the worker, held open: the caller is back already
    assert started.wait(30.0)
    wid = next(iter(eng.result_futures))
    fut = eng.result_futures[wid]
    assert not fut.done()
    release.set()
    res = fut.result(timeout=30.0)
    assert res is not None
    assert eng.pipeline.drain()
    assert eng.results[wid] == res
    eng.batch_exec.execute = real
    eng.close()


def test_ingest_during_inflight_fold_keeps_rows():
    eng = _engine(True)
    eng.ingest(_batch(200, seed=2), now=1.0)
    release, real = _hold(eng)
    eng.advance_watermark(20.0, now=2.0)
    # ingest more rows for the SAME window while its fold is queued
    eng.ingest(_batch(100, seed=3), now=2.5)
    release.set()
    assert eng.pipeline.drain()
    eng.batch_exec.execute = real
    wid = next(iter(eng.windows))
    st = eng.windows[wid]
    assert st.total_events == 300
    out = eng.batch_exec.execute(
        [BatchWorkItem(wid=wid, state=st, late=True)], 3.0)
    all_vals = np.concatenate([
        _batch(200, seed=2).values[:, 0], _batch(100, seed=3).values[:, 0]])
    np.testing.assert_allclose(out[wid], all_vals.mean(), atol=1e-4)
    eng.close()


def test_round_failure_surfaces_via_futures_and_drain():
    eng = _engine(True, fold_round_retry=False)
    eng.ingest(_batch(100, seed=4), now=1.0)

    def boom(items, now):
        raise IOError("injected fold failure")
    eng.batch_exec.execute = boom
    eng.advance_watermark(20.0, now=2.0)
    wid = next(iter(eng.result_futures))
    with pytest.raises(PipelineError, match="injected fold failure"):
        eng.result_futures[wid].result(timeout=30.0)
    with pytest.raises(PipelineError, match="injected fold failure"):
        eng.pipeline.drain()
    # the error was consumed by the raise; a clean close is now possible
    del eng.batch_exec.execute
    eng.close()


def test_close_raises_on_failed_round():
    eng = _engine(True)
    eng.ingest(_batch(100, seed=5), now=1.0)
    eng.batch_exec.execute = \
        lambda items, now: (_ for _ in ()).throw(RuntimeError("dead fold"))
    eng.advance_watermark(20.0, now=2.0)
    with pytest.raises(PipelineError, match="dead fold"):
        eng.close()
    # the retry ran too, through the backup executor, and failed the same
    assert eng.pipeline.stats["round_retries"] == 1
    assert eng.pipeline.stats["round_retry_wins"] == 0
    del eng.batch_exec.execute
    eng.close()


def test_round_retries_once_and_wins():
    """A round that fails once is retried through the backup executor
    and wins: its future holds the result, the pipeline drains clean."""
    eng = _engine(True)
    assert eng.round_backup is not None
    real = eng.batch_exec.execute
    fails = {"n": 1}

    def flaky(items, now):
        if fails["n"]:
            fails["n"] -= 1
            raise IOError("injected transient fold failure")
        return real(items, now)
    eng.batch_exec.execute = flaky
    eng.ingest(_batch(64, seed=4), now=1.0)
    eng.advance_watermark(10.0, now=2.0)
    assert eng.pipeline.drain(timeout=30.0, raise_on_error=True)
    assert eng.pipeline.stats["round_retries"] == 1
    assert eng.pipeline.stats["round_retry_wins"] == 1
    for fut in eng.result_futures.values():
        assert fut.result(timeout=30.0) is not None
    eng.batch_exec.execute = real
    eng.close()


def test_window_in_flight_guard_bookkeeping():
    pipe = EnginePipeline()
    try:
        eng = _engine(False)               # engine used only as executor
        eng.ingest(_batch(100, seed=6), now=1.0)
        wid = next(iter(eng.windows))
        release, real = _hold(eng)
        items = [BatchWorkItem(wid=wid, state=eng.windows[wid], late=False)]
        futs = pipe.submit(eng, items, 2.0)
        assert pipe.window_in_flight(wid)
        release.set()
        assert futs[wid].result(timeout=30.0) is not None
        assert pipe.drain()
        assert not pipe.window_in_flight(wid)
        eng.batch_exec.execute = real
        eng.close()
    finally:
        pipe.close()


def test_purge_guard_skips_inflight_windows():
    eng = _engine(True)
    eng.ingest(_batch(100, seed=8), now=1.0)
    wid = next(iter(eng.windows))
    release, real = _hold(eng)
    eng.advance_watermark(20.0, now=2.0)
    assert eng.pipeline.window_in_flight(wid)
    # force cleanup to claim the window is purgeable: the guard must win
    eng.cleanup.should_purge = lambda *a, **kw: True
    eng.poll(now=3.0)
    assert wid in eng.windows              # still alive: fold in flight
    release.set()
    assert eng.pipeline.drain()
    eng.batch_exec.execute = real
    eng.close()


def test_epoch_demotion_falls_back_without_corruption():
    eng = _engine(True, pool_slot_epochs=True)
    assert eng.pool is not None
    # two windows: a single-item round takes the per-window path and
    # never reaches the pooled block-table fold
    b = _batch(400, seed=9, lo=0.0, hi=19.9)
    eng.ingest(b, now=1.0)
    assert len(eng.windows) == 2
    real_slot_epochs = eng.pool.slot_epochs

    def stale_epochs(blocks):
        return [(s, e - 1) for s, e in real_slot_epochs(blocks)]
    eng.pool.slot_epochs = stale_epochs
    items = [BatchWorkItem(wid=wid, state=st, late=False)
             for wid, st in sorted(eng.windows.items())]
    out = eng.batch_exec.execute(items, 2.0)
    eng.pool.slot_epochs = real_slot_epochs
    assert eng.metrics.epoch_demoted_rows > 0
    for wid in eng.windows:
        mask = (b.timestamps >= wid.start) & (b.timestamps < wid.end)
        np.testing.assert_allclose(
            out[wid], b.values[mask, 0].mean(), atol=1e-4)
    eng.close()


def test_prefetch_stages_next_round_while_busy(tmp_path):
    eng = _engine(True, tmp_path)
    eng.ingest(_batch(100, seed=10, lo=0.0, hi=9.9), now=1.0)
    eng.ingest(_batch(100, seed=11, lo=10.0, hi=19.9), now=1.0)
    wids = sorted(eng.windows)
    st_b = eng.windows[wids[1]]
    for blk in list(st_b.blocks):
        eng.io.destage_block_sync(blk)
    assert st_b.p_blocks()
    release, real = _hold(eng)
    eng.advance_watermark(10.0, now=2.0)   # round 1: window A (worker busy)
    eng.advance_watermark(20.0, now=2.1)   # round 2: window B -> prefetch
    assert eng.pipeline.stats["prefetched_rounds"] >= 1
    release.set()
    assert eng.pipeline.drain()
    eng.batch_exec.execute = real
    eng.close()


# ------------------------------------------- the epoch check, arena in place
def test_slot_recycled_between_classify_and_dispatch():
    """The port's arena is written in place. Between the unpinned
    classify read and the pinned dispatch, one pooled block is destaged
    and its slot is recommitted with another window's data (a slot
    recycled); a second block's slot is released and recommitted with
    its own data (same slot, new epoch). The pinned validation must
    demote both rows, the fold must not read the foreign data the
    recycled slot now holds, and every result must equal the numpy
    oracle."""
    eng = _engine(True, pool_slot_epochs=True)
    b = _batch(400, seed=12, lo=0.0, hi=19.9)
    eng.ingest(b, now=1.0)
    other = _batch(64, seed=13, lo=30.0, hi=39.9)
    eng.ingest(other, now=1.0)
    pool = eng.pool
    wids = sorted(eng.windows)
    items = [BatchWorkItem(wid=w, state=eng.windows[w], late=False)
             for w in wids[:2]]
    victim = eng.windows[wids[0]].blocks[0]
    same = eng.windows[wids[1]].blocks[0]
    foreign = eng.windows[wids[2]].blocks[0]
    assert None not in (victim.pool_slot, same.pool_slot,
                        foreign.pool_slot)
    real_slot_epochs = pool.slot_epochs
    seen = {}

    def take(slot):
        """Allocate exactly ``slot`` from the free list."""
        held = []
        while True:
            s = pool.alloc()
            assert s is not None
            if s == slot:
                break
            held.append(s)
        for s in held:
            pool.free(s)

    def host_arrays(blk):
        return {k: np.asarray(v)
                for k, v in eng.io.fetch_block_arrays(blk).items()}

    def classify_then_recycle(blocks):
        pairs = real_slot_epochs(blocks)
        if seen:
            return pairs
        slot, s2 = victim.pool_slot, same.pool_slot
        foreign_host, own = host_arrays(foreign), host_arrays(same)
        # the victim leaves the device tier; its slot gets a new occupant
        eng.io.destage_block_sync(victim)
        eng.io.destage_block_sync(foreign)
        take(slot)
        with foreign.lock:
            pool.commit(foreign, slot, foreign_host)
        # the same block back into the same slot: only the epoch moved
        eng.io.destage_block_sync(same)
        take(s2)
        with same.lock:
            pool.commit(same, s2, own)
        seen["recycled"] = (slot, s2)
        return pairs
    pool.slot_epochs = classify_then_recycle
    out = eng.batch_exec.execute(items, 2.0)
    pool.slot_epochs = real_slot_epochs
    slot, s2 = seen["recycled"]
    assert same.pool_slot == s2 and foreign.pool_slot == slot
    # the recycled slot holds the foreign window's keys now: a fold that
    # read it for the victim would fold another window's events
    np.testing.assert_array_equal(
        pool.keys[slot, :foreign.fill].numpy(),
        np.asarray(eng.io.fetch_block_arrays(foreign)["keys"])[
            :foreign.fill])
    assert eng.metrics.epoch_demoted_rows == 2
    assert eng.metrics.fallback_rows >= 2
    for wid in wids[:2]:
        mask = (b.timestamps >= wid.start) & (b.timestamps < wid.end)
        np.testing.assert_allclose(out[wid], b.values[mask, 0].mean(),
                                   atol=1e-5)
    eng.close()


# ------------------------------ ingest against the I/O thread (Queue 3, 18)
def _tail_block(pkg, rng):
    """A window whose one host block holds 36 events, and the 10 more
    that ingest appends to it."""
    buckets, ev = (jbuckets, jcore) if pkg == "jax" else (tbuckets, tcore)

    def batch(n):
        return ev.EventBatch(rng.integers(0, 8, n).astype(np.int32),
                             rng.uniform(0, 10, n),
                             rng.normal(size=(n, 1)).astype(np.float32))
    st = buckets.WindowState(0, 10, width=1, block_capacity=64)
    first, more = batch(36), batch(10)
    st.append_events(first, late=False)
    return st, more, np.concatenate([first.values[:, 0], more.values[:, 0]])


def _spill_interleaved(pkg, tmp_path):
    """Ingest appends to a block while the I/O thread spills it: after
    the spill wrote the block's record and before it dropped the host
    copy (the store's commit is held open on an event)."""
    st, more, want = _tail_block(pkg, np.random.default_rng(5))
    blk = st.blocks[0]
    if pkg == "jax":
        store = jstorage.LogBlockStore(tmp_path / pkg, segment_bytes=1 << 20)
        io = jstaging.IOScheduler(jbuckets.MemoryBudget(1 << 20),
                                  store=store)
    else:
        store = tstorage.LogBlockStore(tmp_path / pkg, segment_bytes=1 << 20)
        io = tstaging.IOScheduler(tbuckets.MemoryBudget(1 << 20),
                                  store=store, device="cpu")
    in_commit, release = threading.Event(), threading.Event()
    commit = store.commit

    def held_commit():
        in_commit.set()
        assert release.wait(30.0)
        return commit()
    store.commit = held_commit
    spill = threading.Thread(target=io.spill_block_sync, args=(blk,))
    spill.start()
    assert in_commit.wait(30.0)
    st.append_events(more, late=True)
    release.set()
    spill.join(30.0)
    assert not spill.is_alive()
    store.commit = commit
    got = np.asarray(blk.as_event_batch().values)[:, 0]
    io.shutdown()
    return blk.fill, got, want


def test_append_during_a_spill_is_kept(tmp_path):
    """The smallest interleaving behind Queue 3, item 18: the port keeps
    the host copy of a block whose record went stale during its spill
    (and spills it again later); the JAX package drops it, and the 10
    appended events read back as the zeros of the 36-event record."""
    fill, got, want = _spill_interleaved("torch", tmp_path)
    assert fill == 46
    np.testing.assert_array_equal(got, want)
    jfill, jgot, _ = _spill_interleaved("jax", tmp_path)
    assert jfill == 46
    np.testing.assert_array_equal(jgot[:36], want[:36])
    assert not jgot[36:].any()                 # the JAX fault: lost


def _stage_interleaved(pkg):
    """Ingest appends to a block while the I/O thread stages it into the
    pool: the append is held on an event once it has decided the block
    is host-resident. The JAX stage commits while it is held; the
    port's stage waits for the append (the block's lock)."""
    st, more, want = _tail_block(pkg, np.random.default_rng(6))
    blk = st.blocks[0]
    if pkg == "jax":
        pool = jpool.DeviceBlockPool(4, 64, 1)
        io = jstaging.IOScheduler(jbuckets.MemoryBudget(1 << 20), pool=pool)
    else:
        pool = tpool.DeviceBlockPool(4, 64, 1, device="cpu")
        io = tstaging.IOScheduler(tbuckets.MemoryBudget(1 << 20),
                                  pool=pool, device="cpu")
    in_append, release = threading.Event(), threading.Event()
    append, errors = blk.append, []

    def held_append(batch, start):
        in_append.set()
        assert release.wait(30.0)
        return append(batch, start)
    blk.append = held_append

    def ingest():
        try:
            st.append_events(more, late=True)
        except AssertionError as exc:
            errors.append(exc)
    a = threading.Thread(target=ingest)
    a.start()
    assert in_append.wait(30.0)
    stage = threading.Thread(target=io.stage_block_sync, args=(blk,))
    stage.start()
    if pkg == "jax":
        stage.join(30.0)                   # nothing holds it back
        assert not stage.is_alive()
    release.set()
    a.join(30.0)
    stage.join(30.0)
    assert not a.is_alive() and not stage.is_alive()
    got = np.asarray(pool.read_block(blk)["values"])[:blk.fill, 0]
    io.shutdown()
    return blk.fill, got, want, errors


def test_append_during_a_stage_is_kept():
    """The same race against a pool fill: on the port the fill copies
    the block after the append, all 46 events; in the JAX package the
    fill copies 36 events and the append then fails inside ingest
    (``Block.append`` asserts a host-resident block)."""
    fill, got, want, errors = _stage_interleaved("torch")
    assert (fill, errors) == (46, [])
    np.testing.assert_array_equal(got, want)
    jfill, jgot, _, jerrors = _stage_interleaved("jax")
    assert jfill == 36 and len(jerrors) == 1   # the JAX fault
    np.testing.assert_array_equal(jgot, want[:36])


# --------------------------------------------- grid against the JAX engine
WINDOW, CAP, WIDTH, KEYS = 10.0, 32, 4, 8
N_EVENTS, CHUNK, MAX_LATE, MAX_VALUE, SEED = 2400, 150, 25.0, 20.0, 4321


def _schedule():
    rng = np.random.default_rng(SEED)
    steps, now, wm = [], 0.0, 0.0
    for _ in range(N_EVENTS // CHUNK):
        u = rng.random(CHUNK)
        delay = np.where(u < 0.65, rng.uniform(0.0, 2.0, CHUNK),
                         rng.uniform(0.0, MAX_LATE, CHUNK))
        ts = np.maximum(now - delay, 0.0)
        keys = rng.integers(0, 3 * KEYS, CHUNK)
        vals = rng.uniform(1.0, MAX_VALUE,
                           (CHUNK, WIDTH)).astype(np.float32)
        adv = None
        if rng.random() < 0.7:
            wm = max(wm, now - rng.uniform(0.0, 5.0))
            adv = wm
        steps.append((now, keys, ts, vals, adv))
        now += rng.uniform(1.0, 4.0)
    return steps, now


STEPS, END = _schedule()


def _stock_engine(pkg, spill_dir, **aion_kw):
    cfg, core, _, cleanup, trig = PKGS[pkg]

    class NoPurge(cleanup.PredictiveCleanup):
        def should_purge(self, window_end, watermark):
            return False

    aion = cfg.AionConfig(block_size=CAP, pool_slots=12,
                          store_segment_bytes=32 << 10, **aion_kw)
    return core.StreamEngine(
        assigner=core.TumblingWindows(WINDOW),
        operator=core.make_operator("stock", CAP, WIDTH, num_keys=KEYS,
                                    **_dev(pkg)),
        aion=aion, value_width=WIDTH,
        cleanup=NoPurge(initial_bound=60.0, min_history=1 << 62),
        trigger=trig.DeltaTTrigger(executions=2),
        device_budget_bytes=1 << 16, host_budget_bytes=1 << 14,
        spill_dir=spill_dir, **_dev(pkg))


def _stock_run(pkg, spill_dir, **aion_kw):
    core, bx = PKGS[pkg][1], PKGS[pkg][2]
    eng = _stock_engine(pkg, spill_dir, **aion_kw)
    for now, keys, ts, vals, adv in STEPS:
        eng.ingest(core.EventBatch(keys, ts, vals), now)
        if adv is not None:
            eng.advance_watermark(adv, now)
        eng.poll(now)
        if pkg == "jax":
            _barrier(eng)
    eng.advance_watermark(END + MAX_LATE, END)
    for t in np.linspace(END, END + 70.0, 6):
        eng.poll(t)
    if eng.pipeline is not None:
        assert eng.pipeline.drain()
    assert eng.io.drain()
    items = [bx.BatchWorkItem(w, eng.windows[w], True)
             for w in sorted(eng.windows)]
    out = eng.batch_exec.execute(items, END + 70.0)
    res = {(w.start, w.end): r for w, r in out.items()}
    m = eng.metrics
    counts = {k: getattr(m, k) for k in (
        "pooled_rows", "fallback_rows", "late_executions",
        "live_executions", "pipeline_rounds", "epoch_demoted_rows")}
    eng.close()
    return res, counts


def _stock_oracle():
    keys = np.concatenate([s[1] for s in STEPS]) % KEYS
    ts = np.concatenate([s[2] for s in STEPS])
    p = np.concatenate([s[3] for s in STEPS])[:, 0].astype(np.float64)
    wstart = np.floor(ts / WINDOW) * WINDOW
    out = {}
    for s in np.unique(wstart):
        sel = wstart == s
        k = keys[sel]
        mn, mx = np.full(KEYS, np.inf), np.full(KEYS, -np.inf)
        sm, ct = np.zeros(KEYS), np.zeros(KEYS)
        np.minimum.at(mn, k, p[sel])
        np.maximum.at(mx, k, p[sel])
        np.add.at(sm, k, p[sel])
        np.add.at(ct, k, 1.0)
        out[(float(s), float(s) + WINDOW)] = {
            "mean": sm / np.maximum(ct, 1.0), "min": mn, "max": mx}
    return out


def _stock_agree(got, want, alerts=True):
    assert set(got) == set(want)
    for wid in want:
        g, w = got[wid], want[wid]
        for k in ("min", "max"):
            np.testing.assert_array_equal(
                np.asarray(g[k], np.float32), np.asarray(w[k], np.float32),
                err_msg=f"{wid} {k}")
        np.testing.assert_allclose(g["mean"], w["mean"], rtol=1e-5,
                                   atol=1e-5 * MAX_VALUE,
                                   err_msg=f"{wid} mean")
        if alerts:
            np.testing.assert_array_equal(g["alerts"], w["alerts"])


@pytest.fixture(scope="module")
def jax_stock(tmp_path_factory):
    return _stock_run("jax", tmp_path_factory.mktemp("jax_stock"))


@pytest.mark.parametrize("block_pool", [True, False])
@pytest.mark.parametrize("backend", ["fixed", "learned"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_grid_against_jax_engine(pipelined, backend, block_pool, jax_stock,
                                 tmp_path):
    want, jcounts = jax_stock
    got, counts = _stock_run("torch", tmp_path, pipelined_execution=pipelined,
                             prefetch_backend=backend, block_pool=block_pool)
    _stock_agree(got, want)
    _stock_agree(got, _stock_oracle(), alerts=False)
    assert counts["late_executions"] > 0
    assert (counts["pipeline_rounds"] > 0) == pipelined
    assert (counts["pooled_rows"] > 0) == block_pool
    assert jcounts["late_executions"] > 0


# ------------------------------------------------------------ BackupExecutor
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_backup_executor_result_straggler_and_failure(pkg):
    """The same three runs through both packages' executors: a task's
    result, a straggling primary whose backup wins (the primary is held
    on an event until the run has returned), and a task that fails on
    both copies. The stats must read the same."""
    fault = jfault if pkg == "jax" else tfault
    ex = fault.BackupExecutor(workers=4, deadline_factor=2.0,
                              min_deadline=0.05)
    try:
        for _ in range(3):
            assert ex.run(lambda: 1) == 1
        release = threading.Event()
        calls = {"n": 0}
        lock = threading.Lock()

        def primary_straggles():
            with lock:
                calls["n"] += 1
                first = calls["n"] == 1
            if first:
                assert release.wait(30.0)
                return "primary"
            return "backup"
        try:
            assert ex.run(primary_straggles) == "backup"
        finally:
            release.set()
        stats = (ex.stats.launched, ex.stats.backups_issued,
                 ex.stats.backup_wins)
        assert stats == (4, 1, 1)
        ex.min_deadline = 30.0

        def always_fails():
            raise IOError("both copies fail")
        with pytest.raises(IOError, match="both copies fail"):
            ex.run(always_fails)
        assert ex.stats.launched == 5
    finally:
        ex.shutdown()


# ----------------------------------------- phases 13 and 13b, CPU rehearsal
def test_chip_smoke_phase_13_rehearsal(tmp_path):
    """Phase 13 at a small rate and width: the pipelined stock deployment
    with learned prefetch, every window held to ``stock_oracle``, and the
    counts it prints."""
    import chip_smoke as cs
    with cs.LaunchRecorder() as recorder:
        rec = cs.run_stream("cpu", windows=4.0, pool_slots=64, splitk=0,
                            seed=cs.SEED + 2, spill_root=tmp_path,
                            rate=400.0, width=8, device_budget=64 << 20,
                            host_budget=1 << 16, pipelined=True,
                            prefetch_backend="learned")
    c = rec["counts"]
    assert c["pipeline_rounds"] > 0
    assert c["pooled_rows"] > 0
    assert c["late_executions"] > 0
    assert rec["pipeline"]["rounds"] == c["pipeline_rounds"]
    # every fold kernel of the run went out from the pipeline's worker
    assert recorder.threads["K2"]
    for key in cs.KERNELS:
        assert set(recorder.threads[key]) <= {"aion-fold-worker"}, key
    assert set(rec["prefetch"]) >= {"sweeps_issued", "windows_considered"}


@pytest.mark.parametrize("retry", [True, False])
def test_chip_smoke_phase_13b_rehearsal(retry, tmp_path):
    """Phase 13b: one demand read fails once. With ``fold_round_retry``
    the round is retried and wins, and every window still meets the
    oracle; without it ``drain()`` raises ``PipelineError``."""
    import chip_smoke as cs
    run = dict(windows=1.0, pool_slots=64, splitk=0, seed=cs.SEED + 13,
               spill_root=tmp_path, rate=400.0, width=8,
               device_budget=64 << 20, host_budget=1 << 16)
    if retry:
        rec = cs.failure_control("cpu", retry=True, **run)
        assert rec["pipeline"]["round_retry_wins"] >= 1
        assert rec["store_failures"] == 1
    else:
        with pytest.raises(PipelineError):
            cs.failure_control("cpu", retry=False, **run)
