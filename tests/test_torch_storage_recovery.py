"""Engine crash recovery over the log store on the port:
``tests/test_storage_recovery.py``'s cases through ``repro_torch`` on the
CPU (the SIGKILL matrix after an acknowledged commit and mid-segment, to
oracle parity; a manifest against a store that lost the record; npz
checkpoints that never write manifests; the compaction bound under a
purge soak), and a manifest checkpoint whose partial block grows after
it (ROADMAP Queue 3, item 20): the JAX package cannot restore it, the
port does.
"""
import numpy as np
import pytest

from repro_torch.configs.base import AionConfig
from repro_torch.core import StreamEngine, TumblingWindows
from repro_torch.core.batch_exec import BatchWorkItem
from repro_torch.core.cleanup import PredictiveCleanup
from repro_torch.core.events import EventBatch
from repro_torch.core.operators import make_operator
from repro_torch.core.triggers import DeltaTTrigger
from repro_torch.core.windows import WindowId

WINDOW = 10.0
N_EVENTS = 12_000
CHUNK = 500
MAX_LATE = 25.0
SEED = 77


class _NoPurgeCleanup(PredictiveCleanup):
    def should_purge(self, window_end, watermark):
        return False


def _make_engine(spill_dir, purge_bound=None,
                 host_budget=1 << 19) -> StreamEngine:
    aion = AionConfig(block_size=256, store_backend="log",
                      store_segment_bytes=32 << 10)
    cleanup = (_NoPurgeCleanup(initial_bound=60.0, min_history=1 << 62)
               if purge_bound is None else
               PredictiveCleanup(initial_bound=purge_bound,
                                 min_history=1 << 62))
    return StreamEngine(
        assigner=TumblingWindows(WINDOW),
        operator=make_operator("average", aion.block_size, 1,
                               device="cpu"),
        aion=aion, value_width=1, device="cpu",
        cleanup=cleanup,
        trigger=DeltaTTrigger(executions=2),
        device_budget_bytes=1 << 20,
        host_budget_bytes=host_budget,      # sustained spill pressure
        spill_dir=spill_dir,
    )


def _sigkill(eng: StreamEngine) -> None:
    """SIGKILL-style stop: stop the executor thread and drop the store's
    file handles WITHOUT the final group commit a clean close performs —
    anything unacknowledged must behave as lost."""
    io = eng.io
    io.executor.shutdown()             # stop + join, no drain, no commit
    store = io.store
    if store._active_f is not None:
        store._active_f.close()
        store._active_f = None
    if store._wal_f is not None:
        store._wal_f.close()
        store._wal_f = None


def _batches(rng, width=1):
    now, wm, emitted = 0.0, 0.0, 0
    while emitted < N_EVENTS:
        n = min(CHUNK, N_EVENTS - emitted)
        u = rng.random(n)
        delay = np.where(
            u < 0.6, rng.uniform(0.0, 2.0, n),
            rng.uniform(0.0, MAX_LATE, n))
        ts = np.maximum(now - delay, 0.0)
        batch = EventBatch(rng.integers(0, 8, n), ts,
                           rng.normal(size=(n, width)).astype(np.float32))
        emitted += n
        advance = rng.random() < 0.7
        wm = max(wm, now - rng.uniform(0.0, 5.0)) if advance else wm
        yield batch, now, (wm if advance else None)
        now += rng.uniform(1.0, 4.0)


def _oracle_average(keys, ts, vals):
    wstart = np.floor(ts / WINDOW) * WINDOW
    out = {}
    for s in np.unique(wstart):
        sel = wstart == s
        out[WindowId(float(s), float(s) + WINDOW)] = \
            float(np.mean(vals[sel, 0], dtype=np.float64))
    return out


def _final_sweep(eng, now):
    eng.io.drain()
    items = [BatchWorkItem(wid, eng.windows[wid], True)
             for wid in sorted(eng.windows)]
    if eng.batching_enabled and len(items) > 1:
        eng.batch_exec.execute(items, now)
    else:
        for it in items:
            eng.execute_window(it.wid, now, late=True)


@pytest.mark.parametrize("injection", ["after_commit", "mid_segment"])
def test_crash_recovery_to_oracle_parity(tmp_path, injection):
    rng = np.random.default_rng(SEED)
    eng = _make_engine(tmp_path)
    all_events = []
    feed = _batches(rng)
    crashed = False
    snap = None
    last_now = 0.0
    for i, (batch, now, wm) in enumerate(feed):
        all_events.append((batch.keys.copy(), batch.timestamps.copy(),
                           batch.values.copy()))
        eng.ingest(batch, now)
        if wm is not None:
            eng.advance_watermark(wm, now)
        eng.poll(now)
        last_now = now

        if not crashed and (i + 1) * CHUNK >= N_EVENTS // 2:
            crashed = True
            eng.io.drain()
            # manifest checkpoint: spilled blocks reference the value
            # log instead of carrying inline arrays
            snap = eng.checkpoint_state(include_stored_data=False)
            stored_refs = sum(
                1 for w in snap["windows"] for b in w["blocks"]
                if b.get("stored"))
            assert stored_refs > 0, \
                "checkpoint exercised no store-backed manifests"
            if injection == "mid_segment":
                # a spill dying mid-write: an unacknowledged record plus
                # a torn tail past the last WAL ack
                store = eng.io.store
                junk = {
                    "keys": np.arange(256, dtype=np.int32),
                    "timestamps": np.zeros(256, np.float64),
                    "values": np.ones((256, 1), np.float32),
                }
                store.put((999.0, 1009.0), 999_999, junk, 256)  # unacked
                with open(store.active_segment_path(), "ab") as f:
                    f.write(b"\xba\xad" * 33)                   # torn
            _sigkill(eng)

            eng = _make_engine(tmp_path)          # store reopens + WAL
            if injection == "mid_segment":
                assert eng.io.store.stats["recovery_truncated_bytes"] > 0
                assert eng.io.store.current_fill((999.0, 1009.0),
                                                 999_999) is None
            # restore pulls manifest blocks from the recovered log;
            # a lost acknowledged record would raise KeyError here
            eng.restore_state(snap)

    assert crashed and snap is not None
    wm = last_now + MAX_LATE
    eng.advance_watermark(wm, last_now)
    for t in np.linspace(last_now, last_now + 70.0, 6):
        eng.poll(t)
    _final_sweep(eng, last_now + 70.0)
    results = dict(eng.results)
    eng.close()

    keys = np.concatenate([k for k, _, _ in all_events])
    tss = np.concatenate([t for _, t, _ in all_events])
    vals = np.concatenate([v for _, _, v in all_events])
    want = _oracle_average(keys, tss, vals)
    assert set(results) == set(want)
    for wid in want:
        assert results[wid] == pytest.approx(want[wid], rel=2e-4,
                                             abs=2e-4), wid


def test_restore_rejects_missing_store_record(tmp_path):
    """A manifest checkpoint against a store that lost the record (here:
    a fresh directory) must fail loudly, not silently drop data."""
    eng = _make_engine(tmp_path / "a", host_budget=8 << 10)
    rng = np.random.default_rng(3)
    batch = EventBatch(rng.integers(0, 8, 3000),
                       rng.uniform(0.0, 10.0, 3000),
                       rng.normal(size=(3000, 1)).astype(np.float32))
    eng.ingest(batch, now=0.0)
    eng.advance_watermark(10.0, 10.0)
    eng.poll(10.0)
    eng.io.drain()
    snap = eng.checkpoint_state(include_stored_data=False)
    assert any(b.get("stored") for w in snap["windows"]
               for b in w["blocks"])
    eng.close()
    eng2 = _make_engine(tmp_path / "fresh")
    with pytest.raises(KeyError):
        eng2.restore_state(snap)
    eng2.close()


def test_npz_checkpoints_never_write_manifests(tmp_path):
    """The npz fallback loses fill/window metadata across a reopen, so
    manifest checkpoints must inline its blocks (regression: a stored
    reference against a reopened npz store was unrestorable)."""
    aion = AionConfig(block_size=256, store_backend="npz")
    eng = StreamEngine(
        assigner=TumblingWindows(WINDOW),
        operator=make_operator("average", aion.block_size, 1,
                               device="cpu"),
        aion=aion, value_width=1, device="cpu",
        cleanup=_NoPurgeCleanup(initial_bound=60.0, min_history=1 << 62),
        trigger=DeltaTTrigger(executions=2),
        device_budget_bytes=1 << 20, host_budget_bytes=8 << 10,
        spill_dir=tmp_path)
    rng = np.random.default_rng(9)
    batch = EventBatch(rng.integers(0, 8, 3000),
                       rng.uniform(0.0, 10.0, 3000),
                       rng.normal(size=(3000, 1)).astype(np.float32))
    eng.ingest(batch, now=0.0)
    eng.advance_watermark(10.0, 10.0)
    eng.poll(10.0)
    eng.io.drain()
    snap = eng.checkpoint_state(include_stored_data=False)
    blocks = [b for w in snap["windows"] for b in w["blocks"]]
    assert blocks and not any(b.get("stored") for b in blocks)
    assert all(b["data"] for b in blocks)    # everything inlined
    eng.close()


def test_compaction_bound_holds_under_purge_soak(tmp_path):
    """Predictive-cleanup purges emit tombstones; the engine's
    compaction requests keep on-disk bytes <= 2 x live record bytes
    (+ active-segment headroom) — the paper's §3.4 bounded-storage
    claim, previously untested."""
    # tiny host budget: everything spills into the log; a 12 s purge
    # bound: most expired windows purge during the run, so the log keeps
    # accumulating tombstones the compactor must consume to stay bounded
    eng = _make_engine(tmp_path, purge_bound=12.0, host_budget=16 << 10)
    rng = np.random.default_rng(11)
    for batch, now, wm in _batches(rng):
        eng.ingest(batch, now)
        if wm is not None:
            eng.advance_watermark(wm, now)
        eng.poll(now)
    eng.io.drain()
    store = eng.io.store
    assert eng.metrics.purged_windows > 0
    assert store.stats["deletes"] > 0            # purge -> tombstones
    assert store.stats["bytes_compacted"] > 0    # compaction consumed
    store.commit()
    store.compact_if_needed(2.0)                 # settle the tail
    disk = store.on_disk_bytes()
    live = store.live_record_bytes()
    assert disk <= max(2 * live, store.segment_bytes) \
        + store.segment_bytes, (disk, live)
    eng.close()


def test_partial_block_growing_after_a_manifest_checkpoint(tmp_path):
    """A partial block spilled, read back to the host and referenced by a
    manifest checkpoint, then appended to and spilled again: its record
    now holds the longer fill. The JAX package's restore raises
    ``KeyError`` on the checkpoint's reference to the shorter one; the
    port restores the record's first events inline (blocks are
    append-only), exactly the checkpoint's, and reconciles the longer
    record away."""
    import repro.configs.base as jcfg
    import repro.core as jcore
    import repro_torch.configs.base as tcfg
    import repro_torch.core as tcore

    def run(cfg, core, path, dev):
        def make():
            return core.StreamEngine(
                assigner=core.TumblingWindows(WINDOW),
                operator=core.make_operator("average", 64, 1, **dev),
                aion=cfg.AionConfig(block_size=64, store_backend="log"),
                value_width=1, device_budget_bytes=1, spill_dir=path,
                **dev)
        rng = np.random.default_rng(5)

        def batch(n):
            return core.EventBatch(rng.integers(0, 8, n),
                                   rng.uniform(0.0, WINDOW, n),
                                   rng.normal(size=(n, 1))
                                   .astype(np.float32))
        eng = make()
        first = batch(20)
        eng.ingest(first, now=1.0)
        (st,) = eng.windows.values()
        (blk,) = st.blocks
        eng.io.spill_blocks_sync([blk])
        blk.as_event_batch()                 # back on the host
        assert blk.in_storage and blk.fill == 20
        snap = eng.checkpoint_state(include_stored_data=False)
        eng.ingest(batch(30), now=2.0)       # appended to the same block
        assert blk.fill == 50
        eng.io.spill_blocks_sync([blk])
        assert eng.io.store.current_fill(blk.window_key,
                                         blk.block_id) == 50
        _sigkill(eng)
        eng = make()
        try:
            eng.restore_state(snap)
        except KeyError:
            eng.close()
            return None
        assert eng.io.store.get(blk.window_key, blk.block_id) is None
        eng.advance_watermark(WINDOW, now=3.0)
        (got,) = eng.results.values()
        eng.close()
        return got, float(first.values[:, 0].astype(np.float64).mean())

    assert run(jcfg, jcore, tmp_path / "jax", {}) is None
    got, want = run(tcfg, tcore, tmp_path / "torch", {"device": "cpu"})
    assert got == pytest.approx(want, rel=2e-4, abs=2e-4)
