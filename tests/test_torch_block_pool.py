"""The port's device block pool against the cases of
``tests/test_block_pool.py``: slot lifecycle, exhaustion, exactly-once
frees, epochs, deferred fills, and the pin contract, which the port keeps
with a quarantine instead of JAX's copy-on-write arena (a slot released
while a snapshot is pinned is not reused until the last pin ends).
Engine-level pooled-vs-JAX parity closes the file. Everything runs on
the CPU here (``device="cpu"``); exact comparisons unless stated."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import AionConfig
from repro_torch.core import StreamEngine, TumblingWindows
from repro_torch.core.block_pool import DeviceBlockPool
from repro_torch.core.buckets import Block, MemoryBudget, Tier
from repro_torch.core.events import EventBatch
from repro_torch.core.operators import make_operator
from repro_torch.core.staging import IOScheduler
from repro_torch.core.triggers import DeltaTTrigger

CAP, W = 16, 1
CPU = "cpu"


def _block(key_val=1, fill=CAP):
    b = Block.new(CAP, W)
    b.host_data["keys"][:] = key_val
    b.host_data["values"][:] = float(key_val)
    b.fill = fill
    return b


def _pool(slots, **kw):
    return DeviceBlockPool(slots, CAP, W, device=CPU, **kw)


def _commit(pool, blk):
    slot = pool.alloc()
    with blk.lock:
        pool.commit(blk, slot, blk.host_data)
    return slot


def test_alloc_free_cycle_and_exhaustion():
    pool = _pool(4)
    slots = [pool.alloc() for _ in range(4)]
    assert sorted(slots) == [0, 1, 2, 3]
    assert pool.alloc() is None
    assert pool.stats["exhausted"] == 1
    pool.free(slots[0])
    assert pool.alloc() == slots[0]


def test_sharded_ranges_no_cross_shard_stealing():
    pool = _pool(8, num_shards=4)
    assert pool.slots_per_shard == 2
    a, b = pool.alloc(shard=1), pool.alloc(shard=1)
    assert {pool.shard_of_slot(a), pool.shard_of_slot(b)} == {1}
    assert pool.alloc(shard=1) is None
    assert pool.alloc(shard=2) is not None


def test_commit_read_roundtrip_is_a_copy():
    pool = _pool(4)
    blk = _block(7)
    slot = _commit(pool, blk)
    assert blk.pool_slot == slot and blk.pool is pool
    d = pool.read_block(blk)
    np.testing.assert_array_equal(d["keys"].numpy(), blk.host_data["keys"])
    np.testing.assert_array_equal(d["values"].numpy(),
                                  blk.host_data["values"])
    pool.release_slot(blk)
    _commit(pool, _block(9))                   # slot reused, rewritten
    assert int(d["keys"][0]) == 7              # the read never changes


def test_released_slot_quarantined_while_pinned():
    """A pinned snapshot's slots keep their data until the pin ends: a
    release during the pin quarantines the slot (no reuse, no rewrite),
    and it returns to the free list when the last pin drops."""
    pool = _pool(1)
    a = _block(1)
    slot = _commit(pool, a)
    with pool.pinned():
        k_arena, _, slots = pool.snapshot_for([a])
        assert slots == [slot]
        pool.release_slot(a)
        assert pool.alloc() is None            # quarantined, not reusable
        assert pool.stats["quarantined"] == 1
        assert int(k_arena[slot][0]) == 1      # the snapshot still holds a
        with pool.pinned():
            pass                               # an inner pin changes nothing
        assert pool.free_slots() == 0
    assert pool.free_slots() == 1
    b = _block(9)
    assert _commit(pool, b) == slot
    assert int(pool.keys[slot][0]) == 9


def test_unpinned_writes_update_in_place():
    pool = _pool(2)
    arena = pool.values
    for blk in (_block(3), _block(5)):
        _commit(pool, blk)
        np.testing.assert_array_equal(pool.read_block(blk)["keys"].numpy(),
                                      blk.host_data["keys"])
    assert pool.values is arena                 # the same tensor, updated
    assert pool.stats["quarantined"] == 0


def test_deferred_fills_batch_into_one_write():
    pool = _pool(8)
    blocks = [_block(i + 1) for i in range(4)]
    with pool.pinned(), pool.deferred_fills():
        for blk in blocks:
            _commit(pool, blk)
        assert pool.stats["deferred_fills"] == 4
        assert pool.stats["batched_fill_commits"] == 0
        d = pool.read_block(blocks[0])          # reads flush first
        np.testing.assert_array_equal(d["keys"].numpy(),
                                      blocks[0].host_data["keys"])
        assert pool.stats["batched_fill_commits"] == 1
    for blk in blocks:
        np.testing.assert_array_equal(pool.read_block(blk)["keys"].numpy(),
                                      blk.host_data["keys"])
    assert pool.stats["batched_fill_commits"] == 1


def test_deferred_fill_dropped_when_slot_released():
    pool = _pool(1)
    a, b = _block(3), _block(9)
    with pool.deferred_fills():
        slot = _commit(pool, a)
        pool.release_slot(a)                    # purge wins the race
        assert _commit(pool, b) == slot
    np.testing.assert_array_equal(pool.read_block(b)["keys"].numpy(),
                                  b.host_data["keys"])


def test_slot_epochs_move_on_release_and_commit():
    pool = _pool(2)
    a = _block(1)
    _commit(pool, a)
    (s0, e0), = pool.slot_epochs([a])
    with pool.pinned():
        _, _, slots, epochs = pool.snapshot_with_epochs([a])
    assert (slots[0], epochs[0]) == (s0, e0)
    pool.release_slot(a)
    assert pool.slot_epochs([a]) == [(None, -1)]
    b = _block(2)
    assert _commit(pool, b) != s0 or pool.slot_epochs([b])[0][1] > e0


def test_purge_while_pooled_frees_slot_exactly_once():
    pool = _pool(4)
    blk = _block()
    _commit(pool, blk)
    blk.tier = Tier.DEVICE
    assert pool.free_slots() == 3
    blk.drop()
    assert pool.free_slots() == 4 and blk.pool_slot is None
    blk.drop()
    assert pool.free_slots() == 4
    assert pool.stats["frees"] == 1


def test_destage_then_purge_single_free():
    budget = MemoryBudget(1 << 20)
    pool = _pool(4)
    io = IOScheduler(budget, pool=pool)
    blk = _block()
    assert io.stage_block_sync(blk)
    assert blk.pool_slot is not None and blk.tier == Tier.DEVICE
    assert io.stats["pool_fills"] == 1
    io.destage_block_sync(blk)
    assert blk.pool_slot is None and blk.tier == Tier.HOST
    assert pool.free_slots() == 4
    blk.drop()
    assert pool.free_slots() == 4 and pool.stats["frees"] == 1
    io.shutdown()


def test_stage_racing_drop_releases_own_slot_and_budget():
    budget = MemoryBudget(1 << 20)
    pool = _pool(4)
    io = IOScheduler(budget, pool=pool)
    blk = _block()
    blk.dropped = True
    assert io.stage_block_sync(blk) is False
    assert pool.free_slots() == 4 and budget.used_bytes == 0
    io.shutdown()


def test_arena_cap_never_exceeded_by_shard_rounding():
    row = CAP * (4 + 4 * W)
    p = _pool(256, num_shards=8, max_arena_bytes=20 * row)
    assert p.pool_slots == 16 and p.arena_bytes <= 20 * row
    assert _pool(256, num_shards=8, max_arena_bytes=5 * row).pool_slots == 0


def test_concurrent_duplicate_stage_leaks_no_slot():
    import threading
    budget = MemoryBudget(1 << 20)
    pool = _pool(8)
    io = IOScheduler(budget, pool=pool)
    for _ in range(10):
        blk = _block()
        ts = [threading.Thread(target=io.stage_block_sync, args=(blk,))
              for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
        assert blk.tier == Tier.DEVICE and blk.pool_slot is not None
        io.destage_block_sync(blk)
    assert pool.free_slots() == 8 and budget.used_bytes == 0
    io.shutdown()


def test_pool_exhaustion_falls_back_to_per_block_copy():
    budget = MemoryBudget(1 << 20)
    pool = _pool(1)
    io = IOScheduler(budget, pool=pool)
    b1, b2 = _block(1), _block(2)
    assert io.stage_block_sync(b1) and b1.pool_slot is not None
    assert io.stage_block_sync(b2)
    assert b2.pool_slot is None and b2.device_data is not None
    assert isinstance(b2.device_data["keys"], torch.Tensor)
    assert io.stats["pool_fallbacks"] == 1
    for b in (b1, b2):
        d = io.fetch_block_arrays(b)
        np.testing.assert_array_equal(np.asarray(d["keys"]),
                                      b.host_data["keys"])
    io.destage_block_sync(b2)                   # device copy -> host
    assert b2.tier == Tier.HOST
    io.shutdown()


def test_pool_defaults_to_the_card():
    if torch.cuda.is_available():
        assert DeviceBlockPool(2, CAP, W).values.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceBlockPool(2, CAP, W)


# ------------------------------------------------------------ engine level
def _run(pkg, pooled, pool_slots=256, overlap=True, budget=64 << 20):
    if pkg == "jax":
        from repro.configs.base import AionConfig as A
        from repro.core import StreamEngine as E, TumblingWindows as T
        from repro.core.events import EventBatch as EB
        from repro.core.operators import make_operator as mk
        from repro.core.triggers import DeltaTTrigger as D
        op, dev = mk("stock", 64, 1, num_keys=8), {}
    else:
        A, E, T, EB, D = (AionConfig, StreamEngine, TumblingWindows,
                          EventBatch, DeltaTTrigger)
        op = make_operator("stock", 64, 1, num_keys=8, device=CPU)
        dev = {"device": CPU}
    aion = A(block_size=64, block_pool=pooled, pool_slots=pool_slots,
             pool_overlap_prefetch=overlap)
    eng = E(assigner=T(10.0), operator=op, aion=aion, value_width=1,
            device_budget_bytes=budget, trigger=D(executions=2), **dev)
    rng = np.random.default_rng(3)
    n = 2500
    eng.ingest(EB(rng.integers(0, 8, n), rng.uniform(0, 80.0, n),
                  rng.normal(size=(n, 1)).astype(np.float32)), now=0.0)
    eng.advance_watermark(80.0, now=80.0)
    eng.ingest(EB(rng.integers(0, 8, 600), rng.uniform(0, 70.0, 600),
                  rng.normal(size=(600, 1)).astype(np.float32)), now=81.0)
    for t in np.linspace(81, 81 + 2 * eng.cleanup.current_bound(), 10):
        eng.poll(t)
    results = {(w.start, w.end): r for w, r in eng.results.items()}
    m = eng.metrics
    counts = (m.pooled_rows, m.fallback_rows, m.demand_pool_fills)
    eng.close()
    return results, counts


def _assert_results_equal(got, want):
    """Stock results: min/max exact, means within the summation-order
    tolerance (|v| < 5, a few hundred rows per key)."""
    assert set(got) == set(want)
    for wid in want:
        for k in ("min", "max", "alerts"):
            np.testing.assert_array_equal(got[wid][k], want[wid][k])
        np.testing.assert_allclose(got[wid]["mean"], want[wid]["mean"],
                                   rtol=1e-5, atol=1e-5 * 5 * 400)


@pytest.mark.parametrize("pool_slots,overlap,budget", [
    (256, True, 64 << 20),       # resident block table
    (2, True, 64 << 20),         # pool exhaustion: stacked fallback rows
    (256, True, 192 << 10),      # pressure: demand pool fills
    (256, False, 192 << 10),     # overlap off: cold rows read host-side
])
def test_pooled_engine_matches_jax(pool_slots, overlap, budget):
    want, _ = _run("jax", True, pool_slots, overlap, budget)
    got, (pooled, fallback, demand) = _run("torch", True, pool_slots,
                                           overlap, budget)
    _assert_results_equal(got, want)
    assert pooled > 0
    if pool_slots == 2:
        assert fallback > 0
    if budget < (1 << 20):
        assert (demand > 0) == overlap
