"""The port's persistent store is a copy of the JAX package's, with the
same on-disk format: a log (or npz directory) written by
``repro.storage`` reopens and reads back identically in
``repro_torch.storage``, tombstones, fills and compaction included, and
the reverse. Comparisons are exact: the bytes are the same. Then
``tests/test_storage.py``'s cases, each on a store written by each
package and reopened by the port."""
import numpy as np
import pytest

from repro import storage as jstorage
from repro_torch import storage as tstorage
import torch

W1, W2 = (0.0, 10.0), (10.0, 20.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(fill, cap=64, width=3, seed=0):
    rng = np.random.default_rng(seed)
    a = {"keys": np.zeros((cap,), np.int32),
         "timestamps": np.zeros((cap,), np.float64),
         "values": np.zeros((cap, width), np.float32)}
    a["keys"][:fill] = rng.integers(0, 99, fill)
    a["timestamps"][:fill] = rng.uniform(0.0, 100.0, fill)
    a["values"][:fill] = rng.normal(size=(fill, width))
    return a


def _write(pkg, path, backend):
    """Blocks across two windows, a rewrite at a larger fill, and a
    tombstone; returns the expected live contents."""
    s = pkg.make_store(backend, path, segment_bytes=4096)
    want = {}
    for bid, (w, fill) in enumerate([(W1, 17), (W1, 64), (W2, 5),
                                     (W2, 40), (W1, 9)], start=1):
        a = _arrays(fill, seed=bid)
        s.put(w, bid, a, fill)
        want[(w, bid)] = (a, fill)
    s.commit()
    a = _arrays(30, seed=99)
    s.put(W2, 3, a, 30)                         # append-only rewrite
    want[(W2, 3)] = (a, 30)
    s.delete(W1, 5)
    del want[(W1, 5)]
    s.commit()
    s.close()
    return want


def _check(pkg, path, backend, want):
    s = pkg.make_store(backend, path, segment_bytes=4096)
    assert s.get(W1, 5) is None                 # tombstone survived
    for (w, bid), (a, fill) in want.items():
        if backend == "log":
            # the npz layout is the bare arrays: no fill across a reopen
            assert s.current_fill(w, bid) == fill
        got = s.get(w, bid)
        for k in ("keys", "timestamps", "values"):
            np.testing.assert_array_equal(got[k][:fill], a[k][:fill])
            assert got[k].shape == a[k].shape
    if backend == "log":
        assert sorted(s.keys()) == sorted(want)
        s.compact_if_needed(1.0)
        s.close()
        s = pkg.make_store(backend, path, segment_bytes=4096)
        for (w, bid), (a, fill) in want.items():
            np.testing.assert_array_equal(s.get(w, bid)["values"][:fill],
                                          a["values"][:fill])
    s.close()


@pytest.mark.parametrize("backend", ["log", "npz"])
def test_jax_written_store_reopens_in_port(tmp_path, backend):
    want = _write(jstorage, tmp_path, backend)
    _check(tstorage, tmp_path, backend, want)


@pytest.mark.parametrize("backend", ["log", "npz"])
def test_port_written_store_reopens_in_jax(tmp_path, backend):
    want = _write(tstorage, tmp_path, backend)
    _check(jstorage, tmp_path, backend, want)


def test_torn_tail_recovery_matches(tmp_path):
    """A log whose unacknowledged tail was torn recovers to the same
    acknowledged records in both packages."""
    want = _write(jstorage, tmp_path / "a", "log")
    segs = sorted((tmp_path / "a").glob("*"))
    last = max((p for p in segs if p.is_file()), key=lambda p: p.name)
    with open(last, "ab") as f:
        f.write(b"\x00garbage-tail" * 7)
    import shutil
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    _check(tstorage, tmp_path / "a", "log", want)
    _check(jstorage, tmp_path / "b", "log", want)


# ---------------------------------------- tests/test_storage.py's cases
# Each runs on a store written by each package (``writer``); where the
# case reopens the directory, the port reopens it (and, for the torn
# tail and the reconcile, the other package checks the port's writes).
WRITERS = {"jax": jstorage, "torch": tstorage}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("backend", ["log", "npz"])
def test_put_get_roundtrip(tmp_path, backend, writer):
    s = WRITERS[writer].make_store(backend, tmp_path)
    a = _arrays(17, seed=1, width=2)
    s.put(W1, 1, a, 17)
    s.commit()
    assert s.current_fill(W1, 1) == 17
    assert s.current_fill(W2, 1) is None
    s.close()
    p = tstorage.make_store(backend, tmp_path)
    got = p.get(W1, 1)
    assert got is not None
    for k in ("keys", "timestamps", "values"):
        np.testing.assert_array_equal(got[k][:17], a[k][:17])
    assert got["keys"].shape == a["keys"].shape
    assert got["values"].shape == a["values"].shape
    assert p.get(W1, 2) is None
    if backend == "log":
        # the npz layout is the bare arrays by block id: neither the fill
        # nor the window survives a reopen
        assert p.current_fill(W1, 1) == 17
        assert p.current_fill(W2, 1) is None
    p.close()


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("backend", ["log", "npz"])
def test_delete_tombstones(tmp_path, backend, writer):
    s = WRITERS[writer].make_store(backend, tmp_path)
    s.put(W1, 1, _arrays(8, width=2), 8)
    s.commit()
    s.delete(W1, 1)
    s.commit()
    assert s.get(W1, 1) is None
    assert s.live_bytes() == 0
    s.close()
    p = tstorage.make_store(backend, tmp_path)
    assert p.get(W1, 1) is None
    assert p.live_bytes() == 0
    p.close()


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_group_commit_durability(tmp_path, writer):
    """A crash (reopen without close) keeps everything acknowledged and
    drops everything not."""
    s = WRITERS[writer].LogBlockStore(tmp_path, segment_bytes=64 << 10)
    a = _arrays(10, seed=2, width=2)
    s.put(W1, 1, a, 10)
    s.commit()
    s.put(W1, 2, _arrays(10, seed=3, width=2), 10)       # never acknowledged
    p = tstorage.LogBlockStore(tmp_path, segment_bytes=64 << 10)
    assert p.current_fill(W1, 1) == 10
    np.testing.assert_array_equal(p.get(W1, 1)["values"], a["values"])
    assert p.get(W1, 2) is None


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_torn_tail_truncated_on_recovery(tmp_path, writer):
    s = WRITERS[writer].LogBlockStore(tmp_path, segment_bytes=64 << 10)
    s.put(W1, 1, _arrays(12, seed=4, width=2), 12)
    s.commit()
    with open(s.active_segment_path(), "ab") as f:
        f.write(b"\xde\xad\xbe\xef" * 13)
    p = tstorage.LogBlockStore(tmp_path, segment_bytes=64 << 10)
    assert p.stats["recovery_truncated_bytes"] >= 52
    assert p.current_fill(W1, 1) == 12
    p.put(W1, 5, _arrays(5, seed=5, width=2), 5)
    p.commit()
    for pkg in (tstorage, jstorage):
        s3 = pkg.LogBlockStore(tmp_path, segment_bytes=64 << 10)
        assert s3.current_fill(W1, 5) == 5
        assert s3.current_fill(W1, 1) == 12


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_footer_rebuild_across_segments(tmp_path, writer):
    s = WRITERS[writer].LogBlockStore(tmp_path, segment_bytes=8 << 10)
    for i in range(40):
        s.put(W1, i, _arrays(30, seed=i, width=2), 30)
    s.put(W1, 0, _arrays(11, seed=100, width=2), 11)
    s.commit()
    s.close()
    assert s.stats["segments_sealed"] > 1
    p = tstorage.LogBlockStore(tmp_path, segment_bytes=8 << 10)
    assert p.current_fill(W1, 0) == 11
    for i in range(1, 40):
        assert p.current_fill(W1, i) == 30
    np.testing.assert_array_equal(p.get(W1, 0)["values"],
                                  _arrays(11, seed=100, width=2)["values"])


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_compaction_bound_and_no_resurrection(tmp_path, writer):
    s = WRITERS[writer].LogBlockStore(tmp_path, segment_bytes=8 << 10)
    for i in range(50):
        s.put(W2, i, _arrays(40, seed=i, width=2), 40)
    for i in range(0, 50, 2):
        s.put(W2, i, _arrays(40, seed=500 + i, width=2), 40)
    s.commit()
    for i in range(45):
        s.delete(W2, i)
    s.commit()
    assert s.compact_if_needed(2.0) > 0
    disk, live = s.on_disk_bytes(), s.live_record_bytes()
    assert disk <= max(2.0 * live, s.segment_bytes) + s.segment_bytes
    assert s.stats["bytes_compacted"] > 0
    s.close()
    p = tstorage.LogBlockStore(tmp_path, segment_bytes=8 << 10)
    for i in range(45):
        assert p.get(W2, i) is None, f"key {i} resurrected"
    for i in range(45, 50):
        assert p.current_fill(W2, i) == 40


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_compaction_after_total_purge_frees_almost_everything(tmp_path,
                                                              writer):
    s = WRITERS[writer].LogBlockStore(tmp_path, segment_bytes=8 << 10)
    for i in range(30):
        s.put(W1, i, _arrays(40, seed=i, width=2), 40)
    s.commit()
    for i in range(30):
        s.delete(W1, i)
    s.commit()
    s.compact_if_needed(2.0)
    assert s.live_bytes() == 0
    assert s.on_disk_bytes() <= s.segment_bytes + s.segment_bytes
    s.close()
    p = tstorage.LogBlockStore(tmp_path, segment_bytes=8 << 10)
    assert p.live_bytes() == 0 and not p.keys()
    assert p.on_disk_bytes() <= p.segment_bytes + p.segment_bytes


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_batched_read_and_readahead_cache(tmp_path, writer):
    s = WRITERS[writer].LogBlockStore(tmp_path, segment_bytes=16 << 10)
    want = {}
    for i in range(20):
        a = _arrays(25, seed=i, width=2)
        want[i] = a["values"].copy()
        s.put(W1, i, a, 25)
    s.commit()
    s.close()
    p = tstorage.LogBlockStore(tmp_path, segment_bytes=16 << 10)
    got = p.get_many([(W1, i) for i in range(20)])
    assert all(g is not None for g in got)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g["values"], want[i])
    assert p.stats["batched_reads"] == 1
    p.readahead([(W1, i) for i in range(5)])
    assert p.stats["readahead_bytes"] > 0
    h0 = p.stats["readahead_hits"]
    for i in range(5):
        assert p.get(W1, i) is not None
    assert p.stats["readahead_hits"] == h0 + 5
    p.readahead([(W1, 7)])
    fresh = _arrays(9, seed=777, width=2)
    p.put(W1, 7, fresh, 9)
    np.testing.assert_array_equal(p.get(W1, 7)["values"][:9],
                                  fresh["values"][:9])


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_reconcile_drops_orphans(tmp_path, writer):
    s = WRITERS[writer].LogBlockStore(tmp_path, segment_bytes=16 << 10)
    for i in range(6):
        s.put(W1, i, _arrays(10, seed=i, width=2), 10)
    s.commit()
    s.close()
    p = tstorage.LogBlockStore(tmp_path, segment_bytes=16 << 10)
    assert p.reconcile([(W1, 0), (W1, 1)]) == 4
    assert p.current_fill(W1, 0) == 10
    assert p.get(W1, 3) is None
    p.close()
    for pkg in (tstorage, jstorage):
        s2 = pkg.LogBlockStore(tmp_path, segment_bytes=16 << 10)
        assert s2.get(W1, 3) is None
        assert s2.current_fill(W1, 1) == 10


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_write_amplification_reported(tmp_path, writer):
    s = WRITERS[writer].LogBlockStore(tmp_path, segment_bytes=8 << 10)
    for i in range(20):
        s.put(W1, i, _arrays(40, seed=i, width=2), 40)
    s.commit()
    amp = s.write_amplification
    assert 1.0 <= amp < 1.5
    for i in range(15):
        s.delete(W1, i)
    s.commit()
    s.compact_if_needed(1.0)
    assert s.write_amplification >= amp
    s.close()
    p = tstorage.LogBlockStore(tmp_path, segment_bytes=8 << 10)
    assert sorted(p.keys()) == [(W1, i) for i in range(15, 20)]
    p.close()


@pytest.mark.parametrize("pkg", sorted(WRITERS))
def test_simulated_cost_zero_bytes_free(pkg):
    c = WRITERS[pkg].SimulatedCost(1.0)
    assert c.charge(0) == 0.0
    assert c.charge(-5) == 0.0
    assert c.total_seconds == 0.0


@pytest.mark.parametrize("pkg", sorted(WRITERS))
def test_empty_block_transfers_skip_sim_cost(tmp_path, pkg):
    """The I/O scheduler never bills an empty block."""
    if pkg == "jax":
        from repro.core.buckets import Block, MemoryBudget
        from repro.core.staging import IOScheduler
        dev = {}
    else:
        from repro_torch.core.buckets import Block, MemoryBudget
        from repro_torch.core.staging import IOScheduler
        dev = {"device": "cpu"}
    io = IOScheduler(MemoryBudget(1 << 20), spill_dir=tmp_path,
                     simulated_seconds_per_byte=1e-3, **dev)
    blk = Block.new(64, 1)
    blk.persisted = True
    assert io.fetch_block_host(blk) is not None
    io.spill_block_sync(blk)
    assert blk.fill == 0
    assert io.stats["simulated_io_seconds"] == 0.0
    assert io.simcost.total_seconds == 0.0
    io.shutdown()


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_npz_backend_is_file_per_block(tmp_path, writer):
    s = WRITERS[writer].NpzBlockStore(tmp_path)
    a = _arrays(10, seed=3, width=2)
    ref = s.put(W1, 3, a, 10)
    assert ref.exists() and ref.name == "block_3.npz"
    p = tstorage.NpzBlockStore(tmp_path)
    np.testing.assert_array_equal(p.get(W1, 3)["values"], a["values"])
    p.delete(W1, 3)
    assert not ref.exists()
