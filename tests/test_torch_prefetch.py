"""The port's learned prefetch (``repro_torch.prefetch`` and the storage
and staging seams it drives) against the JAX package's: the counterparts
of ``tests/test_prefetch.py``'s 23 cases on the port; the lateness and
cost models against the JAX ones on the same seeded inputs; the planner's
sweeps and coalesce picks over the same log store contents; and the
port's engine with ``prefetch_backend="learned"`` against the JAX engine
with the same setting and against the port's ``fixed`` engine on one
stream.

Tolerances: the models are float64 numpy in both packages, held within
1e-12; planner outputs exact; the engines' window means within rtol 1e-5
and atol 1e-6 (``test_prefetch.py``'s), and the counts of live and late
executions equal. Everything runs on the CPU.
"""
import numpy as np
import pytest

import repro.configs.base as jcfg
import repro.core as jcore
import repro.core.engine as jengine
import repro.core.windows as jwin
import repro.prefetch as jpf
import repro.storage as jstorage
from repro_torch.configs.base import AionConfig
from repro_torch.core import StreamEngine, TumblingWindows
from repro_torch.core.buckets import MemoryBudget, Tier, WindowState
from repro_torch.core.engine import PeriodicWatermarkGenerator
from repro_torch.core.events import EventBatch
from repro_torch.core.operators import make_operator
from repro_torch.core.staging import (
    IOScheduler, PRIO_DEMAND_STAGE, PRIO_DESTAGE, PRIO_LATE_WRITE,
    PRIO_READAHEAD, PRIO_STAGE,
)
from repro_torch.core.windows import WindowId
from repro_torch.prefetch import (
    LatenessModel, LearnedCostModel, LearnedPrestageScheduler,
    SegmentPrefetchPlanner,
)
from repro_torch.storage import LogBlockStore
import torch

W1 = (0.0, 10.0)
W2 = (10.0, 20.0)
MODEL_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(fill, cap=64, width=1, seed=0):
    rng = np.random.default_rng(seed)
    a = {
        "keys": np.zeros((cap,), np.int32),
        "timestamps": np.zeros((cap,), np.float64),
        "values": np.zeros((cap, width), np.float32),
    }
    a["keys"][:fill] = rng.integers(0, 99, fill)
    a["timestamps"][:fill] = rng.uniform(0.0, 100.0, fill)
    a["values"][:fill] = rng.normal(size=(fill, width))
    return a


def _io(budget, **kw):
    return IOScheduler(budget, device="cpu", **kw)


# --------------------------------------------------------------- model
def test_lateness_model_survival_declines_with_age(rng):
    m = LatenessModel(num_classes=4)
    wid = WindowId(0.0, 10.0)
    m.observe(wid, rng.integers(0, 100, 500),
              rng.lognormal(0.0, 1.0, 500) * 5.0)
    p_young = m.reexec_probability(wid, 0.1)
    p_mid = m.reexec_probability(wid, 5.0)
    p_old = m.reexec_probability(wid, 1e4)
    assert p_young > p_mid > p_old
    assert p_old == pytest.approx(0.0, abs=1e-6)


def test_lateness_model_pessimistic_without_samples():
    m = LatenessModel()
    assert m.reexec_probability(WindowId(0.0, 10.0), 3.0) == 1.0


def test_lateness_model_separates_key_classes(rng):
    m = LatenessModel(num_classes=2, refit_every=1)
    short_keys = np.zeros(400, np.int64)       # class 0
    long_keys = np.ones(400, np.int64)         # class 1
    m.observe(None, short_keys, rng.uniform(0.01, 1.0, 400))
    m.observe(None, long_keys, rng.uniform(50.0, 100.0, 400))
    w_short, w_long = WindowId(0.0, 10.0), WindowId(10.0, 20.0)
    m.observe(w_short, short_keys[:8], rng.uniform(0.01, 1.0, 8))
    m.observe(w_long, long_keys[:8], rng.uniform(50.0, 100.0, 8))
    age = 5.0
    assert m.reexec_probability(w_short, age) < 0.1
    assert m.reexec_probability(w_long, age) > 0.9


def test_lateness_model_forget_and_bounds(rng):
    m = LatenessModel(num_classes=2, max_windows=8)
    for i in range(32):
        m.observe(WindowId(i * 10.0, (i + 1) * 10.0),
                  rng.integers(0, 9, 4), rng.uniform(0.1, 2.0, 4))
    assert len(m._window_classes) <= 8         # LRU-bounded
    wid = WindowId(310.0, 320.0)
    m.forget(wid)
    assert wid not in m._window_classes


def test_learned_cost_model_keeps_fixed_contract():
    c = LearnedCostModel(prior_bandwidth_bytes_per_s=1e6)
    assert c.delta_t(100) == float("inf")
    c.observe(1.0, 1000)
    assert c.delta_t(500) == pytest.approx(0.5)
    assert c.delta_t(0) == pytest.approx(c.floor_seconds)
    assert c.delta_t_bytes(2_000_000) == pytest.approx(2.0)
    c.observe_bytes(1.0, 4_000_000)            # measured sweep: 4 MB/s
    assert c.bandwidth_bytes_per_s == pytest.approx(4e6)
    assert c.delta_t_bytes(2_000_000) == pytest.approx(0.5)


def test_models_match_the_jax_package():
    """The same seeded samples through both packages' models: survival,
    re-execution probability, the residual delay and the cost model's
    leads, within 1e-12 (float64 numpy on both sides)."""
    rng = np.random.default_rng(2024)
    models = {"jax": jpf.LatenessModel(num_classes=5, refit_every=16),
              "torch": LatenessModel(num_classes=5, refit_every=16)}
    wids = {"jax": [jwin.WindowId(i * 10.0, i * 10.0 + 10.0)
                    for i in range(6)],
            "torch": [WindowId(i * 10.0, i * 10.0 + 10.0)
                      for i in range(6)]}
    out = {k: [] for k in models}
    for step in range(40):
        w = int(rng.integers(0, 6))
        n = int(rng.integers(1, 60))
        keys = rng.integers(-50, 500, n)
        delays = rng.lognormal(0.5, 1.2, n) * 3.0
        ages = rng.uniform(0.0, 60.0, 4)
        for k, m in models.items():
            m.observe(wids[k][w] if step % 3 else None, keys, delays)
            for age in ages:
                out[k].append([m.survival(int(c), age)
                               for c in range(5)])
                out[k][-1] += [m.reexec_probability(wid, age)
                               for wid in wids[k] + [None]]
                out[k][-1] += [m.expected_residual_delay(age, q)
                               for q in (0.1, 0.5, 0.9)]
    np.testing.assert_allclose(np.asarray(out["torch"]),
                               np.asarray(out["jax"]), rtol=0,
                               atol=MODEL_TOL)
    costs = {"jax": jpf.LearnedCostModel(prior_bandwidth_bytes_per_s=3e7),
             "torch": LearnedCostModel(prior_bandwidth_bytes_per_s=3e7)}
    leads = {k: [] for k in costs}
    for _ in range(30):
        sec, ev = float(rng.uniform(1e-4, 2.0)), int(rng.integers(0, 9000))
        nbytes = int(rng.integers(0, 1 << 26))
        probe = int(rng.integers(0, 1 << 24))
        for k, c in costs.items():
            c.observe(sec, ev)
            c.observe_bytes(sec, nbytes)
            leads[k] += [c.delta_t(ev), c.delta_t(probe),
                         c.delta_t_bytes(nbytes), c.delta_t_bytes(probe)]
    np.testing.assert_allclose(np.asarray(leads["torch"]),
                               np.asarray(leads["jax"]), rtol=0,
                               atol=MODEL_TOL)


# -------------------------------------------------------------- planner
def _store_with_blocks(tmp_path, n_windows=3, blocks_per_window=4,
                       store_cls=LogBlockStore):
    st = store_cls(tmp_path, segment_bytes=1 << 20)
    keys_by_window = {}
    bid = 0
    for r in range(blocks_per_window):         # interleave: scattered
        for w in range(n_windows):
            wk = (w * 10.0, (w + 1) * 10.0)
            st.put(wk, bid, _arrays(48, seed=bid), 48)
            keys_by_window.setdefault(wk, []).append((wk, bid))
            bid += 1
    st.commit()
    return st, keys_by_window


def test_planner_merges_windows_into_segment_sweeps(tmp_path):
    st, by_w = _store_with_blocks(tmp_path)
    planner = SegmentPrefetchPlanner(LearnedCostModel(),
                                     budget_bytes=64 << 20)
    wants = [(WindowId(*wk), 100.0 + i, keys, 1.0)
             for i, (wk, keys) in enumerate(by_w.items())]
    res = planner.plan(st, wants, now=99.9)
    assert len(res.sweeps) == 1
    sw = res.sweeps[0]
    assert len(sw.windows) == 3
    assert sw.deadline == 100.0                # earliest contributor
    assert sw.span_bytes >= sw.record_bytes > 0
    assert not res.deferred_windows
    st.close()


def test_planner_defers_far_out_sweeps_over_budget(tmp_path):
    st, by_w = _store_with_blocks(tmp_path)
    cost = LearnedCostModel(prior_bandwidth_bytes_per_s=1e12)
    planner = SegmentPrefetchPlanner(cost, budget_bytes=1)
    wants = [(WindowId(*wk), 1e6, keys, 1.0) for wk, keys in by_w.items()]
    res = planner.plan(st, wants, now=0.0)
    assert not res.sweeps
    assert res.deferred_windows == {WindowId(*wk) for wk in by_w}
    slow = LearnedCostModel(prior_bandwidth_bytes_per_s=1e3)
    planner2 = SegmentPrefetchPlanner(slow, budget_bytes=1)
    wants = [(WindowId(*wk), 0.5, keys, 1.0) for wk, keys in by_w.items()]
    res = planner2.plan(st, wants, now=0.0)
    assert len(res.sweeps) == 1
    st.close()


def test_planner_picks_scattered_hot_windows_for_coalescing(tmp_path):
    st, by_w = _store_with_blocks(tmp_path)
    planner = SegmentPrefetchPlanner(LearnedCostModel(),
                                     coalesce_probability=0.5)
    wk_hot = (0.0, 10.0)
    wants = [(WindowId(*wk), 100.0, keys, 0.9 if wk == wk_hot else 0.1)
             for wk, keys in by_w.items()]
    res = planner.plan(st, wants, now=99.0)
    assert res.coalesce == [WindowId(*wk_hot)]
    assert planner.plan(st, wants, now=99.0).coalesce == []
    st.close()


def _plan_rows(res):
    return ([(s.sid, [(tuple(k[0]), int(k[1])) for k in s.keys],
              s.span_bytes, s.record_bytes, s.deadline,
              sorted((w.start, w.end) for w in s.windows))
             for s in res.sweeps],
            sorted((w.start, w.end) for w in res.deferred_windows),
            [(w.start, w.end) for w in res.coalesce])


@pytest.mark.parametrize("bandwidth,budget", [(64e6, 64 << 20),
                                              (1e3, 1 << 12),
                                              (1e12, 1)])
def test_planner_matches_the_jax_package(tmp_path, bandwidth, budget):
    """Both packages' planners over log stores with the same contents
    (several segments, scattered and dense windows): the same sweeps, in
    the same order, the same deferred windows and coalesce picks."""
    rng = np.random.default_rng(7)
    rows = {"jax": [], "torch": []}
    for pkg, store_cls, model, planner_cls, wid_cls in (
            ("jax", jstorage.LogBlockStore, jpf.LearnedCostModel,
             jpf.SegmentPrefetchPlanner, jwin.WindowId),
            ("torch", LogBlockStore, LearnedCostModel,
             SegmentPrefetchPlanner, WindowId)):
        st = store_cls(tmp_path / pkg, segment_bytes=8 << 10)
        keys_by_window = {}
        order = np.random.default_rng(11).permutation(40)
        for bid in order:
            w = int(bid % 5) if bid < 30 else 4
            wk = (w * 10.0, (w + 1) * 10.0)
            st.put(wk, int(bid), _arrays(48, seed=int(bid)), 48)
            keys_by_window.setdefault(wk, []).append((wk, int(bid)))
        st.commit()
        planner = planner_cls(model(prior_bandwidth_bytes_per_s=bandwidth),
                              budget_bytes=budget,
                              coalesce_probability=0.3)
        for now in (0.0, 50.0):
            wants = [(wid_cls(*wk), 40.0 + 7 * i, keys, 0.1 + 0.2 * i)
                     for i, (wk, keys) in
                     enumerate(sorted(keys_by_window.items()))]
            rows[pkg].append(_plan_rows(planner.plan(st, wants, now)))
        rows[pkg].append(dict(planner.stats))
        st.close()
    del rng
    assert rows["torch"] == rows["jax"]
    assert any(r[0] for r in rows["torch"][:2])      # sweeps were planned


# ------------------------------------------------- logstore: segments
def test_segments_for_is_index_only(tmp_path):
    st, by_w = _store_with_blocks(tmp_path)
    read_before = st.stats["bytes_read"]
    placement = st.segments_for([k for ks in by_w.values() for k in ks])
    assert st.stats["bytes_read"] == read_before
    assert sum(len(v) for v in placement.values()) == 12
    for items in placement.values():
        offs = [off for _, off, _ in items]
        assert offs == sorted(offs)
        assert all(length > 0 for _, _, length in items)
    assert st.segments_for([((99.0, 100.0), 7)]) == {}
    st.close()


def test_readahead_segments_sweeps_and_counts_hits(tmp_path):
    st, by_w = _store_with_blocks(tmp_path)
    all_keys = [k for ks in by_w.values() for k in ks]
    placement = st.segments_for(all_keys)
    for sid, items in placement.items():
        assert st.readahead_segments(sid, [k for k, _, _ in items]) \
            == len(items)
    assert st.stats["segment_sweeps"] == len(placement)
    assert st.stats["sweep_bytes_read"] > 0
    for wk, bid in all_keys:
        assert st.get(wk, bid) is not None
    assert st.stats["readahead_hits"] == len(all_keys)
    assert st.stats["readahead_misses"] == 0
    st.close()


def test_readahead_segments_skips_stale_plan_entries(tmp_path):
    st, by_w = _store_with_blocks(tmp_path)
    keys = by_w[(0.0, 10.0)]
    (sid, items), = st.segments_for(keys).items()
    wk, bid = keys[0]
    st.put(wk, bid, _arrays(48, seed=77), 48)
    st.commit()
    assert st.readahead_segments(sid, [k for k, _, _ in items]) \
        == len(items)
    got = st.get(wk, bid)
    np.testing.assert_array_equal(got["keys"][:48],
                                  _arrays(48, seed=77)["keys"][:48])
    st.close()


def test_window_scatter_and_coalesce(tmp_path):
    st, by_w = _store_with_blocks(tmp_path)
    wk = (0.0, 10.0)
    records, segs, span, rec_bytes = st.window_scatter(wk)
    assert records == 4 and segs == 1
    assert span > 1.5 * rec_bytes
    assert st.coalesce_windows([wk]) == 1
    records2, _segs2, span2, rec_bytes2 = st.window_scatter(wk)
    assert records2 == records and rec_bytes2 == rec_bytes
    assert span2 <= 1.5 * rec_bytes2
    assert st.coalesce_windows([wk]) == 0
    assert st.stats["coalesced_windows"] == 1
    for (w, bid) in by_w[wk]:
        np.testing.assert_array_equal(
            st.get(w, bid)["keys"][:48], _arrays(48, seed=bid)["keys"][:48])
    st.close()


def test_coalesce_survives_recovery(tmp_path):
    st, by_w = _store_with_blocks(tmp_path)
    wk = (0.0, 10.0)
    assert st.coalesce_windows([wk]) == 1
    st.close()
    st2 = LogBlockStore(tmp_path, segment_bytes=1 << 20)
    for (w, bid) in by_w[wk]:
        got = st2.get(w, bid)
        assert got is not None
        np.testing.assert_array_equal(
            got["keys"][:48], _arrays(48, seed=bid)["keys"][:48])
    st2.delete(*by_w[wk][0])
    st2.commit()
    st2.compact_if_needed(1.0)
    assert st2.get(*by_w[wk][0]) is None
    assert st2.get(*by_w[wk][1]) is not None
    st2.close()


def test_npz_store_reports_no_segments(tmp_path):
    from repro_torch.storage import NpzBlockStore
    s = NpzBlockStore(tmp_path)
    s.put(W1, 0, _arrays(8), 8)
    assert s.segments_for([(W1, 0)]) == {}
    assert s.readahead_segments(0, [(W1, 0)]) == 0
    assert s.window_scatter(W1) == (0, 0, 0, 0)
    assert s.coalesce_windows([W1]) == 0


# ------------------------------------------------ staging: new requests
def _host_block(cap=32, width=1, seed=0):
    st = WindowState(0, 10, width=width, block_capacity=cap)
    rng = np.random.default_rng(seed)
    st.append_events(EventBatch(
        rng.integers(0, 99, cap).astype(np.int32),
        rng.uniform(0, 10, cap), rng.normal(size=(cap, width)).astype(
            np.float32)), late=False)
    return st


def test_priority_lattice_readahead_between_stage_and_late_write():
    assert PRIO_DEMAND_STAGE < PRIO_STAGE < PRIO_READAHEAD \
        < PRIO_LATE_WRITE < PRIO_DESTAGE


def test_request_segment_readahead_feeds_bandwidth_model(tmp_path):
    store = LogBlockStore(tmp_path / "s", segment_bytes=1 << 20)
    io = _io(MemoryBudget(1 << 20), store=store)
    blk = _host_block().blocks[0]
    io.spill_block_sync(blk)
    observed = []
    (sid, items), = store.segments_for(
        [(blk.window_key, blk.block_id)]).items()
    h = io.request_segment_readahead(
        sid, [k for k, _, _ in items],
        on_swept=lambda sec, nb: observed.append((sec, nb)))
    assert h.wait(30.0)
    assert observed and observed[0][1] > 0
    assert store.stats["segment_sweeps"] == 1
    io.shutdown()


def test_request_coalesce_runs_in_background(tmp_path):
    store = LogBlockStore(tmp_path / "s", segment_bytes=1 << 20)
    io = _io(MemoryBudget(1 << 20), store=store)
    for r in range(3):
        for w, wk in enumerate((W1, W2)):
            store.put(wk, r * 2 + w, _arrays(32, seed=r), 32)
    store.commit()
    h = io.request_coalesce([W1, W2])
    assert h.wait(30.0)
    assert io.stats.get("coalesced_windows") == 2
    _, segs, span, rec = store.window_scatter(W1)
    assert span <= 1.5 * rec
    io.shutdown()


# ----------------------------------------------- WAL commit coalescing
def test_wal_coalesced_spills_share_one_commit(tmp_path):
    store = LogBlockStore(tmp_path / "s", segment_bytes=1 << 20)
    io = _io(MemoryBudget(1 << 20), store=store, host_budget_bytes=1,
             wal_coalesce=True)
    assert io._coalescer is not None
    states = [_host_block(seed=i) for i in range(6)]
    commits_before = store.stats["commits"]

    def destage_all():
        for st in states:
            io._account_host(st.blocks[0])
        io._maybe_spill()
    assert io.submit(PRIO_DESTAGE, destage_all).wait(30.0)
    assert io.drain(30.0)
    for st in states:
        assert st.blocks[0].tier == Tier.STORAGE
        assert st.blocks[0].host_data is None
    cs = io._coalescer.stats
    assert cs["coalesced_commits"] >= 1
    assert cs["joined_tasks"] >= cs["coalesced_commits"]
    assert store.stats["commits"] - commits_before <= cs["joined_tasks"]
    assert io._pending_spill_bytes == 0
    io.shutdown()


def test_wal_coalesce_commit_failure_keeps_host_copies(tmp_path):
    store = LogBlockStore(tmp_path / "s", segment_bytes=1 << 20)
    io = _io(MemoryBudget(1 << 20), store=store, host_budget_bytes=1,
             wal_coalesce=True)
    blk = _host_block(seed=3).blocks[0]
    orig_commit = store.commit

    def failing_commit():
        raise RuntimeError("commit blew up")
    store.commit = failing_commit
    io._account_host(blk)
    assert io.submit(PRIO_DESTAGE, io._maybe_spill).wait(30.0)
    assert io.drain(30.0)
    assert blk.tier == Tier.HOST and blk.host_data is not None
    assert io._pending_spill_bytes == 0
    assert io.executor.stats["errors"] >= 1
    store.commit = orig_commit
    io.shutdown()


def test_direct_spill_calls_stay_synchronous(tmp_path):
    store = LogBlockStore(tmp_path / "s", segment_bytes=1 << 20)
    io = _io(MemoryBudget(1 << 20), store=store, wal_coalesce=True)
    blk = _host_block(seed=4).blocks[0]
    io.spill_block_sync(blk)
    assert blk.tier == Tier.STORAGE and blk.host_data is None
    io.shutdown()


# --------------------------------------------------- engine integration
def _lnorm_engine_run(backend, spill_dir, *, steps=240, seed=7,
                      pkg="torch"):
    """``tests/test_prefetch.py``'s stream through either package."""
    if pkg == "jax":
        aion = jcfg.AionConfig(block_size=64, batched_execution=True,
                               prefetch_backend=backend,
                               store_segment_bytes=64 << 10)
        core, dev, ev = jcore, {}, jcore.EventBatch
        gen = jengine.PeriodicWatermarkGenerator(period=1.0)
    else:
        aion = AionConfig(block_size=64, batched_execution=True,
                          prefetch_backend=backend,
                          store_segment_bytes=64 << 10)
        core, dev, ev = None, {"device": "cpu"}, EventBatch
        gen = PeriodicWatermarkGenerator(period=1.0)
    mk_engine = core.StreamEngine if core else StreamEngine
    mk_op = core.make_operator if core else make_operator
    windows = core.TumblingWindows if core else TumblingWindows
    eng = mk_engine(
        assigner=windows(10.0),
        operator=mk_op("average", aion.block_size, 1, **dev),
        aion=aion, watermark_gen=gen,
        device_budget_bytes=1 << 19, host_budget_bytes=1 << 15,
        spill_dir=spill_dir, **dev)
    rng = np.random.default_rng(seed)
    for step in range(steps):
        now = step * 0.25
        n = 60
        late = rng.random(n) < 0.4
        ts = np.full(n, now) - late * rng.lognormal(0, 1, n) * 8.0
        eng.ingest(ev(rng.integers(0, 64, n).astype(np.int32),
                      np.maximum(ts, 0.0), np.ones((n, 1), np.float32)),
                   now)
        eng.poll(now)
        if pkg == "jax":
            # the JAX engine loses appends that race its I/O thread
            # (ROADMAP Queue 3, item 18): it steps with its I/O idle
            assert eng.io.drain()
    eng.close()
    return eng


def test_learned_backend_constructs_and_prefetches(tmp_path):
    eng = _lnorm_engine_run("learned", tmp_path / "learned")
    assert isinstance(eng.prestage, LearnedPrestageScheduler)
    s = eng.store.stats
    assert s["segment_sweeps"] > 0
    hits, misses = s["readahead_hits"], s["readahead_misses"]
    assert hits > 0
    assert hits / max(hits + misses, 1) > 0.9
    assert eng.prestage.model.samples > 0


def test_fixed_backend_unchanged_default(tmp_path):
    eng = _lnorm_engine_run("fixed", tmp_path / "fixed")
    from repro_torch.core.proactive import PrestageScheduler
    assert type(eng.prestage) is PrestageScheduler
    assert eng.store.stats["segment_sweeps"] == 0


def _agree(a, b):
    ra = {(w.start, w.end): r for w, r in a.results.items()}
    rb = {(w.start, w.end): r for w, r in b.results.items()}
    assert set(ra) == set(rb)
    for wid, res in ra.items():
        np.testing.assert_allclose(
            np.asarray(res, np.float64), np.asarray(rb[wid], np.float64),
            rtol=1e-5, atol=1e-6, err_msg=str(wid))


def test_fixed_and_learned_agree_on_results(tmp_path):
    """Differential: prefetch backends must not change WHAT is computed,
    only how its I/O is scheduled."""
    _agree(_lnorm_engine_run("fixed", tmp_path / "f", steps=160),
           _lnorm_engine_run("learned", tmp_path / "l", steps=160))


def test_learned_engine_matches_the_jax_learned_engine(tmp_path):
    """The port's learned engine against the JAX learned engine on the
    same stream, and against the port's fixed engine: every window's
    result, and the counts of live and late executions."""
    runs = {(pkg, backend): _lnorm_engine_run(
        backend, tmp_path / f"{pkg}_{backend}", steps=160, pkg=pkg)
        for pkg, backend in (("torch", "learned"), ("jax", "learned"),
                             ("torch", "fixed"))}
    got = runs[("torch", "learned")]
    for other in (runs[("jax", "learned")], runs[("torch", "fixed")]):
        _agree(got, other)
        for k in ("live_executions", "late_executions"):
            assert getattr(got.metrics, k) == getattr(other.metrics, k), k
    assert got.metrics.live_executions > 0
    assert got.metrics.ingested_late > 0
    assert got.store.stats["segment_sweeps"] > 0
