"""The window assigners and watermarks on the port:
``tests/test_windows.py``'s 6 and ``tests/test_watermarks.py``'s 3 cases
through ``repro_torch.core.windows`` and ``repro_torch.core.time``, each
with the same numpy timestamps also through the JAX package's assigner or
tracker: the window ids, the index arrays assigned to each, the
watermarks and the lateness classes are equal exactly.
"""
import numpy as np

import repro.core.time as jtime
import repro.core.windows as jwin
import repro_torch.core.windows as twin
from repro_torch.core.time import PeriodicWatermarkGenerator, \
    WatermarkTracker
from repro_torch.core.windows import (
    CountWindows, SessionWindows, SlidingWindows, TumblingWindows, WindowId,
)
import pytest
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


def _same(got, want):
    """Two assignments equal exactly: the same windows in the same order,
    each with the same index array."""
    assert [(w.start, w.end) for w, _ in got] == \
        [(w.start, w.end) for w, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _both(make, ts):
    """``make(module)`` builds an assigner from either package; returns
    the port's assignment after holding it to the JAX one."""
    got = make(twin).assign(ts)
    _same(got, make(jwin).assign(ts))
    return got


def test_tumbling_assignment():
    ts = np.array([0.5, 9.9, 10.0, 19.9, 20.1])
    out = _both(lambda m: m.TumblingWindows(10.0), ts)
    windows = {w: set(i.tolist()) for w, i in out}
    assert windows[WindowId(0.0, 10.0)] == {0, 1}
    assert windows[WindowId(10.0, 20.0)] == {2, 3}
    assert windows[WindowId(20.0, 30.0)] == {4}


def test_tumbling_covers_all_events():
    ts = np.random.default_rng(0).uniform(0, 1000, 5000)
    out = _both(lambda m: m.TumblingWindows(7.0), ts)
    seen = np.concatenate([i for _, i in out])
    assert sorted(seen.tolist()) == list(range(5000))


def test_sliding_overlap():
    ts = np.array([12.0])
    out = _both(lambda m: m.SlidingWindows(10.0, 5.0), ts)
    starts = sorted(w.start for w, _ in out)
    assert starts == [5.0, 10.0]
    for w, idx in out:
        assert idx.tolist() == [0]


def test_sliding_event_in_size_over_slide_windows():
    ts = np.random.default_rng(1).uniform(100, 200, 300)
    out = _both(lambda m: m.SlidingWindows(30.0, 10.0), ts)
    counts = np.zeros(300, int)
    for w, idx in out:
        for i in idx:
            assert w.start <= ts[i] < w.end
            counts[i] += 1
    assert (counts == 3).all()


def test_session_windows_split_on_gap():
    ts = np.array([0.0, 1.0, 2.0, 50.0, 51.0])
    out = _both(lambda m: m.SessionWindows(gap=10.0), ts)
    assert len(out) == 2
    sizes = sorted(len(i) for _, i in out)
    assert sizes == [2, 3]


def test_count_windows_running_offset():
    cw, jcw = CountWindows(count=4), jwin.CountWindows(count=4)
    out1, out2 = cw.assign(np.zeros(6)), cw.assign(np.zeros(6))
    _same(out1, jcw.assign(np.zeros(6)))
    _same(out2, jcw.assign(np.zeros(6)))
    assert [len(i) for _, i in out1] == [4, 2]
    assert [len(i) for _, i in out2] == [2, 4]


def test_tracker_monotonic():
    t, jt = WatermarkTracker(), jtime.WatermarkTracker()
    for wm, moved in ((10.0, True), (5.0, False)):
        assert t.advance(wm) is moved
        assert jt.advance(wm) is moved
    assert t.watermark == jt.watermark == 10.0


def test_lateness_classification():
    t, jt = WatermarkTracker(), jtime.WatermarkTracker()
    t.advance(100.0)
    jt.advance(100.0)
    ts = np.array([50.0, 99.9, 100.0, 150.0])
    assert t.is_late(ts).tolist() == [True, True, False, False]
    np.testing.assert_array_equal(t.is_late(ts), jt.is_late(ts))
    np.testing.assert_allclose(t.lateness_of(ts)[:2], [50.0, 0.1])
    np.testing.assert_array_equal(t.lateness_of(ts), jt.lateness_of(ts))


def test_periodic_emission():
    g = PeriodicWatermarkGenerator(period=5.0, slack=1.0)
    jg = jtime.PeriodicWatermarkGenerator(period=5.0, slack=1.0)
    got = []
    for obs, now in ((np.array([10.0, 20.0]), 0.0), (None, 2.0),
                     (np.array([30.0]), 5.0)):
        if obs is not None:
            g.observe(obs)
            jg.observe(obs)
        got.append(g.maybe_emit(now))
        assert got[-1] == jg.maybe_emit(now)
    assert got == [19.0, None, 29.0]
