"""The port's predictive cleanup (``core/cleanup.py``) and fixed-margin
proactive caching (``core/proactive.py``: ``StagingCostModel`` and
``PrestageScheduler``) against the JAX package's: every case of
``tests/test_cleanup_proactive.py`` runs on the same inputs through both
packages, holds the port to the JAX test's own assertions, and holds the
two packages' readings to each other.

Tolerances: the histogram counts, quantiles and DKW bounds are float32
and float64 numpy on both sides (the JAX histogram keeps its counts in a
``jnp`` array, updated on the host in numpy), held within 1e-12 relative;
scheduler decisions (due lists, plan times, stats) exact.
"""
import numpy as np
import pytest

import repro.core.buckets as jbuckets
import repro.core.cleanup as jcleanup
import repro.core.events as jev
import repro.core.proactive as jpro
import repro.core.windows as jwin
import repro_torch.core.buckets as tbuckets
import repro_torch.core.cleanup as tcleanup
import repro_torch.core.events as tev
import repro_torch.core.proactive as tpro
import repro_torch.core.windows as twin
import torch

PKGS = {"jax": (jbuckets, jcleanup, jev, jpro, jwin),
        "torch": (tbuckets, tcleanup, tev, tpro, twin)}
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn):
    """``fn(pkg modules...)`` through each package: {pkg: reading}."""
    return {pkg: fn(*mods) for pkg, mods in PKGS.items()}


def _same(out):
    """The port's reading equals the JAX package's."""
    j, t = out["jax"], out["torch"]
    np.testing.assert_allclose(np.asarray(t, np.float64),
                               np.asarray(j, np.float64), rtol=RTOL,
                               atol=0)


# ------------------------------------------------------------- cleanup
def test_histogram_cdf_quantiles():
    delays = np.random.default_rng(0).lognormal(0, 1, 20000) * 10

    def run(buckets, cleanup, ev, pro, win):
        h = cleanup.LatenessHistogram(min_delay=1e-3, max_delay=1e4)
        h.update(delays)
        return [h.total] + [h.quantile(q) for q in (0.5, 0.9, 0.99)] \
            + list(np.asarray(h.counts, np.float64))
    out = _both(run)
    _same(out)
    t = out["torch"]
    assert t[0] == 20000
    for est, q in zip(t[1:4], (0.5, 0.9, 0.99)):
        true = np.quantile(delays, q)
        assert 0.8 * true <= est <= 1.3 * true


def test_cleanup_bound_covers_target():
    delays = np.random.default_rng(1).lognormal(0, 1, 50000) * 10

    def run(buckets, cleanup, ev, pro, win):
        c = cleanup.PredictiveCleanup(coverage=0.99, confidence=0.95,
                                      min_history=100)
        c.observe(delays)
        return c.current_bound()
    out = _both(run)
    _same(out)
    assert np.mean(delays <= out["torch"]) >= 0.99


def test_cleanup_conservative_until_history():
    def run(buckets, cleanup, ev, pro, win):
        c = cleanup.PredictiveCleanup(initial_bound=1234.0, min_history=200)
        c.observe(np.array([1.0, 2.0]))
        return c.current_bound()
    out = _both(run)
    _same(out)
    assert out["torch"] == 1234.0


def test_cleanup_bound_tightens_with_data():
    delays = np.random.default_rng(2).uniform(0, 10, 10000)

    def run(buckets, cleanup, ev, pro, win):
        c = cleanup.PredictiveCleanup(coverage=0.9, confidence=0.95,
                                      min_history=50, initial_bound=1e6)
        c.observe(delays)
        return c.current_bound()
    out = _both(run)
    _same(out)
    b1 = out["torch"]
    assert b1 < 1e6 and b1 >= np.quantile(np.linspace(0, 10, 100), 0.9) * 0.8


def test_should_purge_threshold():
    delays = np.random.default_rng(3).uniform(0, 10, 1000)

    def run(buckets, cleanup, ev, pro, win):
        c = cleanup.PredictiveCleanup(coverage=0.9, confidence=0.9,
                                      min_history=10)
        c.observe(delays)
        bound = c.current_bound()
        return [bound,
                c.should_purge(window_end=100.0,
                               watermark=100.0 + bound / 2),
                c.should_purge(window_end=100.0,
                               watermark=100.0 + bound * 2)]
    out = _both(run)
    _same(out)
    assert out["torch"][1:] == [False, True]


# ------------------------------------------------------------ proactive
def test_staging_cost_model_ewma():
    def run(buckets, cleanup, ev, pro, win):
        m = pro.StagingCostModel(alpha=0.5)
        m.observe(1.0, 1000)
        a = m.seconds_per_event
        m.observe(3.0, 1000)
        return [a, m.seconds_per_event, m.delta_t(500)]
    out = _both(run)
    _same(out)
    assert out["torch"] == pytest.approx([1e-3, 2e-3, 1.0])


def _observed_model(pro, seconds_per_event: float):
    m = pro.StagingCostModel()
    m.observe(seconds_per_event * 1000, 1000)
    return m


def _late_state(buckets, ev, n=80):
    st = buckets.WindowState(0, 10, width=1, block_capacity=8)
    st.append_events(ev.EventBatch(np.zeros(n, np.int32), np.zeros(n),
                                   np.zeros((n, 1))), late=True)
    return st


def _due(sched, t):
    return [(w.start, w.end) for w in sched.due(t)]


def _upcoming(sched, t, h):
    return [(w.start, w.end) for w in sched.upcoming(t, h)]


def test_prestage_scheduler_plans_delta_t_ahead():
    def run(buckets, cleanup, ev, pro, win):
        sched = pro.PrestageScheduler(_observed_model(pro, 1e-3))
        wid = win.WindowId(0, 10)
        sched.plan(wid, _late_state(buckets, ev), exec_time=100.0, now=0.0)
        return [sched.planned_stage_at(wid), _due(sched, 99.0),
                _due(sched, 99.95)]
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"][1:] == [[], [(0, 10)]]


def test_prestage_first_lead_is_pessimistic():
    def run(buckets, cleanup, ev, pro, win):
        m = pro.StagingCostModel(seconds_per_event=1e-3)   # never observed
        sched = pro.PrestageScheduler(m)
        st = buckets.WindowState(0, 10, width=1, block_capacity=8)
        sched.plan(win.WindowId(0, 10), st, exec_time=100.0, now=0.0)
        return [m.delta_t(80), _due(sched, 0.0)]
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"] == [float("inf"), [(0, 10)]]


def test_staging_cost_floor_guards_zero_event_plans():
    def run(buckets, cleanup, ev, pro, win):
        m = _observed_model(pro, 1e-3)
        floor = m.delta_t(0)
        m.observe(0.5, 0)                     # ignored: no events
        sched = pro.PrestageScheduler(m)
        st = buckets.WindowState(0, 10, width=1, block_capacity=8)
        sched.plan(win.WindowId(0, 10), st, exec_time=100.0, now=0.0)
        return [floor, m.floor_seconds, m.observations,
                _due(sched, 100.0 - 2 * m.floor_seconds),
                _due(sched, 100.0)]
    out = _both(run)
    assert out["torch"] == out["jax"]
    t = out["torch"]
    assert t[0] == pytest.approx(t[1])
    assert t[2:] == [1, [], [(0, 10)]]


def test_prestage_punctuated_immediate():
    def run(buckets, cleanup, ev, pro, win):
        sched = pro.PrestageScheduler(punctuated=True)
        st = buckets.WindowState(0, 10, width=1, block_capacity=8)
        sched.plan(win.WindowId(0, 10), st, exec_time=100.0, now=5.0)
        return _due(sched, 5.0)
    out = _both(run)
    assert out["torch"] == out["jax"] == [(0, 10)]


def test_prestage_punctuated_late_event_dedup():
    def run(buckets, cleanup, ev, pro, win):
        sched = pro.PrestageScheduler(punctuated=True)
        st = buckets.WindowState(0, 10, width=1, block_capacity=8)
        wid = win.WindowId(0, 10)
        sched.on_late_event(wid, st, now=5.0)
        sched.on_late_event(wid, st, now=5.0)          # deduped
        out = [sched.stats["immediate"], _due(sched, 5.0)]
        sched.on_late_event(wid, st, now=6.0)          # re-arms after due
        return out + [_due(sched, 6.0), dict(sched.stats)]
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == [1, [(0, 10)], [(0, 10)]]


def test_upcoming_hint_rearms_after_replanning():
    def run(buckets, cleanup, ev, pro, win):
        sched = pro.PrestageScheduler(_observed_model(pro, 1e-3))
        st = _late_state(buckets, ev)
        wid = win.WindowId(0, 10)
        sched.plan(wid, st, exec_time=100.0, now=0.0)
        out = [_upcoming(sched, 99.5, 1.0), _upcoming(sched, 99.5, 1.0)]
        sched.plan(wid, st, exec_time=50.0, now=0.0)   # earlier: supersedes
        return out + [_upcoming(sched, 49.5, 1.0), _due(sched, 49.95),
                      _due(sched, 101.0)]
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"] == [[(0, 10)], [], [(0, 10)], [(0, 10)], []]


def test_prestage_cancel_removes_plan():
    def run(buckets, cleanup, ev, pro, win):
        sched = pro.PrestageScheduler(_observed_model(pro, 1e-3))
        st = buckets.WindowState(0, 10, width=1, block_capacity=8)
        wid = win.WindowId(0, 10)
        sched.plan(wid, st, exec_time=100.0, now=0.0)
        planned = sched.planned_stage_at(wid)
        sched.cancel(wid)
        return [planned, sched.planned_stage_at(wid), _due(sched, 200.0),
                _upcoming(sched, 0.0, 1e6)]
    out = _both(run)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] is not None
    assert out["torch"][1:] == [None, [], []]


def test_prestage_heap_compacts_dead_entries():
    def run(buckets, cleanup, ev, pro, win):
        sched = pro.PrestageScheduler(_observed_model(pro, 1e-3))
        st = buckets.WindowState(0, 10, width=1, block_capacity=8)
        for i in range(200):
            wid = win.WindowId(i * 10.0, (i + 1) * 10.0)
            sched.plan(wid, st, exec_time=1e6 - i, now=0.0)
            sched.plan(wid, st, exec_time=1e5 - i, now=0.0)
            sched.plan(wid, st, exec_time=1e4 - i, now=0.0)
        out = [sched.stats["heap_compactions"], len(sched._heap)]
        for i in range(200):
            sched.cancel(win.WindowId(i * 10.0, (i + 1) * 10.0))
        return out + [_due(sched, 1e7), len(sched._heap)]
    out = _both(run)
    assert out["torch"] == out["jax"]
    compactions, heap, due, heap_after = out["torch"]
    assert compactions > 0
    assert heap < 2 * 200 + 32
    assert due == [] and heap_after <= 32
