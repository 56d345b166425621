"""The port's host-side control math against the JAX package: predictive
cleanup's lateness histogram and bound, and the staleness trigger.

The port computes both in numpy on the host (float64), where the JAX
package uses jnp (float32) and a jitted ``jax.grad`` descent. Tolerances:
histogram counts, bounds and purge decisions exact (the same binning);
staleness profiles within rtol 1e-5 (float32 against float64); the
optimizer's max staleness within 5% of the JAX package's, since the two
descents take different float paths from the same seed, and never worse
than its own equal-mass seed; the number of executions a staleness bound
needs equal.
"""
import numpy as np
import pytest

import repro.core.cleanup as jcleanup
import repro.core.staleness as jst
import repro_torch.core.cleanup as tcleanup
import repro_torch.core.staleness as tst

HORIZON = 40.0


def _delays(dist, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    if dist == "lnorm":
        return rng.lognormal(0.0, 1.0, n) * 3.0
    return rng.uniform(0.0, HORIZON, n)


@pytest.mark.parametrize("dist", ["lnorm", "unif"])
def test_cleanup_histogram_and_bound_match(dist):
    d = _delays(dist, seed=1)
    j = jcleanup.PredictiveCleanup(min_history=100)
    t = tcleanup.PredictiveCleanup(min_history=100)
    for chunk in np.array_split(d, 7):
        j.observe(chunk)
        t.observe(chunk)
        np.testing.assert_array_equal(np.asarray(j.hist.counts),
                                      t.hist.counts)
        assert j.hist.total == t.hist.total
        assert j.current_bound() == t.current_bound()
    for q in (0.5, 0.9, 0.99):
        assert j.hist.quantile(q) == t.hist.quantile(q)
    for delay in (0.1, 1.0, 5.0, 30.0):
        assert j.expected_late_fraction_after(delay) == \
            t.expected_late_fraction_after(delay)
    for wm in (0.0, 10.0, 100.0, 1e4):
        assert j.should_purge(5.0, wm) == t.should_purge(5.0, wm)


@pytest.mark.parametrize("dist", ["lnorm", "unif"])
def test_staleness_profile_and_baselines_match(dist):
    d = _delays(dist, seed=2)
    grid, F = tst.empirical_cdf(d, HORIZON)
    jgrid, jF = jst.empirical_cdf(d, HORIZON)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(F, jF)
    for k in (1, 4, 9):
        for times in (tst.deltat_times(HORIZON, k),
                      tst.deltaev_times(d, HORIZON, k)):
            np.testing.assert_allclose(
                tst.staleness_profile(times, grid, F, HORIZON),
                np.asarray(jst.staleness_profile(times, jgrid, jF, HORIZON)),
                rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(tst.deltat_times(HORIZON, k),
                                      jst.deltat_times(HORIZON, k))
        np.testing.assert_array_equal(tst.deltaev_times(d, HORIZON, k),
                                      jst.deltaev_times(d, HORIZON, k))


@pytest.mark.parametrize("dist", ["lnorm", "unif"])
@pytest.mark.parametrize("k", [1, 3, 7, 12])
def test_minimize_max_staleness_matches(dist, k):
    d = _delays(dist)
    j = jst.minimize_max_staleness(d, HORIZON, k)
    t = tst.minimize_max_staleness(d, HORIZON, k)
    times = np.asarray(t.times)
    assert times.shape == (k,) and times[-1] == HORIZON
    assert np.all(np.diff(times) >= 0) and times[0] > 0
    assert t.max_staleness == pytest.approx(j.max_staleness, rel=0.05)
    seed = tst.max_staleness_of(tst.deltaev_times(d, HORIZON, k), d,
                                HORIZON)
    assert t.max_staleness <= seed * (1 + 1e-9)


@pytest.mark.parametrize("dist", ["lnorm", "unif"])
def test_executions_for_bound_matches(dist):
    d = _delays(dist)

    def count(mod):
        return mod.executions_for_bound(
            lambda kk: mod.minimize_max_staleness(d, HORIZON, kk).times,
            d, HORIZON, 0.05, k_max=16)
    assert count(tst) == count(jst)
