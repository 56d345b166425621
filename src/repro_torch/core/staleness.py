"""Staleness-minimizing trigger (paper §3.4, evaluated in Q4).

Staleness between consecutive executions at times ``0 = x_0 < x_1 < ... <
x_K = T`` of a past window is

    st_i = (x_i - x_{i-1}) / T  *  (F(x_i) - F(x_{i-1}))      (= t·n / (T·N))

where F is the CDF of late-event arrival delays. Given a budget of K
executions, the trigger places x_1..x_{K-1} (x_K = T is the final
execution at maximum allowed lateness) to minimize ``max_i st_i``.

Algorithm (faithful to the paper):
  1. *Seed* execution times where the distribution has high relative
     density — equal-mass placement x_i = F^{-1}(i/K). (This seed equals
     the ``deltaev`` trigger; the optimizer strictly improves on it.)
  2. *Balance* by a variation of gradient descent: descend the smoothed
     max (temperature-annealed logsumexp) of the staleness vector w.r.t.
     the execution times, projecting back to monotonic order, until the
     standard deviation of the st_i is ~0 or an iteration cap is reached.

This is scalar host-side control math over a few dozen execution times,
so it runs in numpy on the host: the smoothed max's gradient is written
out in closed form (the staleness profile is piecewise linear in each
execution time), and the JAX package's ``jax.grad`` + ``while_loop`` loop
becomes a plain loop with the same seed, annealing, projection and stop
rules.

Reference triggers (paper Fig. 9): ``deltat`` executes every T/K seconds;
``deltaev`` every N/K events.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np


def empirical_cdf(delays: np.ndarray, horizon: float,
                  grid_size: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Empirical CDF of delays clipped to [0, horizon], on a uniform grid
    (interp-friendly representation shared by all triggers)."""
    delays = np.asarray(delays, np.float64)
    delays = delays[(delays > 0) & np.isfinite(delays)]
    grid = np.linspace(0.0, horizon, grid_size)
    if len(delays) == 0:
        return grid, grid / max(horizon, 1e-12)     # degenerate: uniform
    delays = np.clip(delays, 0.0, horizon)
    F = np.searchsorted(np.sort(delays), grid, side="right") / len(delays)
    return grid, F


def _interp_cdf(x, grid, F):
    """F at ``x`` by linear interpolation, and its slope dF/dx (0 outside
    the grid and on zero-width segments, as ``jnp.interp``'s gradient)."""
    x = np.asarray(x, np.float64)
    i = np.clip(np.searchsorted(grid, x, side="right"), 1, len(grid) - 1)
    df = F[i] - F[i - 1]
    dx = grid[i] - grid[i - 1]
    flat = np.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    slope = np.where(flat, 0.0, df / np.where(flat, 1.0, dx))
    f = np.where(flat, F[i - 1], F[i - 1] + (x - grid[i - 1]) * slope)
    out = (x < grid[0]) | (x > grid[-1])
    f = np.where(x < grid[0], F[0], np.where(x > grid[-1], F[-1], f))
    return f, np.where(out, 0.0, slope)


def staleness_profile(times, grid, F, horizon) -> np.ndarray:
    """st_i for the execution-time vector (K entries, last must be T)."""
    xs = np.concatenate([[0.0], np.asarray(times, np.float64)])
    Fx, _ = _interp_cdf(xs, np.asarray(grid), np.asarray(F))
    return np.diff(xs) / horizon * np.diff(Fx)


def _profile_and_grad(inner, grid, F, horizon, tau):
    """Staleness profile of ``inner + [T]`` and the gradient of its
    smoothed max ``tau * logsumexp(st / tau)`` with respect to ``inner``."""
    xs = np.concatenate([[0.0], inner, [horizon]])
    Fx, slope = _interp_cdf(xs, grid, F)
    dt = np.diff(xs) / horizon
    dF = np.diff(Fx)
    st = dt * dF
    z = st / tau
    p = np.exp(z - z.max())
    p /= p.sum()
    # st_m depends on xs[m] (-) and xs[m+1] (+); inner[j] is xs[j+1]
    s_in = slope[1:-1]
    g = p[:-1] * (dF[:-1] / horizon + dt[:-1] * s_in) \
        - p[1:] * (dF[1:] / horizon + dt[1:] * s_in)
    return st, g


def _optimize(grid: np.ndarray, F: np.ndarray, horizon: float, k: int,
              max_iters: int, tol: float, lr: float):
    # --- seed: equal-mass placement (high relative density regions)
    qs = np.arange(1, k) / k
    seed_inner = np.interp(qs, F, grid)       # F^{-1}(i/k)
    seed_inner = np.sort(np.clip(seed_inner, horizon * 1e-4,
                                 horizon * (1 - 1e-4)))

    def full_times(inner):
        return np.concatenate([inner, [horizon]])

    inner = best_inner = seed_inner
    best_val = float(np.max(staleness_profile(full_times(seed_inner), grid,
                                              F, horizon)))
    i = stall = 0
    while i < max_iters and stall < 64:
        st = staleness_profile(full_times(inner), grid, F, horizon)
        # anneal the temperature toward a hard max
        tau = max(float(np.max(st)) * 0.5 ** (i / 64.0 + 1), 1e-12)
        _, g = _profile_and_grad(inner, grid, F, horizon, tau)
        step = lr * horizon
        new_inner = inner - step * g / (np.max(np.abs(g)) + 1e-12)
        # project to monotonic order inside (0, T)
        new_inner = np.clip(np.sort(new_inner),
                            horizon * 1e-6, horizon * (1 - 1e-6))
        new_st = staleness_profile(full_times(new_inner), grid, F, horizon)
        new_val = float(np.max(new_st))
        if new_val < best_val:
            best_inner = new_inner
        stall = 0 if new_val < best_val - 1e-12 else stall + 1
        best_val = min(new_val, best_val)
        # stop when staleness is balanced (std ~ 0)
        if np.std(new_st) < tol * max(float(np.mean(new_st)), 1e-12):
            stall = 1_000_000
        inner = new_inner
        i += 1
    return full_times(best_inner), best_val


@dataclass
class StalenessTriggerResult:
    times: np.ndarray          # K execution times in (0, T]
    max_staleness: float


def minimize_max_staleness(delays: np.ndarray, horizon: float, k: int,
                           max_iters: int = 512, tol: float = 1e-3,
                           lr: float = 0.02,
                           grid_size: int = 512) -> StalenessTriggerResult:
    """AION trigger: place k executions minimizing max staleness."""
    if k < 1:
        raise ValueError("need at least one execution")
    grid, F = empirical_cdf(delays, horizon, grid_size)
    if k == 1:
        times = np.array([horizon])
        st = float(np.max(staleness_profile(times, grid, F, horizon)))
        return StalenessTriggerResult(times, st)
    times, val = _optimize(np.asarray(grid), np.asarray(F),
                           float(horizon), int(k), int(max_iters),
                           float(tol), float(lr))
    return StalenessTriggerResult(np.asarray(times), float(val))


# ----------------------------------------------------------------- baselines

def deltat_times(horizon: float, k: int) -> np.ndarray:
    """Periodic in processing time: every T/k."""
    return np.linspace(horizon / k, horizon, k)


def deltaev_times(delays: np.ndarray, horizon: float, k: int) -> np.ndarray:
    """Every N/k events: equal-mass quantiles of the arrival distribution."""
    grid, F = empirical_cdf(delays, horizon)
    qs = np.arange(1, k + 1) / k
    t = np.interp(qs, F, grid)
    t[-1] = horizon
    return np.maximum.accumulate(t)


def max_staleness_of(times: np.ndarray, delays: np.ndarray,
                     horizon: float) -> float:
    grid, F = empirical_cdf(delays, horizon)
    st = staleness_profile(np.asarray(times, np.float64), grid, F, horizon)
    return float(np.max(st))


def executions_for_bound(trigger: Callable[[int], np.ndarray],
                         delays: np.ndarray, horizon: float, bound: float,
                         k_max: int = 64) -> Optional[int]:
    """Minimum number of executions for which max staleness <= bound
    (paper Fig. 9 right: compared across triggers and distributions)."""
    for k in range(1, k_max + 1):
        times = trigger(k)
        if max_staleness_of(times, delays, horizon) <= bound:
            return k
    return None
