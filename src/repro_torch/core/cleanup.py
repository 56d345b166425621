"""Predictive cleanup (paper §3.4): adaptively bound allowed lateness from
the observed distribution of late-event delays, and purge window state that
is very unlikely to receive more events.

The engine starts with a conservatively large bound; once a representative
history is collected, the bound is adjusted for newly created windows to
cover a target fraction of late events (e.g. 99%) *within a confidence
interval*: we take a one-sided Dvoretzky–Kiefer–Wolfowitz band on the
empirical CDF, i.e. pick the smallest delay T with

    F_hat(T) - sqrt(ln(1/delta) / (2 n))  >=  coverage

so that with confidence (1 - delta) the true CDF at T is >= coverage.
The distribution keeps updating with new observations (including events
later than the current bound), keeping the estimate current.

This is scalar host-side control math: the histogram is a numpy array
updated with ``np.add.at`` on the host, where the delay batches already
are (they have ragged shapes, so a device update would buy nothing). The
JAX package's unused jitted ``_hist_update`` is not carried over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class LatenessHistogram:
    """Streaming log-spaced histogram of late-event delays (seconds)."""
    min_delay: float = 1e-3
    max_delay: float = 1e6
    num_bins: int = 256
    counts: np.ndarray = None
    total: int = 0

    def __post_init__(self):
        if self.counts is None:
            self.counts = np.zeros((self.num_bins,), np.float32)
        lo, hi = math.log(self.min_delay), math.log(self.max_delay)
        self._edges = np.exp(np.linspace(lo, hi, self.num_bins + 1))

    @property
    def edges(self) -> np.ndarray:
        return self._edges

    def update(self, delays: np.ndarray) -> None:
        delays = np.asarray(delays, np.float64)
        delays = delays[delays > 0]
        if len(delays) == 0:
            return
        idx = np.clip(np.searchsorted(self._edges, delays) - 1, 0,
                      self.num_bins - 1)
        counts = np.asarray(self.counts, np.float32).copy()
        np.add.at(counts, idx, 1.0)
        self.counts = counts
        self.total += len(delays)

    def cdf(self) -> Tuple[np.ndarray, np.ndarray]:
        """(delay_grid, F_hat) at bin upper edges."""
        c = np.asarray(self.counts, np.float64)
        tot = c.sum()
        if tot == 0:
            return self._edges[1:], np.zeros(self.num_bins)
        return self._edges[1:], np.cumsum(c) / tot

    def quantile(self, q: float) -> float:
        grid, F = self.cdf()
        idx = np.searchsorted(F, q)
        return float(grid[min(idx, len(grid) - 1)])


@dataclass
class PredictiveCleanup:
    """Maintains the adaptive allowed-lateness bound and purge decisions."""
    coverage: float = 0.99
    confidence: float = 0.95
    initial_bound: float = 3600.0     # conservative start (paper)
    min_history: int = 200            # 'representative history'
    hist: LatenessHistogram = field(default_factory=LatenessHistogram)
    _bound: float = None

    def __post_init__(self):
        if self._bound is None:
            self._bound = self.initial_bound

    def observe(self, delays: np.ndarray) -> None:
        self.hist.update(delays)

    def current_bound(self) -> float:
        """Smallest T with DKW-lower-bounded coverage; falls back to the
        conservative initial bound until history is representative."""
        n = self.hist.total
        if n < self.min_history:
            return self._bound
        eps = math.sqrt(math.log(1.0 / (1.0 - self.confidence)) / (2.0 * n))
        grid, F = self.hist.cdf()
        ok = F - eps >= self.coverage
        if not ok.any():
            return self._bound
        self._bound = float(grid[int(np.argmax(ok))])
        return self._bound

    def expected_late_fraction_after(self, delay: float) -> float:
        """1 - F_hat(delay): the residual-usefulness estimate."""
        grid, F = self.hist.cdf()
        idx = np.searchsorted(grid, delay)
        if idx >= len(F):
            return 0.0
        return float(1.0 - F[idx])

    def should_purge(self, window_end: float, watermark: float) -> bool:
        """Purge when the window has been expired longer than the adaptive
        bound (more late events are unlikely at the target coverage)."""
        return (watermark - window_end) > self.current_bound()
