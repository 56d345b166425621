"""Trigger zoo (paper §2 'Triggering' + §3.4).

A trigger decides *when* a past (expired) window re-executes to fold in
late events. The engine asks ``plan(window)`` once the window expires (and
re-plans when the lateness distribution shifts); the returned offsets are
absolute seconds after expiry.

``AionStalenessTrigger`` uses the staleness optimizer with the adaptive
lateness bound from predictive cleanup: minimum executions to satisfy the
user's max-staleness SLA, placed to balance staleness.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.cleanup import PredictiveCleanup
from repro_torch.core.staleness import (
    deltaev_times, deltat_times, executions_for_bound,
    minimize_max_staleness,
)


class Trigger:
    def plan(self, horizon: float) -> np.ndarray:
        """Execution-time offsets in (0, horizon]."""
        raise NotImplementedError


@dataclass
class DeltaTTrigger(Trigger):
    """Re-execute every ``period`` seconds (punctuated periodic baseline)."""
    executions: int = 8

    def plan(self, horizon: float) -> np.ndarray:
        return deltat_times(horizon, self.executions)


@dataclass
class DeltaEvTrigger(Trigger):
    """Re-execute every N/k expected events."""
    executions: int = 8
    cleanup: Optional[PredictiveCleanup] = None

    def _delays(self, horizon: float) -> np.ndarray:
        if self.cleanup is None or self.cleanup.hist.total == 0:
            return np.linspace(0, horizon, 128)
        grid, F = self.cleanup.hist.cdf()
        # sample representative delays from the histogram CDF
        qs = (np.arange(1, 257)) / 257.0
        return np.interp(qs, F, grid) if F[-1] > 0 else grid[:128]

    def plan(self, horizon: float) -> np.ndarray:
        return deltaev_times(self._delays(horizon), horizon,
                             self.executions)


@dataclass
class AionStalenessTrigger(Trigger):
    """Minimum executions meeting ``max_staleness``, optimally placed."""
    cleanup: PredictiveCleanup
    max_staleness: float = 0.05
    k_max: int = 64
    last_k: int = field(default=0, init=False)

    def _delays(self, horizon: float) -> np.ndarray:
        if self.cleanup.hist.total == 0:
            return np.linspace(0, horizon, 128)
        grid, F = self.cleanup.hist.cdf()
        qs = (np.arange(1, 513)) / 513.0
        return np.interp(qs, F, grid) if F[-1] > 0 else grid[:128]

    def plan(self, horizon: float) -> np.ndarray:
        delays = self._delays(horizon)
        k = executions_for_bound(
            lambda kk: minimize_max_staleness(delays, horizon, kk).times,
            delays, horizon, self.max_staleness, self.k_max)
        if k is None:
            k = self.k_max
        self.last_k = k
        return minimize_max_staleness(delays, horizon, k).times
