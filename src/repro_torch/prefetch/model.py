"""Online lateness + staging-cost models for learned prefetching.

The fixed-margin scheme predicts *when* to pre-stage from one EWMA of
staging seconds per event. This module supplies what the planner needs
beyond that:

* ``LatenessModel`` — per key-class empirical lateness CDFs, fit with
  the same ``core.staleness.empirical_cdf`` the predictive-cleanup /
  staleness-trigger machinery already uses (Zapridou & Ailamaki's
  "model late-arrival rates online", reusing the paper's own fits). A
  window's re-execution probability at watermark age ``a`` is the
  class-mixture survival ``1 - F(a)`` weighted by the late-event key
  classes observed for that window — windows whose keys stopped
  arriving stop being prefetched, regardless of the global tail.
* ``LearnedCostModel`` — a drop-in for ``StagingCostModel`` (the engine
  feeds it through ``prestage.cost.observe``) extended with an online
  store-bandwidth estimate (``observe_bytes`` / ``delta_t_bytes``) that
  the planner prices segment sweeps with.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.staleness import empirical_cdf
from repro_torch.core.windows import WindowId


class LearnedCostModel:
    """``StagingCostModel``-compatible cost estimate + bandwidth view.

    Per-event lead (``observe``/``delta_t``) follows the fixed model's
    contract — pessimistic ``+inf`` before the first observation, EWMA
    with a floor after — so the engine's ``prestage.cost.observe`` call
    and the heap-based plan timing need no changes. The bytes view
    (``observe_bytes``/``delta_t_bytes``) is fed by measured segment
    sweeps and prices the planner's bandwidth/slack decisions."""

    def __init__(self, *, prior_bandwidth_bytes_per_s: float = 64e6,
                 alpha: float = 0.3, floor_seconds: float = 1e-3):
        self.seconds_per_event = 1e-6
        self.alpha = alpha
        self.observations = 0
        self.floor_seconds = floor_seconds
        self._bandwidth = max(prior_bandwidth_bytes_per_s, 1.0)
        self.bandwidth_observations = 0

    # ------------------------------------------------ per-event (engine)
    def observe(self, seconds: float, events: int) -> None:
        if events <= 0:
            return
        per_event = seconds / events
        if self.observations == 0:
            self.seconds_per_event = per_event
        else:
            self.seconds_per_event = (
                self.alpha * per_event
                + (1 - self.alpha) * self.seconds_per_event)
        self.observations += 1

    def delta_t(self, events: int) -> float:
        if self.observations == 0:
            return float("inf")        # pessimistic first lead (§3.2)
        return max(self.seconds_per_event * max(events, 0),
                   self.floor_seconds)

    # ------------------------------------------------ bytes (planner)
    def observe_bytes(self, seconds: float, nbytes: int) -> None:
        """One measured store read (a segment sweep): update the
        bandwidth EWMA. Sub-microsecond timings are floored so a cached
        or page-cache-served sweep cannot drive the estimate to +inf."""
        if nbytes <= 0:
            return
        bw = nbytes / max(seconds, 1e-6)
        if self.bandwidth_observations == 0:
            self._bandwidth = bw
        else:
            self._bandwidth = (self.alpha * bw
                               + (1 - self.alpha) * self._bandwidth)
        self.bandwidth_observations += 1

    @property
    def bandwidth_bytes_per_s(self) -> float:
        return self._bandwidth

    def delta_t_bytes(self, nbytes: int) -> float:
        """Estimated seconds to read ``nbytes`` from the store."""
        return max(nbytes, 0) / self._bandwidth


class LatenessModel:
    """Per key-class empirical lateness CDFs, fit online.

    Late events arrive as ``(key, delay)`` samples; keys hash into
    ``num_classes`` classes, each keeping a bounded ring of recent
    delays. CDFs are re-fit lazily (every ``refit_every`` new samples
    per class) through ``core.staleness.empirical_cdf`` on a shared
    horizon that tracks the largest delay seen. Per-window class-count
    vectors (bounded LRU) weight the mixture when predicting one
    window's re-execution probability."""

    def __init__(self, *, num_classes: int = 8, max_samples: int = 4096,
                 refit_every: int = 128, grid_size: int = 256,
                 max_windows: int = 4096):
        self.num_classes = max(int(num_classes), 1)
        per_class = max(max_samples // self.num_classes, 64)
        self._delays: Tuple[Deque[float], ...] = tuple(
            deque(maxlen=per_class) for _ in range(self.num_classes))
        self._fresh = np.zeros(self.num_classes, np.int64)
        self.refit_every = max(int(refit_every), 1)
        self.grid_size = grid_size
        self._cdfs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._horizon = 1.0
        self._fit_horizon = 0.0
        self.samples = 0
        # window -> per-class late-event counts (bounded: oldest evicts)
        self._window_classes: "OrderedDict[WindowId, np.ndarray]" = \
            OrderedDict()
        self.max_windows = max_windows

    # ------------------------------------------------------------ updates
    def _class_of(self, keys: np.ndarray) -> np.ndarray:
        return np.abs(np.asarray(keys, np.int64)) % self.num_classes

    def observe(self, window: Optional[WindowId], keys: np.ndarray,
                delays: np.ndarray) -> None:
        """Record late-event delay samples (and their key classes) for
        ``window``. ``window=None`` updates only the class CDFs."""
        delays = np.asarray(delays, np.float64)
        if delays.size == 0:
            return
        classes = self._class_of(keys)
        self.samples += delays.size
        dmax = float(delays.max())
        if dmax > self._horizon:
            self._horizon = dmax
        for c in np.unique(classes):
            sel = delays[classes == c]
            self._delays[int(c)].extend(sel.tolist())
            self._fresh[int(c)] += sel.size
        if window is not None:
            counts = self._window_classes.get(window)
            if counts is None:
                if len(self._window_classes) >= self.max_windows:
                    self._window_classes.popitem(last=False)
                counts = np.zeros(self.num_classes, np.float64)
                self._window_classes[window] = counts
            else:
                self._window_classes.move_to_end(window)
            np.add.at(counts, classes, 1.0)

    def forget(self, window: WindowId) -> None:
        """Drop per-window state (the engine purged the window)."""
        self._window_classes.pop(window, None)

    # -------------------------------------------------------- predictions
    def _cdf(self, c: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        buf = self._delays[c]
        if not buf:
            return None
        horizon = self._horizon * 1.05
        stale = (self._fresh[c] >= self.refit_every
                 or horizon > self._fit_horizon * 1.5)
        cached = self._cdfs.get(c)
        if cached is None or stale:
            cached = empirical_cdf(np.asarray(buf, np.float64), horizon,
                                   self.grid_size)
            self._cdfs[c] = cached
            self._fresh[c] = 0
            self._fit_horizon = max(self._fit_horizon, horizon)
        return cached

    def survival(self, c: int, age: float) -> float:
        """P(a late event of class ``c`` arrives later than ``age``)."""
        cdf = self._cdf(c)
        if cdf is None:
            return 1.0                 # no data: stay pessimistic
        grid, F = cdf
        return float(np.clip(1.0 - np.interp(age, grid, F), 0.0, 1.0))

    def reexec_probability(self, window: Optional[WindowId],
                           age: float) -> float:
        """P(more late events after watermark age ``age``) for
        ``window`` — the class-mixture survival weighted by the window's
        observed late-event classes (uniform over observed classes when
        the window is unknown). With no samples at all the model is
        pessimistic (1.0): the first re-execution is always worth
        prefetching, matching the fixed scheme's pessimistic first
        lead."""
        if self.samples == 0:
            return 1.0
        counts = None
        if window is not None:
            counts = self._window_classes.get(window)
        if counts is None or counts.sum() <= 0:
            weights = np.array([len(b) for b in self._delays], np.float64)
        else:
            weights = counts
        total = weights.sum()
        if total <= 0:
            return 1.0
        p = 0.0
        for c in np.nonzero(weights)[0]:
            p += weights[c] * self.survival(int(c), age)
        return float(np.clip(p / total, 0.0, 1.0))

    def expected_residual_delay(self, age: float, q: float = 0.5) -> float:
        """Conditional quantile of the next late-event delay given the
        window already aged ``age`` (pooled over classes) — the planner's
        slack extension when a staging deadline is not yet known."""
        pooled = [d for buf in self._delays for d in buf if d > age]
        if not pooled:
            return 0.0
        return float(np.quantile(np.asarray(pooled, np.float64), q) - age)
