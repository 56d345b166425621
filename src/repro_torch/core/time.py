"""Time domains and watermarks (paper §2).

Event-time drives window assignment; processing-time drives scheduling.
Watermarks are best guesses: events with ts < watermark are *late* and are
routed to past windows instead of being dropped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class WatermarkTracker:
    """Tracks the current watermark and classifies lateness."""
    watermark: float = -np.inf

    def advance(self, wm: float) -> bool:
        if wm > self.watermark:
            self.watermark = wm
            return True
        return False

    def lateness_of(self, timestamps: np.ndarray) -> np.ndarray:
        """Per-event lateness in seconds (<= 0 for on-time events)."""
        return self.watermark - timestamps

    def is_late(self, timestamps: np.ndarray) -> np.ndarray:
        return timestamps < self.watermark


@dataclass
class PeriodicWatermarkGenerator:
    """Emits watermark = max_seen_ts - slack every ``period`` seconds of
    processing time (paper: periodic watermarks make re-execution times
    predictable — the proactive cache exploits that)."""
    period: float
    slack: float = 0.0
    _last_emit: float = field(default=-np.inf, repr=False)
    _max_ts: float = field(default=-np.inf, repr=False)

    def observe(self, timestamps: np.ndarray) -> None:
        if len(timestamps):
            self._max_ts = max(self._max_ts, float(np.max(timestamps)))

    def maybe_emit(self, processing_time: float) -> Optional[float]:
        if processing_time - self._last_emit >= self.period and \
                np.isfinite(self._max_ts):
            self._last_emit = processing_time
            return self._max_ts - self.slack
        return None


@dataclass
class PunctuatedWatermarkGenerator:
    """Emits when a data-dependent predicate fires (e.g. a flush event)."""
    predicate: Callable[[np.ndarray, np.ndarray], Optional[float]]

    def observe_and_maybe_emit(self, keys: np.ndarray,
                               timestamps: np.ndarray) -> Optional[float]:
        return self.predicate(keys, timestamps)
