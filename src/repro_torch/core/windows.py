"""Window assigners (paper §2): tumbling, sliding, session, count.

A window is identified by ``WindowId(start, end)`` in event-time seconds.
Assignment is vectorized over event batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass(frozen=True, order=True)
class WindowId:
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


class WindowAssigner:
    def assign(self, timestamps: np.ndarray) -> List[Tuple[WindowId, np.ndarray]]:
        """Returns [(window, index_array)] covering all events."""
        raise NotImplementedError


@dataclass
class TumblingWindows(WindowAssigner):
    size: float

    def assign(self, timestamps):
        starts = np.floor(timestamps / self.size) * self.size
        out = []
        for s in np.unique(starts):
            idx = np.nonzero(starts == s)[0]
            out.append((WindowId(float(s), float(s + self.size)), idx))
        return out


@dataclass
class SlidingWindows(WindowAssigner):
    size: float
    slide: float

    def assign(self, timestamps):
        n_overlap = int(np.ceil(self.size / self.slide))
        out: Dict[float, list] = {}
        base = np.floor(timestamps / self.slide) * self.slide
        for k in range(n_overlap):
            starts = base - k * self.slide
            valid = (timestamps >= starts) & (timestamps < starts + self.size)
            for s in np.unique(starts[valid]):
                idx = np.nonzero(valid & (starts == s))[0]
                out.setdefault(float(s), []).append(idx)
        return [(WindowId(s, s + self.size),
                 np.concatenate(v) if len(v) > 1 else v[0])
                for s, v in sorted(out.items())]


@dataclass
class SessionWindows(WindowAssigner):
    """Per-key sessions separated by >= gap. Stateless approximation over a
    batch: sessions are computed within the batch; the engine merges
    adjacent session windows on append."""
    gap: float

    def assign(self, timestamps):
        if len(timestamps) == 0:
            return []
        order = np.argsort(timestamps, kind="stable")
        ts = timestamps[order]
        breaks = np.nonzero(np.diff(ts) > self.gap)[0]
        bounds = np.concatenate([[0], breaks + 1, [len(ts)]])
        out = []
        for i in range(len(bounds) - 1):
            sel = order[bounds[i]:bounds[i + 1]]
            w = WindowId(float(timestamps[sel].min()),
                         float(timestamps[sel].max() + self.gap))
            out.append((w, np.sort(sel)))
        return out


@dataclass
class CountWindows(WindowAssigner):
    """Groups of ``count`` consecutive events (engine tracks the running
    offset; windows are keyed by sequence number encoded as start)."""
    count: int
    _offset: int = 0

    def assign(self, timestamps):
        n = len(timestamps)
        out = []
        pos = 0
        while pos < n:
            wid = (self._offset + pos) // self.count
            take = min(self.count - (self._offset + pos) % self.count, n - pos)
            out.append((WindowId(float(wid), float(wid + 1)),
                        np.arange(pos, pos + take)))
            pos += take
        self._offset += n
        return out
