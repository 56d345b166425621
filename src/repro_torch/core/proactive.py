"""Proactive caching (paper §3.2): predict when a window will (re-)execute
and pre-stage its p-bucket state Δt ahead of that time.

* Periodic watermarks make re-execution times predictable: the engine knows
  the watermark period and the trigger's planned execution times. For the
  *first* late re-execution of window w, pre-staging starts pessimistically
  when the window preceding w fully expires; during that staging we measure
  Δt (staging seconds) weighted by the number of staged events, and use the
  per-event estimate for all subsequent pre-stagings.
* Punctuated watermarks carry no period: pre-staging starts as soon as a
  late event for w arrives (the re-execution it predicts may be delayed
  until pre-staging concludes).

This module is the paper's *fixed-margin* scheme: whole windows,
a Δt lead from one EWMA. The learned, segment-granular upgrade lives in
``repro.prefetch`` (``AionConfig.prefetch_backend="learned"``) and keeps
this scheduler's interface — the engine talks to either through the same
five methods (plan / on_late_event / due / drive_readahead / cancel).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.buckets import WindowState
from repro_torch.core.windows import WindowId

# rebuild the plan heap once dead (superseded/cancelled) entries
# outnumber live ones AND there are enough of them to matter — lazy
# compaction keeps plan()/cancel() O(log n) while bounding the garbage
# that due()/upcoming() would otherwise scan forever
_HEAP_COMPACT_MIN = 16


@dataclass
class StagingCostModel:
    """Online Δt estimate: EWMA of staging seconds per event (the paper's
    'overall time taken weighted by the number of staged events').

    Before the FIRST observation the model is deliberately pessimistic:
    ``delta_t`` returns ``+inf`` so the first pre-staging starts as early
    as possible (the paper starts it when the preceding window fully
    expires). Afterwards the lead is clamped to ``floor_seconds`` —
    ``observe`` ignores zero-event stagings, so without the floor a
    window whose p-bucket happens to be empty at plan time would collapse
    the margin to exactly ``min_margin`` (or zero)."""
    seconds_per_event: float = 1e-6
    alpha: float = 0.3
    observations: int = 0
    # lower bound on the per-staging lead once observations exist
    floor_seconds: float = 1e-3

    def observe(self, seconds: float, events: int) -> None:
        if events <= 0:
            return
        per_event = seconds / events
        if self.observations == 0:
            self.seconds_per_event = per_event
        else:
            self.seconds_per_event = (self.alpha * per_event
                                      + (1 - self.alpha) * self.seconds_per_event)
        self.observations += 1

    def delta_t(self, events: int) -> float:
        if self.observations == 0:
            # first re-execution: no measurement yet — pre-stage as early
            # as the plan allows (pessimistic lead, paper §3.2)
            return float("inf")
        return max(self.seconds_per_event * max(events, 0),
                   self.floor_seconds)


@dataclass(order=True)
class _Planned:
    stage_at: float
    window: WindowId = field(compare=False)


class PrestageScheduler:
    """Decides *when* to issue stage requests for past windows.

    ``plan(window, exec_time, now)`` registers a future re-execution;
    ``due(now)`` returns windows whose pre-staging should start now.
    """

    def __init__(self, cost_model: Optional[StagingCostModel] = None,
                 punctuated: bool = False):
        self.cost = cost_model or StagingCostModel()
        self.punctuated = punctuated
        self._heap: List[_Planned] = []
        self._planned: Dict[WindowId, float] = {}
        self._hinted: Dict[WindowId, float] = {}
        # superseded/cancelled entries still sitting in _heap
        self._dead = 0
        self.stats = {"planned": 0, "immediate": 0, "readahead_hints": 0,
                      "heap_compactions": 0}

    def plan(self, window: WindowId, state: WindowState,
             exec_time: float, now: float,
             min_margin: float = 0.0) -> None:
        """Schedule pre-staging Δt before exec_time (clamped to now).

        ``min_margin``: lower bound on the lead time — the paper starts the
        *first* pre-staging pessimistically a full window ahead; the engine
        passes a fraction of the watermark period so the lead survives
        virtual-clock/wall-clock scale differences."""
        if self.punctuated:
            # no predictable re-execution time: stage immediately
            self.on_late_event(window, state, now)
            return
        p_events = sum(b.fill for b in state.p_blocks())
        dt = max(self.cost.delta_t(p_events), min_margin)
        stage_at = max(exec_time - dt, now)
        self._push(window, stage_at, "planned")

    def on_late_event(self, window: WindowId, state: WindowState,
                      now: float) -> None:
        """Punctuated mode: a late event predicts an upcoming re-execution."""
        if self._planned.get(window) == now:
            return
        self._push(window, now, "immediate", supersede_later=True)

    def observe_late(self, window: WindowId, keys: np.ndarray,
                     delays: np.ndarray) -> None:
        """Lateness observations (per-key delay samples). The fixed
        scheduler has no lateness model — the learned scheduler
        (``repro.prefetch``) overrides this hook."""

    def _push(self, window: WindowId, stage_at: float, stat: str,
              supersede_later: bool = False) -> None:
        prev = self._planned.get(window)
        if prev is not None:
            if not supersede_later and prev <= stage_at:
                return
            # the old heap entry becomes a tombstone
            self._dead += 1
        self._planned[window] = stage_at
        heapq.heappush(self._heap, _Planned(stage_at, window))
        self.stats[stat] += 1
        self._compact_heap()

    def _compact_heap(self) -> None:
        """Lazy tombstone reclamation: superseded plans and ``cancel``ed
        windows leave dead entries in ``_heap`` (a binary heap has no
        O(log n) remove). Once they dominate, rebuild the heap from the
        live plan map — keeps ``upcoming``'s scan and ``due``'s pops
        proportional to live plans instead of all plans ever made."""
        if self._dead < _HEAP_COMPACT_MIN or self._dead * 2 < len(self._heap):
            return
        self._heap = [_Planned(t, w) for w, t in self._planned.items()]
        heapq.heapify(self._heap)
        self._dead = 0
        self.stats["heap_compactions"] += 1

    def planned_stage_at(self, window: WindowId) -> Optional[float]:
        """Live staging deadline for ``window`` (None if not planned)."""
        return self._planned.get(window)

    def due(self, now: float) -> List[WindowId]:
        out = []
        while self._heap and self._heap[0].stage_at <= now:
            item = heapq.heappop(self._heap)
            if self._planned.get(item.window) == item.stage_at:
                del self._planned[item.window]
                self._hinted.pop(item.window, None)
                out.append(item.window)
            else:
                self._dead = max(self._dead - 1, 0)    # popped a tombstone
        return out

    def upcoming(self, now: float, horizon: float) -> List[WindowId]:
        """Windows whose pre-staging starts within ``horizon`` — the
        store-readahead hook: the engine drives the persistent tier's
        batched prefetch for these BEFORE their staging deadline, so the
        stage itself finds its blocks in the store's read cache. Each
        planned staging is hinted once (re-planning re-arms it)."""
        out = []
        for item in self._heap:
            stage_at = self._planned.get(item.window)
            if stage_at != item.stage_at:
                continue                       # tombstone (dead entry)
            if now <= stage_at <= now + horizon \
                    and self._hinted.get(item.window) != stage_at:
                self._hinted[item.window] = stage_at
                self.stats["readahead_hints"] += 1
                out.append(item.window)
        return out

    def drive_readahead(self, engine, now: float, horizon: float) -> None:
        """Fixed-margin readahead: point (per-window) store prefetch for
        the stagings coming up within the lead margin. The learned
        scheduler replaces this with segment-granular sweeps planned
        against a bandwidth/slack cost model."""
        if engine.io.store is None:
            return
        for wid in self.upcoming(now, horizon):
            state = engine.windows.get(wid)
            if state is not None:
                engine.io.request_readahead(state)

    def cancel(self, window: WindowId) -> None:
        if self._planned.pop(window, None) is not None:
            self._dead += 1                    # heap entry left behind
        self._hinted.pop(window, None)
        self._compact_heap()
