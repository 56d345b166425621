"""``LearnedPrestageScheduler`` — the drop-in ``PrestageScheduler``
front for the learned prefetch backend.

The engine keeps talking to the same five-method surface (plan /
on_late_event / due / drive_readahead / cancel); underneath, the
deadline bookkeeping is still the fixed scheduler's heap (timing is a
solved problem there), while *what* gets read ahead, *how*, and
*whether* it is worth it becomes model-driven:

* ``observe_late`` feeds per-key lateness samples into the
  ``LatenessModel`` (``core.staleness`` empirical-CDF fits per
  key-class).
* ``drive_readahead`` replaces the per-window point readahead with the
  ``SegmentPrefetchPlanner``: candidate windows are gated by predicted
  re-execution probability, mapped to log segments, merged into
  sequential sweeps priced against the learned store bandwidth, and —
  for hot scattered windows — queued for coalescing rewrites.
* ``readahead_now`` is the pipelined hook (``engine.prefetch_round``):
  sweep whatever the busy device round will need, ahead of the stage
  requests, at the same transfer priority so the sweeps actually run
  first.
"""
from __future__ import annotations

import math
from typing import List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.buckets import Tier, WindowState
from repro_torch.core.proactive import PrestageScheduler
from repro_torch.core.windows import WindowId
from repro_torch.prefetch.model import LatenessModel, LearnedCostModel
from repro_torch.prefetch.planner import SegmentPrefetchPlanner


def _storage_keys(state: WindowState) -> List[Tuple[Tuple[float, float], int]]:
    return [(b.window_key, b.block_id) for b in state.blocks
            if b.tier == Tier.STORAGE and not b.dropped and b.in_storage
            and b.window_key is not None]


class LearnedPrestageScheduler:
    """Lateness-model-driven, segment-granular prefetch scheduler."""

    segment_granular = True

    def __init__(self, aion, *, punctuated: bool = False,
                 margin: float = 0.0):
        self.aion = aion
        self.margin = margin
        self.cost = LearnedCostModel(
            prior_bandwidth_bytes_per_s=aion.prefetch_bandwidth_bytes_per_s)
        self.model = LatenessModel(num_classes=aion.prefetch_key_classes)
        self._base = PrestageScheduler(self.cost, punctuated=punctuated)
        budget = aion.prefetch_budget_bytes or aion.store_readahead_bytes
        self.planner = SegmentPrefetchPlanner(
            self.cost, budget_bytes=budget,
            coalesce=aion.prefetch_coalesce,
            coalesce_probability=aion.prefetch_coalesce_probability)
        # windows hinted by upcoming() whose sweeps were deferred (over
        # budget / too much slack) — carried to the next drive
        self._pending: Set[WindowId] = set()
        self.stats_extra = {"windows_considered": 0,
                            "windows_skipped_low_probability": 0,
                            "point_fallbacks": 0}

    # ------------------------------------------------- PrestageScheduler API
    @property
    def punctuated(self) -> bool:
        return self._base.punctuated

    @property
    def stats(self) -> dict:
        out = dict(self._base.stats)
        out.update(self.planner.stats)
        out.update(self.stats_extra)
        return out

    def plan(self, window: WindowId, state: WindowState, exec_time: float,
             now: float, min_margin: float = 0.0) -> None:
        self._base.plan(window, state, exec_time, now, min_margin)

    def on_late_event(self, window: WindowId, state: WindowState,
                      now: float) -> None:
        self._base.on_late_event(window, state, now)

    def observe_late(self, window: WindowId, keys: np.ndarray,
                     delays: np.ndarray) -> None:
        self.model.observe(window, keys, delays)

    def planned_stage_at(self, window: WindowId) -> Optional[float]:
        return self._base.planned_stage_at(window)

    def due(self, now: float) -> List[WindowId]:
        out = self._base.due(now)
        for wid in out:
            self._pending.discard(wid)
        return out

    def upcoming(self, now: float, horizon: float) -> List[WindowId]:
        return self._base.upcoming(now, horizon)

    def cancel(self, window: WindowId) -> None:
        self._base.cancel(window)
        self._pending.discard(window)
        self.model.forget(window)
        self.planner.forget(window)

    # ------------------------------------------------------------ readahead
    def drive_readahead(self, engine, now: float, horizon: float) -> None:
        io = engine.io
        if io.store is None:
            return
        eff_horizon = self.aion.prefetch_horizon or 4.0 * horizon
        self._pending.update(self._base.upcoming(now, eff_horizon))
        if not self._pending:
            return

        wm = engine.tracker.watermark
        wants = []
        for wid in list(self._pending):
            stage_at = self._base.planned_stage_at(wid)
            state = engine.windows.get(wid)
            if stage_at is None or state is None:
                self._pending.discard(wid)
                continue
            keys = _storage_keys(state)
            if not keys:
                self._pending.discard(wid)
                continue
            self.stats_extra["windows_considered"] += 1
            age = max(wm - wid.end, 0.0) if math.isfinite(wm) else 0.0
            p = self.model.reexec_probability(wid, age)
            if p < self.aion.prefetch_min_probability:
                # model says this window's keys went quiet: not worth
                # cache space now — re-evaluated on the next drive
                self.stats_extra["windows_skipped_low_probability"] += 1
                continue
            wants.append((wid, stage_at, keys, p))
        if not wants:
            return

        if not hasattr(io.store, "segments_for") \
                or not hasattr(io, "request_segment_readahead"):
            # npz-style store: no segment index — point readahead
            for wid, _sa, _k, _p in wants:
                state = engine.windows.get(wid)
                if state is not None:
                    io.request_readahead(state)
                    self.stats_extra["point_fallbacks"] += 1
                self._pending.discard(wid)
            return

        result = self.planner.plan(io.store, wants, now)
        for sweep in result.sweeps:
            io.request_segment_readahead(sweep.sid, sweep.keys,
                                         on_swept=self.cost.observe_bytes)
        # satisfied windows leave the pending set; deferred sweeps (over
        # budget / ample slack) keep theirs queued for the next drive
        self._pending -= {wid for wid, _sa, _k, _p in wants}
        self._pending |= result.deferred_windows
        if result.coalesce and hasattr(io, "request_coalesce"):
            io.request_coalesce(
                [(wid.start, wid.end) for wid in result.coalesce])

    def readahead_now(self, io, states: List[WindowState]) -> int:
        """Pipelined hook: sweep the segments holding ``states``'s
        storage blocks immediately (same priority class as the stage
        requests that follow, so FIFO order runs the sweeps first).
        Returns the number of sweeps issued."""
        if io.store is None or not hasattr(io.store, "segments_for") \
                or not hasattr(io, "request_segment_readahead"):
            return 0
        from repro_torch.core.staging import PRIO_STAGE
        all_keys = []
        for state in states:
            all_keys.extend(_storage_keys(state))
        if not all_keys:
            return 0
        placement = io.store.segments_for(all_keys)
        for sid, items in placement.items():
            io.request_segment_readahead(
                sid, [k for k, _, _ in items],
                on_swept=self.cost.observe_bytes, priority=PRIO_STAGE)
        return len(placement)
