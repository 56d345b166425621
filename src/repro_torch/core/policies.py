"""Data-transfer policies (paper §3.2).

Policies decide *which tier* window blocks should live in, in response to
engine events. They are strategy objects with hooks; all actual movement
goes through the prioritized ``IOScheduler``.

* ``StandardPolicy`` — events fill the m-bucket until full, then redirect
  to the p-bucket; on expiry the whole window destages; late events write
  straight to the p-bucket; staging happens at (pre-)execution time.
* ``LocalRhoMinPolicy`` — like standard, but keeps a bootstrap set of
  ``rho_min`` initial blocks resident after destage, and destages idle
  windows after ``tau`` seconds without events or watermarks.
* ``GlobalMemoryPolicy`` — watches overall memory: under *moderate*
  pressure destages expired/idle windows selectively (by descending state
  size for fastest savings, or ascending ingestion rate to minimize delay);
  under *severe* pressure destages everything except bootstrap sets.
* ``InMemoryPolicy`` — the Flink-baseline backend: everything stays in the
  memory tier; when the budget is exhausted the engine OOMs (Q1 baseline).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.buckets import MemoryBudget, Tier, WindowState
from repro_torch.core.staging import IOScheduler
from repro_torch.core.windows import WindowId


class EngineOOM(RuntimeError):
    """Raised by the in-memory baseline when the device budget is exhausted
    (models the paper's baseline crashing under heap pressure)."""


class TransferPolicy:
    name = "abstract"

    def on_append(self, state: WindowState, new_blocks, io: IOScheduler,
                  late: bool, now: float) -> None:
        raise NotImplementedError

    def on_expiry(self, state: WindowState, io: IOScheduler,
                  now: float) -> None:
        raise NotImplementedError

    def on_post_execute(self, state: WindowState, io: IOScheduler,
                        now: float) -> None:
        """m-bucket of a past window is freed after re-execution (paper)."""
        if state.expired:
            io.request_destage(state, keep_bootstrap=state.rho_min_blocks)

    def on_tick(self, windows: Dict[WindowId, WindowState],
                io: IOScheduler, now: float) -> None:
        pass


@dataclass
class StandardPolicy(TransferPolicy):
    name: str = "standard"

    def on_append(self, state, new_blocks, io, late, now):
        if late or state.expired:
            io.request_late_write(state, new_blocks)    # straight to p
            return
        # active window: stage new blocks into the m-bucket while there is
        # budget; once full, subsequent blocks stay host-side (redirect).
        # The shard hint keeps pooled slots in the window's arena range.
        shard = io.shard_of(state)
        for blk in new_blocks:
            if not io.stage_block_sync(blk, shard=shard):
                break

    def on_expiry(self, state, io, now):
        state.rho_min_blocks = 0
        io.request_destage(state)


@dataclass
class LocalRhoMinPolicy(StandardPolicy):
    name: str = "local_rho_min"
    rho_min: float = 0.05
    tau: float = 60.0
    _last_activity: Dict[WindowId, float] = field(default_factory=dict)

    def _bootstrap_blocks(self, state: WindowState) -> int:
        return max(1, math.ceil(len(state.blocks) * self.rho_min))

    def on_append(self, state, new_blocks, io, late, now):
        self._last_activity[WindowId(state.window_start,
                                     state.window_end)] = now
        super().on_append(state, new_blocks, io, late, now)

    def on_expiry(self, state, io, now):
        state.rho_min_blocks = self._bootstrap_blocks(state)
        io.request_destage(state, keep_bootstrap=state.rho_min_blocks)

    def on_tick(self, windows, io, now):
        for wid, state in windows.items():
            last = self._last_activity.get(wid, now)
            if now - last > self.tau and state.device_bytes() > 0:
                state.rho_min_blocks = self._bootstrap_blocks(state)
                io.request_destage(state,
                                   keep_bootstrap=state.rho_min_blocks)
                self._last_activity[wid] = now


@dataclass
class GlobalMemoryPolicy(LocalRhoMinPolicy):
    name: str = "global_memory"
    moderate: float = 0.75
    severe: float = 0.90
    order: str = "size_desc"       # or "ingest_rate_asc"

    def on_tick(self, windows, io, now):
        util = io.budget.utilization
        if util < self.moderate:
            return
        states = [s for s in windows.values() if s.device_bytes() > 0]
        if util >= self.severe:
            for s in states:
                s.rho_min_blocks = self._bootstrap_blocks(s)
                io.request_destage(s, keep_bootstrap=s.rho_min_blocks)
            return
        if self.order == "size_desc":
            states.sort(key=lambda s: -s.device_bytes())
        else:
            states.sort(key=lambda s: s.total_events /
                        max(s.window_end - s.window_start, 1e-9))
        # destage until projected utilization is under the moderate line
        need = io.budget.used_bytes - int(self.moderate
                                          * io.budget.capacity_bytes)
        for s in states:
            if need <= 0:
                break
            s.rho_min_blocks = self._bootstrap_blocks(s)
            freeable = s.device_bytes()
            io.request_destage(s, keep_bootstrap=s.rho_min_blocks)
            need -= freeable


@dataclass
class InMemoryPolicy(TransferPolicy):
    """Flink-baseline backend: all state pinned in the memory tier."""
    name: str = "in_memory_baseline"

    def on_append(self, state, new_blocks, io, late, now):
        shard = io.shard_of(state)
        for blk in new_blocks:
            if not io.stage_block_sync(blk, shard=shard):
                raise EngineOOM(
                    f"in-memory baseline exhausted device budget "
                    f"({io.budget.used_bytes}/{io.budget.capacity_bytes} B)")

    def on_expiry(self, state, io, now):
        pass                                   # never destage

    def on_post_execute(self, state, io, now):
        pass
