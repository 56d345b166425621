"""Fault tolerance: heartbeats, straggler backup execution, restart, the
JAX package's ``distributed/fault.py``.

* ``HeartbeatMonitor`` — worker liveness with a configurable timeout: a
  worker whose last beat is more than ``timeout`` old is dead.
* ``BackupExecutor`` — straggler mitigation for window re-executions: a
  task slower than ``deadline_factor`` x its EWMA latency gets a backup
  issued; first result wins. Safe because Aion window (re-)execution is a
  pure function of bucket contents (idempotent). The pipelined engine
  retries a failed fold round once through one
  (``AionConfig.fold_round_retry``).
* ``RestartManager`` — crash/restore loop glue used by launch/train.py:
  on failure, restore the latest complete checkpoint and resume at the
  recorded step.
* ``EngineRecovery`` — the streaming path's restart glue: hold the latest
  manifest checkpoint of a ``StreamEngine``; when the engine is poisoned
  (a permanent store failure killed a fold round), build a fresh engine
  over the reopened store (the reopen IS the WAL replay) through the
  caller's factory, which gives it its device like any entry point
  (``None``: the card), and restore the checkpointed bucket state into
  it. The caller replays its event ledger from the checkpoint token.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


class HeartbeatMonitor:
    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout
        self._last: Dict[str, float] = {}
        self._lock = threading.Lock()

    def beat(self, worker: str, now: Optional[float] = None) -> None:
        with self._lock:
            self._last[worker] = now if now is not None else time.time()

    def dead_workers(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        with self._lock:
            return [w for w, t in self._last.items()
                    if now - t > self.timeout]

    def alive_workers(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        with self._lock:
            return [w for w, t in self._last.items()
                    if now - t <= self.timeout]


@dataclass
class BackupStats:
    launched: int = 0
    backups_issued: int = 0
    backup_wins: int = 0


class BackupExecutor:
    """Run idempotent tasks with deadline-triggered backup copies."""

    def __init__(self, workers: int = 4, deadline_factor: float = 3.0,
                 min_deadline: float = 0.05):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self.deadline_factor = deadline_factor
        self.min_deadline = min_deadline
        self._ewma: Optional[float] = None
        self.stats = BackupStats()

    def _observe(self, dt: float) -> None:
        self._ewma = dt if self._ewma is None else \
            0.7 * self._ewma + 0.3 * dt

    def run(self, fn: Callable[[], Any]) -> Any:
        """Execute fn; if it exceeds the deadline, race a backup."""
        self.stats.launched += 1
        t0 = time.time()
        primary = self._pool.submit(fn)
        deadline = max((self._ewma or 0.0) * self.deadline_factor,
                       self.min_deadline)
        done, _ = wait([primary], timeout=deadline)
        if done:
            self._observe(time.time() - t0)
            return primary.result()
        # straggler: issue a backup, take whichever finishes first
        self.stats.backups_issued += 1
        backup = self._pool.submit(fn)
        done, _ = wait([primary, backup], return_when=FIRST_COMPLETED)
        winner = done.pop()
        if winner is backup:
            self.stats.backup_wins += 1
        self._observe(time.time() - t0)
        return winner.result()

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class EngineRecovery:
    """Checkpoint/restore loop for one streaming engine.

    ``factory`` builds a FRESH engine over the same (re-opened) store
    directory — the log store's open runs WAL recovery, truncating any
    torn tail, so the records a manifest checkpoint references are
    exactly the acknowledged ones. ``checkpoint`` snapshots the engine's
    bucket manifests plus an opaque caller *token* (typically the count
    of events already emitted to the engine) so the caller knows where
    to resume its ledger replay after ``restore``."""

    def __init__(self, factory: Callable[[], Any], max_restarts: int = 3):
        self.factory = factory
        self.max_restarts = max_restarts
        self.restarts = 0
        self._snap: Optional[Dict[str, Any]] = None
        self._token: Any = None

    @property
    def has_checkpoint(self) -> bool:
        return self._snap is not None

    def checkpoint(self, engine, token: Any = None) -> None:
        """Snapshot ``engine`` (manifest checkpoint: store records are
        referenced, not copied) and remember the resume token."""
        self._snap = engine.checkpoint_state(include_stored_data=False)
        self._token = token

    def restore(self):
        """Build a fresh engine from the factory and load the latest
        checkpoint into it; returns ``(engine, token)``. Raises after
        ``max_restarts`` — a crash loop must surface, not spin."""
        if self._snap is None:
            raise RuntimeError("EngineRecovery: no checkpoint taken yet")
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"EngineRecovery: exceeded max_restarts="
                f"{self.max_restarts}")
        engine = self.factory()
        engine.restore_state(self._snap)
        return engine, self._token


class RestartManager:
    """Run a step loop with crash recovery from the latest checkpoint."""

    def __init__(self, save_every: int = 50, max_restarts: int = 10):
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, *, init_state: Callable[[], Any],
            restore: Callable[[], Optional[Any]],
            step_fn: Callable[[Any, int], Any],
            save: Callable[[Any, int], None],
            num_steps: int) -> Any:
        """Generic loop: restore-or-init, step, periodic save; on exception
        restart from the last checkpoint (up to max_restarts)."""
        while True:
            restored = restore()
            state, start = (restored if restored is not None
                            else (init_state(), 0))
            try:
                for step in range(start, num_steps):
                    state = step_fn(state, step)
                    if (step + 1) % self.save_every == 0 or \
                            step + 1 == num_steps:
                        save(state, step + 1)
                return state
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
