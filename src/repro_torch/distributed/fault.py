"""Fault tolerance: the crash/restore loop of the training entry point, the
JAX package's ``distributed/fault.py`` ``RestartManager``.

Its ``HeartbeatMonitor``, ``BackupExecutor`` and ``EngineRecovery`` come
with the chaos soaks of a later slice.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


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
