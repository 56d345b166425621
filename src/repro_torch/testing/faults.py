"""Deterministic, seedable fault injection for the storage/I-O stack.

``FaultInjector`` decides, per store operation, whether to inject a
failure (a ``TransientStoreError`` by default, a ``PermanentStoreError``
while poisoned) or added latency. Decisions come from a seeded RNG plus
optional per-operation *schedules* (exact call indices that must fail),
so every run of a chaos test sees the same fault sequence.

``FaultyBlockStore`` wraps any ``BlockStore`` and injects on the data
path (``get``/``get_many``/``put``/``commit``/``delete``/``readahead``/
``readahead_segments``); everything else delegates untouched, so the
engine's accounting, cost model and stats flow through the inner store
exactly as without the wrapper. ``crash()`` simulates a kill: file
handles are abandoned without a commit and the active log segment's tail
can be torn (truncated) — reopening a fresh store over the directory
exercises WAL recovery.

``TransferExecutor`` dispatch is hooked via ``executor.fault_hook``:
the injector's ``executor_hook`` runs before each task body and may
inject latency or a dispatch failure (recorded on the task's handle like
any other task exception).

The ``max_consecutive`` knob bounds runs of injected failures per
operation: after that many consecutive injections the next call is
forced through. With ``max_consecutive < io_retry_limit`` the retry
path *deterministically* succeeds — the chaos soak's
``io.stats['gave_up'] == 0`` assertion is exact, not probabilistic.
"""
from __future__ import annotations

import contextlib
import random
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

from repro_torch.storage.blockstore import (
    PermanentStoreError, TransientStoreError,
)

#: operations the injector can target (executor = task dispatch hook)
FAULT_OPS = ("get", "put", "commit", "delete", "readahead", "executor")


class FaultInjector:
    """Seeded per-operation fault decisions, shared by the store wrapper
    and the executor dispatch hook."""

    def __init__(self, seed: int = 0, *,
                 rates: Optional[Dict[str, float]] = None,
                 latency: float = 0.0,
                 max_consecutive: int = 0,
                 schedule: Optional[Dict[str, Sequence[int]]] = None):
        self.rng = random.Random(seed)
        self.rates = dict(rates or {})
        self.latency = latency
        self.max_consecutive = max_consecutive
        # op -> set of 0-based call indices that must fail (scripted
        # faults override the rate draw for those calls)
        self.schedule = {op: set(idx) for op, idx in (schedule or {}).items()}
        self.enabled = True
        self._poisoned: set = set()        # ops that raise permanently
        self._calls: Dict[str, int] = {}
        self._streak: Dict[str, int] = {}
        self.stats: Dict[str, int] = {"injected": 0, "latency_injections": 0}

    # ------------------------------------------------------------ control
    def poison(self, ops: Iterable[str]) -> None:
        """Make ``ops`` fail *permanently* (``PermanentStoreError`` on
        every call) until ``heal()`` — drives the restart/restore path."""
        self._poisoned.update(ops)

    def heal(self) -> None:
        self._poisoned.clear()

    @contextlib.contextmanager
    def paused(self):
        """No injection inside the block (checkpoints in chaos tests run
        clean — the checkpoint is the recovery anchor, not the victim)."""
        prev, self.enabled = self.enabled, False
        try:
            yield self
        finally:
            self.enabled = prev

    def fail_next(self, op: str, n: int = 1) -> None:
        """Script the next ``n`` calls of ``op`` to fail."""
        start = self._calls.get(op, 0)
        self.schedule.setdefault(op, set()).update(range(start, start + n))

    # ----------------------------------------------------------- decision
    def should_fail(self, op: str) -> bool:
        """One deterministic decision; advances the op's call counter."""
        idx = self._calls.get(op, 0)
        self._calls[op] = idx + 1
        if not self.enabled:
            return False
        if op in self._poisoned:
            return True
        scripted = idx in self.schedule.get(op, ())
        if self.max_consecutive and \
                self._streak.get(op, 0) >= self.max_consecutive:
            # bound the failure run: the retry that follows MUST succeed
            self._streak[op] = 0
            return False
        fail = scripted or self.rng.random() < self.rates.get(op, 0.0)
        self._streak[op] = self._streak.get(op, 0) + 1 if fail else 0
        return fail

    def maybe_fail(self, op: str) -> None:
        """Injected latency, then the fault decision; raises on fire."""
        if self.enabled and self.latency > 0:
            self.stats["latency_injections"] += 1
            time.sleep(self.latency)
        if self.should_fail(op):
            self.stats["injected"] += 1
            self.stats[op] = self.stats.get(op, 0) + 1
            if op in self._poisoned:
                raise PermanentStoreError(
                    f"injected permanent {op} failure")
            raise TransientStoreError(f"injected {op} failure")

    # ------------------------------------------------------ executor hook
    def executor_hook(self, task) -> None:
        """Install as ``TransferExecutor.fault_hook``: runs before each
        task body on the executor thread; an injected failure is recorded
        on the task's handle like any other task exception."""
        self.maybe_fail("executor")


class FaultyBlockStore:
    """Fault-injecting decorator over any ``BlockStore``.

    Data-path calls consult the injector first; everything else (stats,
    cost model, segment queries, compaction, inventory) delegates to the
    wrapped store, so the engine sees one store with occasional
    failures — not a different store."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector
        self.name = f"faulty-{inner.name}"

    # every non-overridden attribute (stats, simcost, durable_writes,
    # segments_for, compact_if_needed, ...) is the inner store's
    def __getattr__(self, item):
        return getattr(self.inner, item)

    # ------------------------------------------------------------- writes
    def put(self, window_key, block_id, arrays, fill):
        self.injector.maybe_fail("put")
        return self.inner.put(window_key, block_id, arrays, fill)

    def commit(self) -> None:
        self.injector.maybe_fail("commit")
        self.inner.commit()

    def delete(self, window_key, block_id) -> None:
        self.injector.maybe_fail("delete")
        self.inner.delete(window_key, block_id)

    # -------------------------------------------------------------- reads
    def get(self, window_key, block_id):
        self.injector.maybe_fail("get")
        return self.inner.get(window_key, block_id)

    def get_many(self, keys):
        self.injector.maybe_fail("get")
        return self.inner.get_many(keys)

    def readahead(self, keys) -> None:
        self.injector.maybe_fail("readahead")
        self.inner.readahead(keys)

    def readahead_segments(self, sid, keys) -> int:
        self.injector.maybe_fail("readahead")
        return self.inner.readahead_segments(sid, keys)

    # ----------------------------------------------------------- lifecycle
    def flush(self) -> None:
        self.commit()

    def close(self) -> None:
        # close is a clean-shutdown barrier, not a data-path op — tests
        # that want a dirty shutdown call crash() instead
        self.inner.close()

    def crash(self, torn_tail_bytes: int = 0) -> None:
        """Simulate a kill -9: abandon the inner store WITHOUT a commit
        (buffered tail records are lost, like a real crash) and
        optionally tear ``torn_tail_bytes`` off the active log segment —
        the torn-tail case WAL recovery must truncate on reopen."""
        f = getattr(self.inner, "_active_f", None)
        if f is not None:
            try:
                f.close()                  # no flush-to-disk guarantee
            except Exception:
                pass
        path_fn = getattr(self.inner, "active_segment_path", None)
        if torn_tail_bytes > 0 and path_fn is not None:
            path = path_fn()
            if path is not None and path.exists():
                size = path.stat().st_size
                with open(path, "ab") as fh:
                    fh.truncate(max(size - torn_tail_bytes, 0))
