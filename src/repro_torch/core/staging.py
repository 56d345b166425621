"""Staging/destaging: the single prioritized I/O executor (paper §4).

All tier transfers flow through one executor thread that serializes and
prioritizes requests: **demand staging > pre-staging > readahead >
late-event writes > destaging (m->p)** — staging data is needed
imminently by an executing operator, speculative store readahead should
not delay a concrete staging deadline, and destaging is a background
memory-saving activity. Destage operations are *preemptible at block
granularity*: between blocks the executor yields to any queued
higher-priority work (the paper's "interleaved" operations).

TPU adaptation of the serialization ablations (§5 Q3):
  * multithreaded JSON serialization  ->  chunked multi-buffer transfers
    (``chunk_blocks`` blocks per DMA) vs one monolithic transfer
  * single sequential I/O thread      ->  ``sequential_io=True`` (one
    executor) vs a thread pool issuing transfers concurrently
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np

import torch

from repro_torch._device import resolve_device, to_numpy
from repro_torch.core.buckets import Block, MemoryBudget, Tier, WindowState
from repro_torch.obs import NULL_SPAN, MetricsRegistry, StatsMap, Tracer
from repro_torch.storage.blockstore import (
    BlockStore, SimulatedCost, is_transient_error,
)

PRIO_DEMAND_STAGE = -1    # staging an operator is *blocked on* right now
PRIO_STAGE = 0            # proactive pre-staging
PRIO_READAHEAD = 1        # speculative store->cache sweeps (prefetch)
PRIO_LATE_WRITE = 2
PRIO_DESTAGE = 3

# priority class -> span/label name (tenant-fairness + tracing taxonomy)
PRIO_NAMES = {
    PRIO_DEMAND_STAGE: "demand_stage",
    PRIO_STAGE: "stage",
    PRIO_READAHEAD: "readahead",
    PRIO_LATE_WRITE: "late_write",
    PRIO_DESTAGE: "destage",
}


def _wkey(window: "WindowState") -> str:
    """Compact window id for span attributes."""
    return f"{window.window_start:g}-{window.window_end:g}"


class StagingError(RuntimeError):
    """A prioritized I/O task failed.

    Raised to waiters that *checked* their handle (``TaskHandle.check``):
    a failed demand stage must abort the fold that depends on it instead
    of silently reading stale tiers."""


class TaskHandle(threading.Event):
    """Completion handle for one submitted I/O task.

    An ``Event`` (so legacy ``submit(...).wait()`` callers keep working)
    plus the task's failure, if any: the executor records the exception
    here *before* setting the event, so a waiter that observes completion
    can always observe the error too."""

    def __init__(self):
        super().__init__()
        self.error: Optional[BaseException] = None

    def check(self) -> None:
        """Raise ``StagingError`` if the task failed."""
        if self.error is not None:
            raise StagingError(
                f"I/O task failed: {type(self.error).__name__}: "
                f"{self.error}") from self.error

    def wait_checked(self, timeout: Optional[float] = None) -> bool:
        """``wait`` + ``check``: returns completion, raises on failure."""
        ok = self.wait(timeout)
        self.check()
        return ok


@dataclass
class _Task:
    fn: Callable
    handle: TaskHandle
    tenant: str
    on_error: Optional[Callable] = None


class TransferExecutor:
    """The shared prioritized transfer executor behind ``IOScheduler``.

    One executor thread serializes transfers by priority class
    (``sequential_io=True``); ``sequential_io=False`` reproduces the
    paper's *no-sqntl-io* ablation (a pool, no ordering). Within a
    priority class, tasks are **tenant-tagged** and served by weighted
    round-robin across tenants: a tenant with weight ``w`` gets ``w``
    consecutive tasks before the cursor moves on, so one tenant's
    destage backlog cannot starve another's staging at the same
    priority (cross-class, the lattice still rules: any higher-priority
    task from any tenant goes first).

    Failures are never swallowed: a task exception is recorded on its
    ``TaskHandle`` (waiters re-raise via ``check()``), counted in
    ``stats["errors"]``, remembered as ``stats["last_error"]``, and
    forwarded to the submitting scheduler's ``on_error`` callback.
    """

    def __init__(self, *, sequential_io: bool = True,
                 max_pool_workers: int = 4,
                 registry: Optional[MetricsRegistry] = None):
        self.sequential_io = sequential_io
        self._cv = threading.Condition()
        # priority -> tenant -> FIFO of tasks
        self._classes: Dict[int, Dict[str, Deque[_Task]]] = {}
        self._weights: Dict[str, int] = {}
        self._rr_tenant: Dict[int, Optional[str]] = {}
        self._rr_served: Dict[int, int] = {}
        self._pending = 0
        self._inflight = 0
        self._stop = False
        # registry-backed stats: `executed`/`errors` are atomic counters
        # and `tenant_executed` a per-tenant labelled counter family, so
        # increments from pool-ablation worker threads (and unlocked
        # reads like fairness_stats) can't lose or tear updates
        self.registry = registry if registry is not None else MetricsRegistry()
        self.stats: StatsMap = StatsMap(self.registry, "aion_executor")
        self.stats.register("errors", "counter",
                            "I/O tasks that raised")
        self.stats.register("executed", "counter",
                            "I/O tasks completed (ok or failed)")
        self.stats.register_raw("last_error", None)
        self.stats.register_tenant_view(
            "tenant_executed",
            self.registry.counter("aion_executor_tenant_tasks",
                                  "I/O tasks completed per tenant",
                                  labelnames=("tenant",)))
        # fault-injection seam (testing.faults.FaultInjector): called
        # with the task before its body runs; may sleep (latency) or
        # raise (a dispatch failure, recorded like any task exception)
        self.fault_hook: Optional[Callable[[_Task], None]] = None
        # failures since the last raising drain — drain(raise_on_error)
        # reports ALL of them at once instead of first-error-wins
        self._failures: Deque[str] = deque(maxlen=64)
        if sequential_io:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
            self._pool = None
        else:
            self._thread = None
            self._pool = ThreadPoolExecutor(max_workers=max_pool_workers)

    def set_weight(self, tenant: str, weight: int) -> None:
        with self._cv:
            self._weights[tenant] = max(int(weight), 1)

    # ------------------------------------------------------------- submit
    def submit(self, priority: int, fn: Callable, *,
               tenant: str = "default",
               on_error: Optional[Callable] = None) -> TaskHandle:
        handle = TaskHandle()
        task = _Task(fn=fn, handle=handle, tenant=tenant,
                     on_error=on_error)
        if self._pool is not None:                 # no-sqntl-io ablation
            with self._cv:
                self._inflight += 1

            def wrap():
                try:
                    hook = self.fault_hook
                    if hook is not None:
                        hook(task)
                    fn()
                except BaseException as exc:       # record, never swallow
                    self._record_failure(task, exc)
                finally:
                    handle.set()
                    with self._cv:
                        self._inflight -= 1
                        self._finish_locked(task)
            self._pool.submit(wrap)
            return handle
        with self._cv:
            cls = self._classes.setdefault(priority, {})
            cls.setdefault(tenant, deque()).append(task)
            self._weights.setdefault(tenant, 1)
            self._pending += 1
            self._cv.notify()
        return handle

    def _record_failure(self, task: _Task, exc: BaseException) -> None:
        """A task raised: remember it everywhere a caller could look —
        the handle (demand waiters), the stats (pollers), the submitting
        scheduler (per-tenant stats). Set BEFORE ``handle.set()`` so no
        waiter can observe completion without the error."""
        task.handle.error = exc
        self.stats.inc("errors")
        with self._cv:
            self.stats["last_error"] = \
                f"{type(exc).__name__}: {exc}"
            self._failures.append(self.stats["last_error"])
        if task.on_error is not None:
            try:
                task.on_error(exc)
            except Exception:
                pass                       # stats callback must not kill us

    def _finish_locked(self, task: _Task) -> None:
        self.stats.inc("executed")
        self.stats.inc_labeled("tenant_executed", task.tenant)
        if not self._pending and not self._inflight:
            self._cv.notify_all()          # wake drain() waiters

    def _pop_locked(self) -> Optional[_Task]:
        """Next task: strictly lowest priority class first; weighted
        round-robin across that class's tenants (``weight`` consecutive
        pops per tenant before the cursor advances, tenant order
        deterministic by name)."""
        active = [p for p, cls in self._classes.items()
                  if any(cls.values())]
        if not active:
            return None
        prio = min(active)
        cls = self._classes[prio]
        names = sorted(t for t, q in cls.items() if q)
        cur = self._rr_tenant.get(prio)
        served = self._rr_served.get(prio, 0)
        if cur not in names or served >= self._weights.get(cur, 1):
            if cur in names:
                cur = names[(names.index(cur) + 1) % len(names)]
            else:
                # stale cursor (tenant's queue emptied): resume rotation
                # at the first name after it, wrapping
                later = [t for t in names if cur is None or t > cur]
                cur = later[0] if later else names[0]
            served = 0
        self._rr_tenant[prio] = cur
        self._rr_served[prio] = served + 1
        self._pending -= 1
        return cls[cur].popleft()

    def _run(self) -> None:
        while True:
            with self._cv:
                task = self._pop_locked()
                while task is None and not self._stop:
                    self._cv.wait(timeout=1.0)
                    task = self._pop_locked()
                if task is None:                   # stopping, queue empty
                    self._cv.notify_all()
                    return
                self._inflight += 1
            try:
                hook = self.fault_hook
                if hook is not None:
                    hook(task)
                task.fn()
            except BaseException as exc:    # record, never kill the thread
                self._record_failure(task, exc)
            finally:
                task.handle.set()
                with self._cv:
                    self._inflight -= 1
                    self._finish_locked(task)

    # ----------------------------------------------------------- queries
    def has_higher_priority_pending(self, priority: int) -> bool:
        with self._cv:
            return any(p < priority and any(cls.values())
                       for p, cls in self._classes.items())

    def drain(self, timeout: float = 30.0,
              raise_on_error: bool = False) -> bool:
        """Block until no task is queued or mid-run, in BOTH modes.

        Returns ``True`` on a clean drain and ``False`` on timeout —
        callers that need an empty queue (close, checkpoint) MUST check
        the result; proceeding after ``False`` races in-flight work.

        ``raise_on_error``: after the wait, raise ONE ``StagingError``
        carrying *every* task failure recorded since the last raising
        drain, sorted — deterministic across thread interleavings, where
        checking ``last_error`` after a drain was first-error-wins (the
        pool ablation runs failures concurrently, so which error a
        single-slot report surfaced was a race)."""
        deadline = time.time() + timeout
        clean = True
        with self._cv:
            while self._pending or self._inflight:
                remaining = deadline - time.time()
                if remaining <= 0:
                    clean = False
                    break
                self._cv.wait(timeout=remaining)
            failures = None
            if raise_on_error and self._failures:
                failures = sorted(self._failures)
                self._failures.clear()
        if failures is not None:
            raise StagingError(
                f"{len(failures)} I/O task(s) failed: "
                + "; ".join(failures))
        return clean

    def shutdown(self) -> None:
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class _CommitCoalescer:
    """Group-commits the WAL across I/O tasks.

    Without it, every spill batch and every late-write task pays its own
    ``store.commit()`` (flush + fsync + WAL ack). With it, writer tasks
    append their records, register a *finalizer*, and return; one
    deferred flush task per batch issues a single commit and then runs
    every finalizer with the commit outcome (``ok=False`` on a commit
    failure — finalizers must not acknowledge durability then). FIFO
    order within the flush priority class means every put queued before
    the flush ran is covered by its commit."""

    def __init__(self, scheduler: "IOScheduler", priority: int):
        self.sched = scheduler
        self.priority = priority
        self._lock = threading.Lock()
        self._fins: List[Callable[[bool], None]] = []
        self._flush_queued = False
        self.stats = {"coalesced_commits": 0, "joined_tasks": 0}

    def after_commit(self, fin: Callable[[bool], None]) -> None:
        """Run ``fin(ok)`` after the next group commit (covering every
        record the caller already appended). Queues one flush task per
        batch."""
        with self._lock:
            self._fins.append(fin)
            self.stats["joined_tasks"] += 1
            if self._flush_queued:
                return
            self._flush_queued = True
        self.sched.submit(self.priority, self._flush)

    def _flush(self) -> None:
        with self._lock:
            fins = self._fins
            self._fins = []
            self._flush_queued = False
        if not fins:
            return
        ok = False
        try:
            # transient commit failures retry within this flush (the
            # finalizers below must only see ok=False when the budget is
            # really exhausted — an unwound spill re-queues host copies
            # for a later pass)
            self.sched._with_retries(self.sched.store.commit, "commit")
            ok = True
            self.stats["coalesced_commits"] += 1
        finally:
            # on failure the exception propagates to the flush task's
            # handle/stats; finalizers still run with ok=False so
            # deferred-spill accounting unwinds and no host copy is
            # dropped without durability
            for fin in fins:
                try:
                    fin(ok)
                except Exception as exc:       # keep remaining finalizers
                    self.sched._record_error(exc)


class IOScheduler:
    """Single-threaded prioritized transfer executor.

    ``sequential_io=False`` reproduces the paper's *no-sqntl-io* ablation:
    transfers are issued on a pool with no global ordering or priorities.
    ``simulated_seconds_per_byte`` adds virtual I/O cost accounting so
    benchmarks can model a slow persistent tier deterministically.
    """

    def __init__(self, budget: MemoryBudget, *, sequential_io: bool = True,
                 chunk_blocks: int = 4, spill_dir: Optional[Path] = None,
                 host_budget_bytes: Optional[int] = None,
                 simulated_seconds_per_byte: float = 0.0,
                 pool=None, store: Optional[BlockStore] = None,
                 compact_ratio: float = 2.0,
                 executor: Optional[TransferExecutor] = None,
                 tenant: str = "default", io_weight: int = 1,
                 owns_store: bool = True, wal_coalesce: bool = False,
                 io_retry_limit: int = 4, io_retry_backoff: float = 0.01,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 device=None):
        self.budget = budget
        # device of the m-bucket: the pool's, else ``device`` (None: the
        # card)
        self.device = pool.device if pool is not None \
            else resolve_device(device)
        # one metrics registry + tracer per engine stack: adopt the shared
        # executor's registry when multiplexed (multi-tenant), else build
        # or accept a private one. Tracing defaults to OFF (rate 0) when
        # no tracer is handed down.
        if registry is None:
            registry = executor.registry if executor is not None \
                else MetricsRegistry()
        self.registry = registry
        self.tracer = tracer if tracer is not None else Tracer()
        # the executor may be SHARED across schedulers (multi-tenant
        # engines multiplex one transfer thread): this scheduler's tasks
        # are tagged with its tenant name and served weighted round-robin
        # within each priority class. A private executor is built (and
        # later shut down) by this scheduler when none is passed.
        self._owns_executor = executor is None
        if executor is None:
            executor = TransferExecutor(sequential_io=sequential_io,
                                        registry=registry)
        self.executor = executor
        self.tenant = tenant
        self.sequential_io = executor.sequential_io
        executor.set_weight(tenant, io_weight)
        self._owns_store = owns_store
        self.chunk_blocks = max(chunk_blocks, 1)
        self.spill_dir = spill_dir
        self.host_budget_bytes = host_budget_bytes
        self.sim_spb = simulated_seconds_per_byte
        self.compact_ratio = compact_ratio
        # persistent tier of the p-bucket: a BlockStore (the engine
        # builds one per AionConfig.store_backend); a bare spill_dir
        # keeps the legacy file-per-block npz semantics
        if store is None and spill_dir is not None:
            from repro_torch.storage import NpzBlockStore
            store = NpzBlockStore(spill_dir,
                                  sim_spb=simulated_seconds_per_byte)
        self.store = store
        # the simulated-cost model lives behind the store interface so
        # every backend prices transfers identically (zero-byte
        # transfers are free by contract); engines without a storage
        # tier still charge destage/late-write costs through a local
        # model
        if store is not None:
            if simulated_seconds_per_byte \
                    and not store.simcost.seconds_per_byte:
                store.simcost.seconds_per_byte = simulated_seconds_per_byte
            self.simcost = store.simcost
        else:
            self.simcost = SimulatedCost(simulated_seconds_per_byte)
        # persistent device block pool (core/block_pool.py); None keeps
        # the legacy per-block copy-to-device staging path
        self.pool = pool
        # registry-backed stats (labelled by tenant so multi-tenant
        # schedulers sharing one registry keep distinct series); the
        # legacy dict API (`stats["staged_blocks"]`) still works, hot
        # increments below use the atomic `.inc()`
        self.stats = StatsMap(registry, "aion_io",
                              labels={"tenant": tenant})
        self.stats.register_many([
            "staged_blocks", "destaged_blocks", "late_write_blocks",
            "stage_seconds", "destage_seconds",
            "stage_events", "simulated_io_seconds",
            "preemptions", "pool_fills", "pool_fallbacks",
            "errors",
            # self-healing path: transient store failures retried (and
            # recovered), retry budgets exhausted (the failure then
            # surfaced honestly), speculative readahead shed instead of
            # retried to exhaustion (the contract calls it best-effort)
            "retries", "gave_up", "readahead_shed",
        ])
        self.stats.register_raw("last_error", None)
        # per-task latency histogram, labelled by priority class
        self._task_hist = registry.histogram(
            "aion_io_task_seconds", "I/O task run time by priority class",
            labelnames=("tenant", "class"))
        # transient-failure retry budget (AionConfig.io_retry_limit /
        # io_retry_backoff); the jitter RNG is seeded per scheduler so
        # fault-injection runs are reproducible
        self.io_retry_limit = max(int(io_retry_limit), 0)
        self.io_retry_backoff = io_retry_backoff
        self._retry_rng = random.Random(0)
        # circuit breaker on store health (core.health.StoreHealth);
        # attached by the engine when the degradation ladder is on
        self.health = None
        self._host_bytes = 0
        # bytes whose spill records are appended but whose group commit
        # (and host-copy drop) is deferred to a coalesced flush —
        # _maybe_spill subtracts them so it doesn't re-spill the same
        # pressure every pass while a flush is queued
        self._pending_spill_bytes = 0
        # WAL commit coalescing across I/O tasks (spills + late writes
        # share one fsync); only meaningful on durable sequential-io
        # stores — the thread-pool ablation has no FIFO commit cover
        self._coalescer: Optional[_CommitCoalescer] = None
        if wal_coalesce and store is not None and store.durable_writes \
                and self.sequential_io:
            self._coalescer = _CommitCoalescer(self, PRIO_LATE_WRITE)
        # spill candidates, cold first (deque: the spill loop pops the
        # head, O(1) instead of list.pop(0)'s O(n))
        self._host_lru: Deque[Block] = deque()
        # guards _host_bytes/_host_lru: both the executor thread and the
        # engine main thread (sync stage calls, demand host reads) account
        # here. Ordering: block.lock may be held when taking _host_lock,
        # never the reverse.
        self._host_lock = threading.Lock()

    # ------------------------------------------------------------- submit
    def submit(self, priority: int, fn: Callable,
               span=NULL_SPAN) -> TaskHandle:
        """Queue ``fn`` at ``priority``, tagged with this scheduler's
        tenant. The returned ``TaskHandle`` is an Event (legacy waiters
        keep working) that additionally carries the task's failure —
        demand waiters call ``check()``/``wait_checked()`` so a failed
        stage aborts the dependent fold instead of folding stale tiers.

        ``span``: the task's trace span (created by the request_*
        methods BEFORE the closure so retries inside it can record
        events). The wrapper marks queue->dispatch, observes the task
        latency histogram by priority class, and ends the span when the
        task finishes on the executor thread."""
        hist = self._task_hist.labels(self.tenant,
                                      PRIO_NAMES.get(priority, str(priority)))

        def run():
            span.event("dispatch")
            t0 = time.time()
            try:
                fn()
            except BaseException as exc:
                span.set(error=type(exc).__name__)
                raise
            finally:
                hist.observe(time.time() - t0)
                span.end()
        return self.executor.submit(priority, run, tenant=self.tenant,
                                    on_error=self._record_error)

    def _task_span(self, parent, name: str, **attrs):
        """Child span for one I/O task (NULL when the parent is unsampled
        or absent — I/O spans never start their own trace)."""
        return self.tracer.child(parent, "io." + name,
                                 tenant=self.tenant, **attrs)

    def _record_error(self, exc: BaseException) -> None:
        self.stats.inc("errors")
        self.stats["last_error"] = f"{type(exc).__name__}: {exc}"

    # ------------------------------------------------------------- retries
    def _with_retries(self, fn: Callable, op: str,
                      shed_ok: bool = False, span=NULL_SPAN) -> Any:
        """Run a store operation with the transient-failure retry budget.

        Transient failures (``storage.is_transient_error``) retry up to
        ``io_retry_limit`` times with exponential backoff + jitter;
        permanent failures and exhausted budgets re-raise (honest
        surfacing — a waiter still sees the real error). ``shed_ok``
        marks *speculative* work (readahead sweeps): instead of raising
        on an exhausted/transient failure the operation is SHED (returns
        None, counted in ``stats['readahead_shed']``) — the store
        contract calls readahead best-effort, and a demand load will
        still fetch the data with its own retry budget."""
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as exc:
                transient = is_transient_error(exc)
                if transient and attempt < self.io_retry_limit:
                    attempt += 1
                    self.stats.inc("retries")
                    delay = self.io_retry_backoff * (2 ** (attempt - 1))
                    if delay > 0:
                        delay *= 0.5 + self._retry_rng.random()  # jitter
                    span.event("retry", op=op, attempt=attempt,
                               delay=round(delay, 6),
                               error=type(exc).__name__)
                    if delay > 0:
                        time.sleep(delay)
                    continue
                if transient and shed_ok:
                    self.stats.inc("readahead_shed")
                    self._record_error(exc)
                    span.event("shed", op=op, error=type(exc).__name__)
                    return None
                if transient:
                    self.stats.inc("gave_up")
                    span.event("gave_up", op=op, attempts=attempt)
                raise

    @property
    def last_error(self) -> Optional[str]:
        """Most recent task failure of THIS scheduler (None if clean)."""
        return self.stats["last_error"]

    def has_higher_priority_pending(self, priority: int) -> bool:
        return self.executor.has_higher_priority_pending(priority)

    def host_bytes_tracked(self) -> int:
        """The host-tier byte figure this scheduler already maintains
        (``_account_host``/spill bookkeeping): destaged + storage-loaded
        host copies. O(1) — metric polls use this instead of re-summing
        every window's blocks per poll. (Fresh ingest-tier host blocks
        are not in it until they first destage; ``StreamEngine.
        host_bytes()`` stays the exact full-sum for callers that need
        that.)"""
        with self._host_lock:
            return self._host_bytes

    def drain(self, timeout: float = 30.0,
              raise_on_error: bool = False) -> bool:
        """Block until the executor's queue is empty and no task is
        mid-run — in BOTH modes (the thread-pool ablation tracks
        in-flight tasks through the same counter).

        Returns ``True`` on a clean drain, ``False`` on timeout. Callers
        that require an empty queue (engine close, checkpoint) must not
        proceed on ``False`` — a checkpoint taken then would race
        in-flight spills. ``raise_on_error`` raises ONE ``StagingError``
        listing every task failure since the last raising drain (see
        ``TransferExecutor.drain``). NOTE: with a shared executor
        (multi-tenant) this waits for ALL tenants' queues, which is what
        the barrier callers need."""
        return self.executor.drain(timeout, raise_on_error=raise_on_error)

    def shutdown(self) -> None:
        if self._owns_executor:
            self.executor.shutdown()
        if self.store is not None and self._owns_store:
            self.store.close()         # final group commit + handles

    # ------------------------------------------------------------ transfers
    def _simulate_io(self, nbytes: int) -> None:
        """Model a slow persistent tier deterministically through the
        store's cost model (one channel: the transfer thread really
        sleeps, so scheduling — priorities, preemption, pre-staging lead
        time — decides who stalls, not host noise). Zero-byte transfers
        (empty blocks) are never charged."""
        if nbytes <= 0:
            return
        self.stats.inc("simulated_io_seconds", self.simcost.charge(nbytes))

    @staticmethod
    def _cost_bytes(block: Block) -> int:
        """Billable transfer size: an empty block moves no event data."""
        return block.nbytes if block.fill > 0 else 0

    def stage_block_sync(self, block: Block,
                         shard: Optional[int] = None,
                         span=NULL_SPAN) -> bool:
        """p->m: move one block to device. Returns False if budget full.

        With a block pool the transfer is an arena fill: allocate a pool
        slot (state free -> filling, in ``shard``'s range when the pooled
        fold is sharded) and dynamic-update-slice the block's keys/values
        into the arena (filling -> resident). A pooled fill costs the
        slot — its bytes were reserved once, at arena construction — so
        there is no per-block budget round-trip. Pool-range exhaustion
        falls back to the legacy per-block copy to the device (which DOES
        reserve) — the block is still device-resident, it just rides the
        stacked gather instead of the block table.
        """
        if block.tier == Tier.DEVICE:
            return True
        slot = None
        if self.pool is not None and block.capacity == self.pool.capacity \
                and block.width == self.pool.width:
            slot = self.pool.alloc(shard)
            if slot is None:
                self.stats.inc("pool_fallbacks")
        reserved = False
        if slot is None:
            if not self.budget.try_reserve(block.nbytes):
                return False
            reserved = True

        def fail() -> bool:
            if slot is not None:
                self.pool.free(slot)           # never attached to the block
            if reserved:
                self.budget.release(block.nbytes)
            return False

        t0 = time.time()
        if block.tier == Tier.STORAGE:
            # load under the block lock: a concurrent purge tombstones
            # the store record and would otherwise strand the
            # slot/reservation we hold
            with block.lock:
                if block.dropped or not block.in_storage:
                    return fail()
                try:
                    # transient store read failures retry; an exhausted
                    # budget surrenders the slot/reservation BEFORE
                    # surfacing (otherwise the pool leaks a slot per
                    # failed stage under sustained faults)
                    self._with_retries(block.as_event_batch, "get",
                                       span=span)
                except BaseException:
                    fail()
                    raise
                self._account_host(block)
        host_data = block.host_data
        if host_data is None:
            # block was purged (predictive cleanup) while this stage
            # request was queued — surrender the slot/reservation and skip
            return fail()

        device_data = None
        fill = block.fill
        if slot is None:
            device_data = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host_data.items()}
        # commit under the block lock: if predictive cleanup dropped the
        # block while the transfer was in flight, the slot/reservation is
        # ours to surrender (the purge only accounts blocks ALREADY on
        # device)
        with block.lock:
            if block.dropped:
                return fail()
            if block.tier == Tier.DEVICE:
                # a concurrent stager (prestage racing a demand stage on
                # the thread-pool ablation) committed first: surrender
                # our duplicate slot/reservation — overwriting would
                # orphan the winner's slot (or double-charge the budget)
                fail()
                return True
            if slot is None and block.fill != fill:
                # ingest appended after the device copy was taken: the
                # copy is stale, the block stays on the host (a pool
                # fill copies under this lock, after any append)
                return fail()
            if slot is not None:
                # arena write + slot attach, from the host arrays read
                # above (not block.host_data — a racing spill may have
                # nulled it since)
                self.pool.commit(block, slot, host_data)
                self.stats.inc("pool_fills")
            else:
                block.device_data = device_data
            block.tier = Tier.DEVICE
        if block.persisted:       # reads from the persistent tier pay I/O;
            self._simulate_io(self._cost_bytes(block))  # ingest is direct
        self.stats.inc("staged_blocks")
        self.stats.inc("stage_events", block.fill)
        self.stats.inc("stage_seconds", time.time() - t0)
        return True

    def destage_block_sync(self, block: Block) -> None:
        """m->p: move one block back to host (keeping the host copy is the
        'serialization' step; device buffers are dropped afterwards)."""
        t0 = time.time()
        with block.lock:
            if block.tier != Tier.DEVICE or block.dropped:
                # dropped: the purge already released the device bytes
                return
            was_pooled = block.pool_slot is not None
            if block.host_data is None:
                if block.device_data is not None:
                    block.host_data = {
                        k: to_numpy(v)
                        for k, v in block.device_data.items()}
                elif block.in_storage:
                    # a racing spill wrote the REAL arrays (incl.
                    # timestamps, which the arena does not carry) to
                    # storage; prefer them over a pool read that would
                    # fabricate zero timestamps and later overwrite the
                    # genuine ones on re-spill
                    self._with_retries(block._load_from_storage, "get")
                elif was_pooled:
                    block.host_data = self.pool.read_host(block)
            if was_pooled:
                # resident -> destaged: the slot returns to the free list
                # (the slot IS the pooled block's device accounting — no
                # budget release, the arena reservation is permanent)
                self.pool.release_slot(block)
            block.device_data = None
            block.tier = Tier.HOST
            block.persisted = True
        self._account_host(block)
        if not was_pooled:
            self.budget.release(block.nbytes)
        self._simulate_io(self._cost_bytes(block))
        self.stats.inc("destaged_blocks")
        self.stats.inc("destage_seconds", time.time() - t0)
        self._maybe_spill()

    def _account_host(self, block: Block) -> None:
        """Idempotent host-tier accounting: count a block's host copy
        once and register it as a spill candidate once. Staging keeps
        host copies resident, so a destage/stage/destage round-trip (the
        pooled cold path does one per re-execution) must not re-count
        the same bytes or duplicate the LRU entry; the flag resets when
        a spill actually evicts the copy. A re-destaged block keeps its
        original LRU position (no O(n) refresh — a stale-cold entry just
        spills early, which is safe)."""
        with self._host_lock:
            if block.host_accounted:
                return
            block.host_accounted = True
            self._host_bytes += block.nbytes
            if self.store is not None and not block.in_spill_lru:
                block.in_spill_lru = True
                self._host_lru.append(block)

    def _maybe_spill(self) -> None:
        """Enforce the host budget by spilling cold host blocks to the
        persistent store. Candidates are registered by ``_account_host``
        in first-destage order (oldest = coldest first); each pass pops
        the candidates needed to get under budget and spills them as ONE
        group commit (the log store turns the batch into sequential
        appends + one fsync)."""
        if self.host_budget_bytes is None or self.store is None:
            return
        while True:
            batch: List[Block] = []
            with self._host_lock:
                # bytes already riding a deferred (coalesced) commit are
                # as good as spilled for pressure purposes — without the
                # subtraction every pass until the flush runs would
                # re-spill fresh victims for the same overage
                need = (self._host_bytes - self._pending_spill_bytes
                        - self.host_budget_bytes)
                if need <= 0 or not self._host_lru:
                    return
                while need > 0 and self._host_lru:
                    blk = self._host_lru.popleft()
                    blk.in_spill_lru = False
                    batch.append(blk)
                    need -= blk.nbytes
            self.spill_blocks_sync(batch,
                                   coalesce=self._coalescer is not None)


    def fetch_block_host(self, block: Block
                         ) -> Optional[Dict[str, np.ndarray]]:
        """Demand host-side read of a block's full-capacity arrays for
        folding. Returns None if the block was purged.

        Execution paths that fold a p-bucket block host-side (the batched
        gather; the per-window budget-full fallback) must come through
        here rather than calling ``as_event_batch`` directly: STORAGE
        loads are accounted against the host tier (otherwise the bytes
        never count and the block can never spill again), and reads of
        persisted blocks pay the simulated persistent-tier cost — the
        same price the staging path charges, so simulated-I/O ablations
        don't get free reads on one path. Deliberately no
        ``_maybe_spill``: the caller is about to read ``host_data`` and
        an immediate spill could snatch it back.
        """
        with block.lock:
            if block.dropped:
                return None
            if block.host_data is None and block.in_storage:
                self._with_retries(block.as_event_batch, "get")
                self._account_host(block)
            host_data = block.host_data
        if host_data is not None and block.persisted:
            self._simulate_io(self._cost_bytes(block))
        return host_data

    def readahead_blocks(self, blocks: List[Block],
                         span=NULL_SPAN) -> None:
        """Prefetch storage-resident blocks into the store's read cache
        in one batched, segment-sequential sweep — the demand loads that
        follow become cache hits instead of per-block random reads."""
        if self.store is None:
            return
        keys = [(b.window_key, b.block_id) for b in blocks
                if b.tier == Tier.STORAGE and not b.dropped
                and b.in_storage]
        if keys:
            # speculative: an exhausted retry budget SHEDS the sweep
            # (stats['readahead_shed']) — demand loads still fetch the
            # records with their own budget, nothing is lost but speed
            self._with_retries(lambda: self.store.readahead(keys),
                               "readahead", shed_ok=True, span=span)

    def fetch_block_arrays(self, block: Block):
        """Device-preferred read of a block's full-capacity SoA arrays
        for the batched gather.

        A device-resident (m-bucket) copy is returned as-is — the batched
        stack keeps it device-side (a device concat instead of a host
        round-trip). Pooled blocks read their arena slot (an immutable
        device slice — no host round-trip either). Cold p-blocks fall
        through to ``fetch_block_host`` so the read is accounted and
        persisted blocks pay the simulated persistent-tier cost. Returns
        None only if the block was purged.
        """
        dd = block.device_data
        if dd is not None:
            return dd
        if self.pool is not None and block.pool_slot is not None:
            d = self.pool.read_block(block)
            if d is not None:
                return d
        return self.fetch_block_host(block)

    def spill_block_sync(self, block: Block) -> None:
        self.spill_blocks_sync([block])

    def _unaccount_unspillable(self, block: Block) -> None:
        """The LRU pop consumed this block's registration but it cannot
        spill (purged, empty, or re-staged to device with its host
        shadow kept): un-account it so the next destage re-registers —
        otherwise its bytes would stay counted in _host_bytes while
        being unevictable forever."""
        with self._host_lock:
            if block.host_accounted:
                block.host_accounted = False
                self._host_bytes = max(
                    self._host_bytes - block.nbytes, 0)

    def spill_blocks_sync(self, blocks: List[Block],
                          coalesce: bool = False) -> None:
        """Spill a batch of host blocks to the persistent store under
        ONE group commit: every block's record is appended (buffered),
        the commit makes them durable, and only then are the host copies
        dropped — a crash mid-spill loses nothing, the unacknowledged
        blocks still hold their host data. A block whose exact content
        is already persistent (same fill) skips the rewrite entirely.

        ``coalesce=True`` (only the budget-pressure path passes it)
        defers the commit + finalize to the WAL coalescer so several
        spill batches and late-write tasks share one fsync; direct
        callers keep the synchronous contract (STORAGE tier on
        return)."""
        if self.store is None:
            return
        staged: List[Block] = []
        try:
            for block in blocks:
                # put under the block lock so a concurrent purge can't
                # clear host_data mid-write or have its tombstone undone
                # by a spill that resurrects the record for a dead block
                with block.lock:
                    if block.dropped or block.tier != Tier.HOST \
                            or block.fill == 0:
                        self._unaccount_unspillable(block)
                        continue
                    self._with_retries(
                        lambda b=block: b.put_to_store(self.store), "put")
                staged.append(block)
        except BaseException:
            # exhausted/permanent put: the batch's still-accounted host
            # copies (including the one that failed) go back on the
            # candidate list so they stay evictable, then surface
            self._requeue_spill(staged + [block])
            raise
        if not staged:
            return
        if coalesce and self._coalescer is not None:
            deferred = sum(b.nbytes for b in staged)
            with self._host_lock:
                self._pending_spill_bytes += deferred

            def fin(ok: bool, staged=staged, deferred=deferred) -> None:
                with self._host_lock:
                    self._pending_spill_bytes = max(
                        self._pending_spill_bytes - deferred, 0)
                self._finalize_spill(staged, ok)
            self._coalescer.after_commit(fin)
            return
        try:
            # durability barrier (transient failures retry first)
            self._with_retries(self.store.commit, "commit")
        except BaseException:
            self._requeue_spill(staged)
            raise
        self._finalize_spill(staged, True)

    def _requeue_spill(self, blocks: List[Block]) -> None:
        """Return failed-spill host copies to the candidate list EXACTLY
        once each: the ``in_spill_lru`` membership flag makes the
        re-queue idempotent, so two failing coalesced flushes covering
        the same block (overlapping batches, or a direct spill of a
        block still on the list) cannot duplicate its LRU entry — and
        ``host_accounted`` stays untouched, so ``_host_bytes`` is never
        double-registered."""
        with self._host_lock:
            for block in blocks:
                if block.host_accounted and not block.in_spill_lru:
                    block.in_spill_lru = True
                    self._host_lru.append(block)

    def _finalize_spill(self, staged: List[Block], ok: bool) -> None:
        """Post-commit half of a spill: drop host copies and flip tiers.
        ``ok=False`` (a coalesced commit failed) keeps every host copy —
        durability was not achieved, so the blocks go back on the spill
        candidate list for a later retry."""
        if not ok:
            self._requeue_spill(staged)
            return
        total = 0
        for block in staged:
            with block.lock:
                if block.dropped or block.tier != Tier.HOST:
                    # a purge or re-stage landed between the commit and
                    # this finalize: the record stays (purge already
                    # tombstoned it if it ran), the residency is theirs
                    self._unaccount_unspillable(block)
                    continue
                if self.store.current_fill(block.window_key,
                                           block.block_id) != block.fill:
                    # ingest appended to the block after its record was
                    # written: the record is stale, so the host copy
                    # stays and the block goes back on the candidate
                    # list (its next spill writes the longer fill)
                    self._requeue_spill([block])
                    continue
                nbytes = block.nbytes
                block.host_data = None
                block.tier = Tier.STORAGE
                block.persisted = True
            with self._host_lock:
                if block.host_accounted:
                    block.host_accounted = False
                    self._host_bytes = max(self._host_bytes - nbytes, 0)
            total += nbytes
        self._simulate_io(total)

    # ------------------------------------------------------- bulk requests
    def shard_of(self, window: WindowState) -> Optional[int]:
        """Pool shard hint for a window's blocks (None without a sharded
        pool): the same stable window -> shard map the batch executor's
        pooled placement uses, so a window's arena slots always land in
        the range of the device that will fold its block-table rows."""
        if self.pool is None or self.pool.num_shards <= 1:
            return None
        from repro_torch.distributed.sharding import shard_of_window
        return shard_of_window(window.window_start, window.window_end,
                               self.pool.num_shards)

    def request_stage(self, window: WindowState,
                      blocks: Optional[List[Block]] = None,
                      demand: bool = False,
                      parent=None) -> threading.Event:
        """Queue staging of a window's p-blocks, in chunks so independent
        DMAs can overlap (multithread-serialization analog). ``demand``:
        an executing operator is blocked on these blocks — outranks
        speculative pre-staging. With a block pool these are pool fills
        (demand fills are what the batch executor overlaps with the fold
        of the already-resident shard)."""
        blocks = blocks if blocks is not None else window.p_blocks()
        shard = self.shard_of(window)
        span = self._task_span(
            parent, "demand_stage" if demand else "stage",
            window=_wkey(window), blocks=len(blocks))

        def do():
            store = self.store
            if span and store is not None:
                h0 = store.stats.get("readahead_hits", 0)
                m0 = store.stats.get("readahead_misses", 0)
            # batched store readahead first: the per-block loads below
            # then read sequentially-swept cache entries, not one random
            # record each (the proactive-caching path's storage half)
            self.readahead_blocks(blocks, span=span)
            staged = 0
            for blk in blocks:
                if self.stage_block_sync(blk, shard=shard, span=span):
                    staged += 1
            if span and store is not None:
                span.set(
                    staged=staged,
                    readahead_hits=store.stats.get("readahead_hits", 0) - h0,
                    readahead_misses=store.stats.get(
                        "readahead_misses", 0) - m0)
        return self.submit(PRIO_DEMAND_STAGE if demand else PRIO_STAGE, do,
                           span=span)

    def request_readahead(self, window: WindowState,
                          parent=None) -> threading.Event:
        """Queue a storage-only readahead for a window's spilled blocks
        (no host/device residency change): proactive caching drives this
        ahead of the actual pre-stage, so the store's sequential sweep
        runs before the staging deadline instead of inside it."""
        blocks = [b for b in window.blocks if b.tier == Tier.STORAGE]
        span = self._task_span(parent, "readahead",
                               window=_wkey(window), blocks=len(blocks))

        def do():
            self.readahead_blocks(blocks, span=span)
        return self.submit(PRIO_READAHEAD, do, span=span)

    def request_segment_readahead(self, sid: int, keys: List,
                                  on_swept: Optional[Callable] = None,
                                  priority: int = PRIO_READAHEAD,
                                  parent=None) -> threading.Event:
        """Queue ONE sequential sweep over log segment ``sid`` caching
        ``keys``'s records (the learned planner's unit of readahead).
        ``on_swept(seconds, nbytes)`` feeds the measured sweep back into
        the planner's bandwidth model. ``priority`` defaults to the
        speculative readahead class; the pipelined prefetch hook passes
        ``PRIO_STAGE`` so its sweeps run (FIFO) before the stage tasks
        they feed."""
        span = self._task_span(parent, "segment_readahead",
                               segment=sid, keys=len(keys))

        def do():
            if self.store is None:
                return
            before = self.store.stats.get("sweep_bytes_read", 0)
            t0 = time.time()
            # speculative — shed on exhausted transient failures, like
            # readahead_blocks (the demand path still fetches)
            if self._with_retries(
                    lambda: self.store.readahead_segments(sid, keys),
                    "readahead", shed_ok=True, span=span) is None:
                return
            if on_swept is not None:
                nbytes = self.store.stats.get("sweep_bytes_read", 0) \
                    - before
                if nbytes > 0:
                    on_swept(time.time() - t0, nbytes)
        return self.submit(priority, do, span=span)

    def request_coalesce(self, window_keys: List) -> Optional[threading.Event]:
        """Queue a storage-layout coalescing pass (background priority):
        rewrite the given windows' scattered records into contiguous
        runs so their predicted re-stages become single dense sweeps."""
        if self.store is None:
            return None

        def do():
            n = self.store.coalesce_windows(window_keys)
            if n:
                self.stats.inc("coalesced_windows", n)
        return self.submit(PRIO_DESTAGE, do)

    def request_compaction(self, max_ratio: Optional[float] = None
                           ) -> Optional[threading.Event]:
        """Queue background compaction (lowest priority): commit any
        pending tombstones, then reclaim dead log space until the store
        is back under its ratio bound. Driven by the engine after
        predictive-cleanup purges."""
        if self.store is None:
            return None
        ratio = self.compact_ratio if max_ratio is None else max_ratio

        def do():
            self._with_retries(self.store.commit, "commit")
            reclaimed = self.store.compact_if_needed(ratio)
            if reclaimed:
                self.stats.inc("compacted_bytes", reclaimed)
        return self.submit(PRIO_DESTAGE, do)

    def request_destage(self, window: WindowState,
                        keep_bootstrap: int = 0,
                        parent=None) -> threading.Event:
        """Queue destaging (background, lowest priority). Preemptible: the
        executor checks for higher-priority work between chunks."""
        span = self._task_span(parent, "destage", window=_wkey(window))

        def do():
            m = window.m_blocks()
            keep = set(id(b) for b in m[:keep_bootstrap])
            pending = [b for b in m if id(b) not in keep]
            i = 0
            while i < len(pending):
                chunk = pending[i:i + self.chunk_blocks]
                for blk in chunk:
                    self.destage_block_sync(blk)
                i += len(chunk)
                if self.sequential_io and \
                        self.has_higher_priority_pending(PRIO_DESTAGE):
                    # re-queue the remainder and yield (preemption)
                    self.stats.inc("preemptions")
                    span.event("preempted", remaining=len(pending) - i)
                    rest = pending[i:]
                    if rest:
                        self.submit(PRIO_DESTAGE,
                                    lambda r=rest: [self.destage_block_sync(b)
                                                    for b in r])
                    return
        return self.submit(PRIO_DESTAGE, do, span=span)

    def request_late_write(self, window: WindowState, blocks: List[Block],
                           parent=None) -> threading.Event:
        """Late events were appended host-side; this acknowledges/persists
        them at middle priority (and spills if the host tier is over
        budget).

        With a durable store (the log backend) the write is REAL: the
        blocks' records group-commit into the value log, so acknowledged
        late events survive a crash even before any checkpoint. The host
        copy stays resident (tier unchanged) — the record is the
        p-bucket's persistent shadow. The legacy npz backend keeps the
        seed behaviour (flag + simulated cost only)."""
        durable = self.store is not None and self.store.durable_writes
        span = self._task_span(parent, "late_write",
                               window=_wkey(window), blocks=len(blocks),
                               durable=durable)

        def do():
            self.stats.inc("late_write_blocks", len(blocks))
            total = 0
            wrote: List[Block] = []
            for blk in blocks:
                with blk.lock:
                    if blk.dropped:
                        continue
                    if durable and blk.fill > 0 \
                            and blk.host_data is not None:
                        self._with_retries(
                            lambda b=blk: b.put_to_store(self.store),
                            "put", span=span)
                    wrote.append(blk)
                total += self._cost_bytes(blk)

            def fin(ok: bool) -> None:
                if not ok:
                    return       # commit failed: nothing is acknowledged
                for blk in wrote:
                    with blk.lock:
                        if not blk.dropped:
                            blk.persisted = True  # landed in p-bucket
                self._simulate_io(total)
            if durable and self._coalescer is not None:
                # join the coalesced group commit: one fsync covers this
                # late write and any spill batches queued around it
                span.event("coalesced_commit_joined")
                self._coalescer.after_commit(fin)
            else:
                if durable:
                    self._with_retries(self.store.commit, "commit",
                                       span=span)
                fin(True)
        return self.submit(PRIO_LATE_WRITE, do, span=span)
