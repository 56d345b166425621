"""Pipelined asynchronous execution + multi-tenant multiplexing.

The synchronous engine serializes three phases with no cross-window data
dependency: a watermark advance drains staging, then the batched fold
runs, then results emit. This module breaks the fence:

* ``EnginePipeline`` — a dedicated fold worker thread consuming *fold
  rounds* (the ``BatchWorkItem`` lists the engine used to execute inline)
  from a FIFO queue. ``StreamEngine.advance_watermark``/``poll`` SUBMIT
  rounds and return immediately, so ingestion keeps appending to the
  windows' blocks while the previous round's fold is in flight; emission
  is futures-based. Rounds execute in submission order, which preserves
  the paper's priority rule at round granularity (live batches are
  submitted before late batches).

* Submit-time staging lookahead (``AionConfig.pipeline_prefetch``): when
  a round is submitted while the worker is busy, the new round's cold
  p-blocks are queued for staging at ``PRIO_STAGE`` right away — the
  running round's ``PRIO_DEMAND_STAGE`` still outranks them, but the I/O
  executor stays continuously fed, so round k+1's staging overlaps round
  k's fold instead of starting after it.

* Watermark fences shrink to the slots they close: the only
  synchronization between the main thread and an in-flight round is the
  per-pool-slot epoch scheme (``DeviceBlockPool.slot_epochs``, checked by
  ``core.batch_exec`` under one pool pin) plus the purge guard
  (``window_in_flight``) — not a global drain.

* ``MultiTenantEngine`` — N independent keyed streams multiplexed onto
  one set of shared resources: one device budget (per-tenant
  ``TenantBudget`` caps inside it), one ``TransferExecutor`` (tenant
  tagged tasks, weighted round-robin within each priority class), one
  block store, one device arena, one fold pipeline. Tenant profiles live
  in ``configs.workloads.TENANT_PROFILES``.

On the card, the worker thread folds on the pool's CUDA stream (the
stream every arena write uses: ``core.batch_exec`` makes it current for
the whole round, and the thread's current device is the engine's), so
stream order keeps each fold ahead of a later in-place arena write by
the I/O thread. A ``ResultFuture`` resolves when the round's device work
is done: every operator's ``finalize``/``finalize_batch`` copies its
accumulator to the host on that stream (``to_numpy``), which waits for
the round's kernels, so a round's results are host values by the time
``_complete`` sets them, and no CUDA event is needed.

Failure semantics: a round that raises (e.g. ``StagingError`` from a
failed demand fill) is retried once through the engine's backup executor
when ``AionConfig.fold_round_retry`` is on; a round that still fails
marks every unresolved future of that round with the error and records
it on the pipeline; ``drain(raise_on_error=True)`` — called by
``StreamEngine.close()`` and the checkpoint path — re-raises as
``PipelineError``. Nothing is silently absorbed, and no kernel error is
replaced by a plain version.
"""
from __future__ import annotations

import contextlib
import threading
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional

import torch

from repro_torch.core.windows import WindowId
from repro_torch.obs import MetricsRegistry, StatsMap, Tracer


class PipelineError(RuntimeError):
    """A submitted fold round failed (see ``EnginePipeline.drain``)."""


class ResultFuture:
    """Resolves when a submitted round's fold completes for one window."""

    __slots__ = ("_ev", "_value", "error")

    def __init__(self):
        self._ev = threading.Event()
        self._value: Any = None
        self.error: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._ev.set()

    def set_error(self, exc: BaseException) -> None:
        if not self._ev.is_set():
            self.error = exc
            self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._ev.wait(timeout):
            raise TimeoutError("fold round still in flight")
        if self.error is not None:
            raise PipelineError(
                f"fold round failed: {type(self.error).__name__}: "
                f"{self.error}") from self.error
        return self._value


@dataclass
class _FoldRound:
    """One submitted batch: executes via the owning engine's executor."""
    engine: Any
    items: List[Any]                       # BatchWorkItem
    now: float
    futures: Dict[WindowId, ResultFuture]
    on_done: Optional[Callable] = None     # post-fold hook (e.g. expiry)
    # submitting span (e.g. the watermark advance) — handed EXPLICITLY
    # across the worker-thread boundary so the fold span parents to it
    trace_parent: Any = None


class EnginePipeline:
    """FIFO fold-round worker shared by one or more engines."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._cv = threading.Condition()
        self._queue: Deque[_FoldRound] = deque()
        self._inflight_wids: Dict[WindowId, int] = {}
        self._active = 0                   # rounds mid-execution
        # bounded: a long soak with recurring faults must not grow the
        # failure memory without limit; drain() reports and clears
        self._errors: Deque[BaseException] = deque(maxlen=64)
        self._stop = False
        registry = registry if registry is not None else MetricsRegistry()
        self.registry = registry
        self.stats = StatsMap(registry, "aion_pipeline")
        self.stats.register_many(["rounds", "prefetched_rounds",
                                  "round_retries", "round_retry_wins"])
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="aion-fold-worker")
        self._thread.start()

    # ------------------------------------------------------------- submit
    def submit(self, engine, items, now: float,
               on_done: Optional[Callable] = None,
               trace_parent=None
               ) -> Dict[WindowId, ResultFuture]:
        """Queue one fold round; returns a future per window.

        The round folds on the worker thread via the engine's own
        ``BatchExecutor`` — safe because round membership is snapshotted
        by the executor, blocks are append-only (a block's ``fill`` is
        captured once and rows below it never mutate), and ingest only
        appends new blocks. When submitted while another round is in
        flight, the new round's cold blocks start staging immediately
        (PRIO_STAGE — outranked by the running round's demand fills)."""
        futures = {it.wid: ResultFuture() for it in items}
        # only carry a parent that is actually sampled: untraced rounds
        # then dispatch through the 2-arg execute() signature (tests
        # wrap it) and pay zero tracing overhead
        if trace_parent is not None \
                and not getattr(trace_parent, "sampled", False):
            trace_parent = None
        rnd = _FoldRound(engine, list(items), now, futures, on_done,
                         trace_parent)
        with self._cv:
            busy = self._active > 0 or bool(self._queue)
            self._queue.append(rnd)
            for it in items:
                self._inflight_wids[it.wid] = \
                    self._inflight_wids.get(it.wid, 0) + 1
            self._cv.notify()
        if busy and getattr(engine.aion, "pipeline_prefetch", True):
            self.stats.inc("prefetched_rounds")
            engine.prefetch_round(items, parent=trace_parent)
        return futures

    def window_in_flight(self, wid: WindowId) -> bool:
        """True while any queued/executing round references ``wid`` —
        the purge guard: predictive cleanup must not drop a window's
        blocks out from under a round that will fold them."""
        with self._cv:
            return self._inflight_wids.get(wid, 0) > 0

    @property
    def pending_rounds(self) -> int:
        with self._cv:
            return len(self._queue) + self._active

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=1.0)
                if not self._queue:                # stopping, queue empty
                    self._cv.notify_all()
                    return
                rnd = self._queue.popleft()
                self._active += 1
            try:
                out = self._execute(rnd)
                self._complete(rnd, out)
            except BaseException as exc:
                failure: Optional[BaseException] = exc
                backup = getattr(rnd.engine, "round_backup", None)
                if backup is not None:
                    # retry the round ONCE through the backup executor:
                    # folds are pure functions of bucket contents
                    # (idempotent), so re-running after a transient
                    # stage/store failure yields the same results the
                    # first attempt would have
                    self.stats.inc("round_retries")
                    try:
                        out = self._execute(rnd, via=backup.run)
                        self._complete(rnd, out)
                        self.stats.inc("round_retry_wins")
                        failure = None
                    except BaseException as exc2:
                        failure = exc2
                if failure is not None:
                    # resolve every unresolved future with the failure
                    # and remember it for drain(): a failed demand stage
                    # aborts the round loudly instead of emitting stale
                    # results
                    for fut in rnd.futures.values():
                        fut.set_error(failure)
                    with self._cv:
                        self._errors.append(failure)
            finally:
                with self._cv:
                    self._active -= 1
                    for it in rnd.items:
                        n = self._inflight_wids.get(it.wid, 1) - 1
                        if n <= 0:
                            self._inflight_wids.pop(it.wid, None)
                        else:
                            self._inflight_wids[it.wid] = n
                    self._cv.notify_all()

    def _execute(self, rnd: _FoldRound,
                 via: Optional[Callable] = None) -> Dict:
        """Fold one round, holding the pool's deferred-fill lease: arena
        fills committed while the round runs (its own demand fills, and
        the I/O thread's overlapped staging) are buffered and land as
        ONE batched ``index_copy_`` at the round's pinned snapshot (or
        at the lease exit) instead of one small write each. (The JAX
        package holds the same lease for another reason, XLA's buffer
        donation; the port's arena is written in place.) The fold runs
        with the engine's device current on whichever thread runs it:
        the worker, or the backup executor's thread on a retry. ``via``
        routes the call through a wrapper (the engine's backup executor
        on retry)."""
        eng = rnd.engine
        pool = getattr(eng, "pool", None)
        lease = pool.deferred_fills() if pool is not None \
            else contextlib.nullcontext()
        dev = getattr(eng, "device", None)
        on_card = dev is not None and dev.type == "cuda"

        def fold():
            ctx = torch.cuda.device(dev) if on_card \
                else contextlib.nullcontext()
            with ctx:
                if rnd.trace_parent is not None:
                    return eng.batch_exec.execute(
                        rnd.items, rnd.now, trace_parent=rnd.trace_parent)
                return eng.batch_exec.execute(rnd.items, rnd.now)
        with lease:
            return via(fold) if via is not None else fold()

    def _complete(self, rnd: _FoldRound, out: Dict) -> None:
        for it in rnd.items:
            rnd.futures[it.wid].set_result(out.get(it.wid))
        rnd.engine.metrics.pipeline_rounds += 1
        self.stats.inc("rounds")
        if rnd.on_done is not None:
            rnd.on_done()

    # -------------------------------------------------------------- drain
    def drain(self, timeout: float = 120.0,
              raise_on_error: bool = True) -> bool:
        """Wait until every submitted round has executed. Returns False
        on timeout. With ``raise_on_error`` (the close/checkpoint
        contract), any round failure recorded since the last drain
        re-raises as ``PipelineError``."""
        deadline = _time.time() + timeout
        with self._cv:
            while self._queue or self._active:
                remaining = deadline - _time.time()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
            errors = list(self._errors)
            self._errors.clear()
        if errors and raise_on_error:
            raise PipelineError(
                f"{len(errors)} fold round(s) failed; first: "
                f"{type(errors[0]).__name__}: {errors[0]}") from errors[0]
        return True

    def close(self) -> None:
        with self._cv:
            self._stop = True
            # rounds never executed resolve their futures with an error
            # (a closed pipeline must not leave waiters hanging)
            abandoned = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        exc = PipelineError("pipeline closed before round executed")
        for rnd in abandoned:
            for fut in rnd.futures.values():
                fut.set_error(exc)
        self._thread.join(timeout=10)


# --------------------------------------------------------------- tenancy
@dataclass
class TenantSpec:
    """Runtime description of one tenant stream (see
    ``configs.workloads.TenantProfile`` for the declarative form and
    ``MultiTenantEngine.from_profiles`` for the conversion). The operator
    is built on the engine's device by the caller."""
    name: str
    assigner: Any                          # WindowAssigner
    operator: Any                          # WindowOperator
    value_width: int = 1
    weight: int = 1                        # I/O fairness weight (WRR)
    device_budget_bytes: int = 64 << 20    # tenant cap inside the shared
    host_budget_bytes: Optional[int] = None
    policy: Any = None
    trigger: Any = None
    cleanup: Any = None


class MultiTenantEngine:
    """N independent keyed streams multiplexed onto one engine's worth
    of shared resources.

    Shared: the device budget (each tenant reserves through a
    ``TenantBudget`` capped slice), the single transfer executor (tasks
    tenant-tagged; weighted round-robin within each priority class),
    the block store (safe: records key by globally-unique block ids),
    the device arena (tenants whose operator has the batch contract and
    whose value width matches the arena's), and the fold pipeline
    (rounds from all tenants serialize in submission order).

    Per tenant: a full ``StreamEngine`` — windows, watermark tracker,
    cleanup histogram, re-execution plans, metrics — so event-time
    semantics never couple across tenants.

    ``device`` is resolved as every entry point of the port resolves it:
    ``None`` is the card, and raises where CUDA is missing.
    """

    def __init__(self, specs: List[TenantSpec], *,
                 device_budget_bytes: int = 1 << 30,
                 spill_dir=None,
                 aion=None,
                 sequential_io: bool = True,
                 simulated_seconds_per_byte: float = 0.0,
                 device=None):
        from repro_torch._device import resolve_device
        from repro_torch.configs.base import AionConfig
        from repro_torch.core.buckets import MemoryBudget, TenantBudget
        from repro_torch.core.engine import StreamEngine
        from repro_torch.core.staging import IOScheduler, TransferExecutor
        if not specs:
            raise ValueError("MultiTenantEngine needs at least one tenant")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.device = resolve_device(device)
        self.aion = aion or AionConfig()
        # ONE registry + tracer for the whole multiplexed stack: per-
        # tenant series are label children, so observability() covers
        # every tenant, the shared executor, store, arena, and pipeline
        self.registry = MetricsRegistry()
        self.tracer = Tracer(sample_rate=self.aion.trace_sample_rate,
                             capacity=self.aion.trace_ring_max)
        self.budget = MemoryBudget(device_budget_bytes)
        self.store = None
        if spill_dir is not None:
            from repro_torch.storage import make_store
            self.store = make_store(
                self.aion.store_backend, spill_dir,
                segment_bytes=self.aion.store_segment_bytes,
                sim_spb=simulated_seconds_per_byte,
                readahead_bytes=self.aion.store_readahead_bytes,
                registry=self.registry)
        self.executor = TransferExecutor(sequential_io=sequential_io,
                                         registry=self.registry)
        # one shared arena, sized for the width most tenant device
        # traffic uses; tenants with another width (or no batch
        # contract) take the legacy per-block path through their
        # TenantBudget — still correct, just unpooled
        self.pool = None
        if self.aion.block_pool and self.aion.batched_execution:
            widths = [s.value_width for s in specs
                      if s.operator.supports_batch]
            if widths:
                from repro_torch.core.block_pool import DeviceBlockPool
                width = max(set(widths), key=widths.count)
                pool = DeviceBlockPool(
                    self.aion.pool_slots, self.aion.block_size, width,
                    max_arena_bytes=device_budget_bytes // 2,
                    registry=self.registry, device=self.device)
                if pool.pool_slots > 0 \
                        and self.budget.try_reserve(pool.arena_bytes):
                    self.pool = pool
        self.pipeline = EnginePipeline(registry=self.registry) \
            if self.aion.pipelined_execution else None
        self.engines: Dict[str, Any] = {}
        for spec in specs:
            budget = TenantBudget(self.budget, spec.device_budget_bytes)
            pool = self.pool if (
                self.pool is not None and spec.operator.supports_batch
                and spec.value_width == self.pool.width) else None
            io = IOScheduler(
                budget, executor=self.executor, tenant=spec.name,
                io_weight=spec.weight,
                host_budget_bytes=spec.host_budget_bytes,
                simulated_seconds_per_byte=simulated_seconds_per_byte,
                pool=pool, store=self.store, owns_store=False,
                compact_ratio=self.aion.store_compact_ratio,
                registry=self.registry, tracer=self.tracer,
                device=self.device)
            self.engines[spec.name] = StreamEngine(
                assigner=spec.assigner, operator=spec.operator,
                aion=self.aion, value_width=spec.value_width,
                policy=spec.policy, trigger=spec.trigger,
                cleanup=spec.cleanup, io=io, pipeline=self.pipeline,
                simulated_seconds_per_byte=simulated_seconds_per_byte)

    @classmethod
    def from_profiles(cls, profiles, *, device_budget_bytes: int = 1 << 30,
                      host_budget_bytes: Optional[int] = None,
                      spill_dir=None, aion=None, device=None, **kw):
        """Build from declarative ``configs.workloads.TenantProfile``
        entries: each profile's workload resolves to its operator/
        assigner (on ``device``) and its budget fractions slice the
        shared totals."""
        from repro_torch._device import resolve_device
        from repro_torch.configs.base import AionConfig
        from repro_torch.core.operators import make_operator
        from repro_torch.core.windows import TumblingWindows
        aion = aion or AionConfig()
        device = resolve_device(device)
        specs = []
        for p in profiles:
            w = p.workload
            width = w.resolved_value_width()
            # each keyed operator takes its key count under its own name
            # (the JAX package passes num_keys to lrb too, which raises)
            op_kw = {"stock": {"num_keys": w.num_keys},
                     "lrb": {"num_segments": w.num_keys}}.get(w.operator, {})
            specs.append(TenantSpec(
                name=p.name,
                assigner=TumblingWindows(w.window_duration),
                operator=make_operator(w.operator, aion.block_size,
                                       width, device=device, **op_kw),
                value_width=width,
                weight=p.weight,
                device_budget_bytes=max(
                    int(device_budget_bytes * p.device_budget_frac), 1),
                host_budget_bytes=(
                    max(int(host_budget_bytes * p.host_budget_frac), 1)
                    if host_budget_bytes is not None else None)))
        return cls(specs, device_budget_bytes=device_budget_bytes,
                   spill_dir=spill_dir, aion=aion, device=device, **kw)

    # ---------------------------------------------------------- streaming
    def engine(self, tenant: str):
        return self.engines[tenant]

    def ingest(self, tenant: str, batch, now: float) -> None:
        self.engines[tenant].ingest(batch, now)

    def advance_watermark(self, wm: float, now: float,
                          tenant: Optional[str] = None) -> None:
        """Advance one tenant's watermark, or every tenant's (each
        stream has its own event-time domain and tracker)."""
        targets = [self.engines[tenant]] if tenant is not None \
            else self.engines.values()
        for eng in targets:
            eng.advance_watermark(wm, now)

    def poll(self, now: float, tenant: Optional[str] = None) -> None:
        targets = [self.engines[tenant]] if tenant is not None \
            else self.engines.values()
        for eng in targets:
            eng.poll(now)

    def results(self, tenant: str) -> Dict[WindowId, Any]:
        return dict(self.engines[tenant].results)

    def fairness_stats(self) -> Dict[str, int]:
        """Tasks the shared executor ran, by tenant."""
        return dict(self.executor.stats["tenant_executed"])

    def observability(self, export: Optional[str] = None):
        """One snapshot covering every tenant engine plus the shared
        executor, store, pool, pipeline, and tenant fairness. ``export``
        renders it: ``"prometheus"`` -> text exposition of the shared
        registry, ``"json"`` -> JSON string, ``None`` -> nested dict."""
        if export is not None:
            from repro_torch.obs import to_json, to_prometheus
            return to_prometheus(self.registry) if export == "prometheus" \
                else to_json(self.registry)
        snap = {
            "tenants": {name: eng.observability()
                        for name, eng in self.engines.items()},
            "executor": self.executor.stats.copy(),
            "tenant_fairness": self.fairness_stats(),
            "pipeline": self.pipeline.stats.copy()
            if self.pipeline is not None else {},
            "store": self.store.stats.copy()
            if self.store is not None else {},
            "pool": self.pool.stats.copy()
            if self.pool is not None else {},
            "trace": self.tracer.stats(),
            "registry": self.registry.snapshot(),
        }
        return snap

    def close(self) -> None:
        if self.pipeline is not None:
            self.pipeline.drain(raise_on_error=True)
        for eng in self.engines.values():
            eng.close()
        if self.pipeline is not None:
            self.pipeline.close()
        self.executor.shutdown()
        if self.store is not None:
            self.store.close()
