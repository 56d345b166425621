"""The AION streaming engine (paper §3): event-time windows whose state
lives across memory tiers, with proactive caching, predictive cleanup, and
staleness-driven re-execution of past windows.

Control flow (host-side orchestration; operator folds are jit-compiled):

  ingest(batch, now)      assign -> append (policy places blocks) ->
                          late events feed cleanup histogram + re-exec plans
  advance_watermark(wm)   expire windows -> live execution -> destage
  poll(now)               due pre-staging -> due late re-executions (lower
                          priority than live work) -> predictive cleanup ->
                          global-policy pressure tick

Live executions always run before late re-executions (the paper's priority
rule); window re-execution is a pure function of bucket contents, which is
what makes straggler backup execution idempotent (distributed/fault.py).

Execution routing: when ``AionConfig.batched_execution`` is on (default)
and the operator implements the batch contract, all due windows of one
priority class fold in a single device pass through ``core.batch_exec``;
the per-window ``execute_window`` path is retained as the reference.

With ``AionConfig.pipelined_execution`` the fold rounds run on a worker
thread (``core.pipeline.EnginePipeline``) while ingestion continues, and
``prefetch_backend="learned"`` swaps the fixed-margin pre-stage scheduler
for the lateness-model-driven segment planner (``repro_torch.prefetch``).

With ``AionConfig.slot_sharding`` on and a slot mesh of two or more
entries (``slot_mesh``), that single pass additionally partitions window
slots across the mesh — one kernel launch per shard on its own device
and arena tile, the tiles concatenated along the slot axis, no
cross-device reduction; see ``core.batch_exec`` for the placement step.

The engine runs on ``device`` (None: the card). ``slot_devices`` lists
the mesh's devices (one may repeat); without it the mesh takes the local
CUDA devices, and an engine on the CPU stays unsharded (the JAX
package's no-op on one device).
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch._device import resolve_device, to_numpy
from repro_torch.configs.base import AionConfig
from repro_torch.core.batch_exec import (
    BatchExecutor, BatchWorkItem, snapshot_block_partition,
)
from repro_torch.core.buckets import Block, MemoryBudget, Tier, WindowState
from repro_torch.core.cleanup import PredictiveCleanup
from repro_torch.core.events import EventBatch
from repro_torch.core.operators import WindowOperator
from repro_torch.core.policies import (
    EngineOOM, InMemoryPolicy, StandardPolicy, TransferPolicy,
)
from repro_torch.core.proactive import PrestageScheduler, StagingCostModel
from repro_torch.core.staging import IOScheduler
from repro_torch.core.time import PeriodicWatermarkGenerator, WatermarkTracker
from repro_torch.core.triggers import AionStalenessTrigger, Trigger
from repro_torch.core.windows import WindowAssigner, WindowId


# BoundedSeries moved to repro.obs.registry (every telemetry surface
# shares it now); re-exported here so existing imports keep working.
from repro_torch.obs import (BoundedSeries, MetricsRegistry, Tracer,  # noqa: E402
                       NULL_SPAN)


def slot_mesh(aion: AionConfig, device, slot_devices=None):
    """The slot mesh ``aion`` asks for on an engine running on
    ``device``: None unless ``slot_sharding`` is on and the mesh has two
    or more entries. ``slot_devices`` None takes the local CUDA devices
    for an engine on the card, and the engine's own device otherwise
    (one entry: no mesh). The first entry must be the engine's device:
    the shards' outputs meet there."""
    if not aion.slot_sharding:
        return None
    from repro_torch.distributed.sharding import make_slot_mesh
    if slot_devices is None and device.type != "cuda":
        slot_devices = [device]
    mesh = make_slot_mesh(aion.slot_shard_devices, aion.slot_shard_axis,
                          devices=slot_devices)
    if mesh is not None:
        first = mesh.devices[0]
        if first.type != device.type or (
                device.index is not None and first.index != device.index):
            raise ValueError(f"the slot mesh starts on {first}, the engine "
                             f"runs on {device}")
    return mesh


class EngineMetrics:
    """Engine counters, registry-backed behind the legacy attribute API.

    Every scalar below lives in a shared :class:`~repro.obs.MetricsRegistry`
    (labelled by tenant), so ``engine.observability()`` and the Prometheus
    exporter see the same numbers the legacy ``metrics.ingested += 1``
    call sites maintain — attribute reads/writes route through
    ``__getattr__``/``__setattr__`` onto the instruments and no call site
    changes. The list-valued series stay plain (bounded) lists: tests
    slice them, and ``ladder_transitions`` must support aliasing to
    ``StoreHealth.transitions``.
    """

    #: scalar field -> instrument kind
    _SCALARS = {
        "ingested": "counter", "ingested_late": "counter",
        "dropped": "counter",
        "live_executions": "counter", "late_executions": "counter",
        "purged_windows": "counter", "purged_bytes": "counter",
        "fetch_stall_seconds": "counter", "exec_seconds": "counter",
        # batched execution path: one entry per device pass
        "batch_executions": "counter", "batched_windows": "counter",
        # device passes that ran slot-sharded across a multi-device mesh
        "sharded_batch_executions": "counter",
        "batch_device_seconds": "counter",
        # batch assembly outside the fold call (row stack / table build)
        "batch_gather_seconds": "counter",
        # waiting on overlapped demand pool-fills (I/O the fold hid)
        "batch_stall_seconds": "counter",
        # block-table rows folded straight from the pool arena vs rows
        # that degraded to the stacked gather; demand fills issued by
        # the executor
        "pooled_rows": "counter", "fallback_rows": "counter",
        "demand_pool_fills": "counter",
        # pipelined execution: rounds folded by the pipeline worker;
        # rows whose pool-slot epoch moved between classification and
        # dispatch (demoted to the stacked fallback)
        "pipeline_rounds": "counter", "epoch_demoted_rows": "counter",
        # split-K chunked fold launches
        "splitk_launches": "counter",
        # self-healing ladder: current rung + per-rung shed footprint
        "degradation_level": "gauge",
        "shed_readahead_drives": "counter",
        "shed_prefetch_rounds": "counter",
        "demoted_sync_rounds": "counter",
        "deferred_events": "counter", "readmitted_events": "counter",
        # per-poll byte samples double as gauges (set by snapshot())
        "device_bytes": "gauge", "host_bytes": "gauge",
    }

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tenant: str = "default", series_max: int = 0):
        d = self.__dict__
        if registry is None:
            registry = MetricsRegistry()
        d["registry"] = registry
        d["tenant"] = tenant
        insts = {}
        for name, kind in self._SCALARS.items():
            fam = registry.gauge(f"aion_engine_{name}",
                                 labelnames=("tenant",)) \
                if kind == "gauge" else \
                registry.counter(f"aion_engine_{name}",
                                 labelnames=("tenant",))
            insts[name] = fam.labels(tenant)
        d["_inst"] = insts
        # ladder_transitions aliases StoreHealth.transitions once the
        # engine builds its breaker (single source of truth for the shed
        # order); bounded here too for breaker-less engines
        d["ladder_transitions"] = BoundedSeries(series_max)
        d["batch_occupancy_series"] = BoundedSeries(series_max)
        d["device_bytes_series"] = BoundedSeries(series_max)
        d["host_bytes_series"] = BoundedSeries(series_max)
        # fold-round latency histogram (observed by the batch executor)
        d["fold_seconds"] = registry.histogram(
            "aion_fold_round_seconds", "device seconds per fold round",
            labelnames=("tenant",)).labels(tenant)

    def __getattr__(self, name):
        try:
            return self.__dict__["_inst"][name].value
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value) -> None:
        inst = self.__dict__["_inst"].get(name)
        if inst is not None:
            inst.set(value)
        else:
            object.__setattr__(self, name, value)

    @classmethod
    def bounded(cls, maxlen: int) -> "EngineMetrics":
        """Metrics whose per-poll series hold at most ``maxlen`` recent
        entries (``AionConfig.metrics_series_max``) — a long-running
        engine must not leak memory through its own telemetry."""
        return cls(series_max=maxlen)

    def scalars(self) -> Dict[str, Any]:
        """Flat {field: value} view of every registry-backed scalar."""
        return {name: inst.value
                for name, inst in self.__dict__["_inst"].items()}

    def snapshot(self, now: float, device_bytes: int, host_bytes: int):
        self.device_bytes_series.append((now, device_bytes))
        self.host_bytes_series.append((now, host_bytes))
        self.device_bytes = device_bytes       # registry gauges
        self.host_bytes = host_bytes

    @property
    def mean_batch_occupancy(self) -> float:
        """Windows folded per device pass (1.0 == no batching win)."""
        if not self.batch_occupancy_series:
            return 0.0
        return float(np.mean(self.batch_occupancy_series))

    @property
    def device_seconds_per_execution(self) -> float:
        if not self.batched_windows:
            return 0.0
        return self.batch_device_seconds / self.batched_windows


@dataclass
class _ReexecPlan:
    times: List[float]          # absolute processing times
    next_idx: int = 0


class StreamEngine:
    def __init__(self, *,
                 assigner: WindowAssigner,
                 operator: WindowOperator,
                 aion: Optional[AionConfig] = None,
                 value_width: int = 1,
                 policy: Optional[TransferPolicy] = None,
                 trigger: Optional[Trigger] = None,
                 cleanup: Optional[PredictiveCleanup] = None,
                 watermark_gen: Optional[PeriodicWatermarkGenerator] = None,
                 device_budget_bytes: int = 1 << 30,
                 spill_dir: Optional[Path] = None,
                 host_budget_bytes: Optional[int] = None,
                 prestage_enabled: bool = True,
                 sequential_io: bool = True,
                 chunk_blocks: int = 4,
                 punctuated: bool = False,
                 simulated_seconds_per_byte: float = 0.0,
                 store=None,
                 io: Optional[IOScheduler] = None,
                 pipeline=None,
                 device=None,
                 slot_devices=None):
        self.aion = aion or AionConfig()
        self.device = io.device if io is not None \
            else resolve_device(device)
        #: the slot mesh of ``AionConfig.slot_sharding`` (None: unsharded)
        self.slot_mesh = slot_mesh(self.aion, self.device, slot_devices)
        self.assigner = assigner
        self.operator = operator
        self.value_width = value_width
        self._owns_io = io is None
        if io is not None:
            # shared-infrastructure mode (MultiTenantEngine): the caller
            # built the scheduler, and with it the budget, device pool
            # and store this engine must use — and owns their lifecycle
            # (close() will not shut them down). The observability plane
            # is shared the same way: adopt the scheduler's registry and
            # tracer so every tenant's metrics land in one snapshot.
            self.io = io
            self.budget = io.budget
            self.pool = io.pool
            self.store = io.store if store is None else store
            self.registry = io.registry
            self.tracer = io.tracer
        else:
            self.registry = MetricsRegistry()
            self.tracer = Tracer(
                sample_rate=self.aion.trace_sample_rate,
                capacity=self.aion.trace_ring_max)
            # persistent tier of the p-bucket: an explicit BlockStore,
            # or one built from the config backend under spill_dir
            # ('log' by default — the legacy file-per-block npz backend
            # stays available as AionConfig.store_backend='npz')
            if store is None and spill_dir is not None:
                from repro_torch.storage import make_store
                store = make_store(
                    self.aion.store_backend, spill_dir,
                    segment_bytes=self.aion.store_segment_bytes,
                    sim_spb=simulated_seconds_per_byte,
                    readahead_bytes=self.aion.store_readahead_bytes,
                    registry=self.registry)
            self.store = store
            self.budget = MemoryBudget(device_budget_bytes)
            # persistent device block pool: staging becomes arena fills
            # and the batched fold consumes block tables (zero-copy
            # gather). The pool shards its slot ranges to the slot mesh
            # so a window's arena rows live on the device that folds
            # them. Only built when the batched path can actually
            # consume block tables — per-window engines (batching off,
            # or a no-contract operator like percentile) keep the legacy
            # device_data fast path. The arena's bytes are reserved from
            # the device budget up front; pooled fills then cost a slot,
            # not a second reservation.
            self.pool = None
            if self.aion.block_pool and self.aion.batched_execution \
                    and operator.supports_batch:
                from repro_torch.core.block_pool import DeviceBlockPool
                # the arena may take at most HALF the budget: the legacy
                # per-block path keeps headroom, and utilization-driven
                # policies (GlobalMemoryPolicy's moderate/severe
                # thresholds) can always get below their lines by
                # destaging per-block reservations — an arena sized to
                # the full budget would pin utilization at 100% forever
                # (destaging a pooled block frees a slot, not budget
                # bytes)
                mesh = self.slot_mesh
                pool = DeviceBlockPool(
                    self.aion.pool_slots, self.aion.block_size,
                    value_width,
                    num_shards=mesh.size if mesh is not None else 1,
                    max_arena_bytes=device_budget_bytes // 2,
                    registry=self.registry, device=self.device,
                    devices=mesh.devices if mesh is not None else None)
                if pool.pool_slots > 0 \
                        and self.budget.try_reserve(pool.arena_bytes):
                    self.pool = pool
                # else: a budget too small to back even one slot per
                # shard within the half-budget cap — degrade to the
                # legacy per-block path
            self.io = IOScheduler(
                self.budget, sequential_io=sequential_io,
                chunk_blocks=chunk_blocks, spill_dir=spill_dir,
                host_budget_bytes=host_budget_bytes,
                simulated_seconds_per_byte=simulated_seconds_per_byte,
                pool=self.pool, store=self.store,
                compact_ratio=self.aion.store_compact_ratio,
                wal_coalesce=self.aion.wal_coalesce_commits,
                io_retry_limit=self.aion.io_retry_limit,
                io_retry_backoff=self.aion.io_retry_backoff,
                registry=self.registry, tracer=self.tracer,
                device=self.device)
        self.policy = policy or StandardPolicy()
        self.cleanup = cleanup or PredictiveCleanup(
            coverage=self.aion.cleanup_coverage,
            confidence=self.aion.cleanup_confidence)
        self.trigger = trigger or AionStalenessTrigger(
            cleanup=self.cleanup, max_staleness=self.aion.max_staleness)
        self.watermark_gen = watermark_gen
        self.tracker = WatermarkTracker()
        self.prestage_enabled = prestage_enabled
        # pre-stage lead time floor: a quarter of the watermark period
        # (the paper starts the first pre-staging a full window early)
        self.prestage_margin = 0.25 * (
            watermark_gen.period if watermark_gen is not None
            else self.aion.watermark_period)
        if self.aion.prefetch_backend == "learned":
            from repro_torch.prefetch import LearnedPrestageScheduler
            self.prestage = LearnedPrestageScheduler(
                self.aion, punctuated=punctuated,
                margin=self.prestage_margin)
        else:
            self.prestage = PrestageScheduler(StagingCostModel(),
                                              punctuated=punctuated)
        self.windows: Dict[WindowId, WindowState] = {}
        self.reexec_plans: Dict[WindowId, _ReexecPlan] = {}
        self.metrics = EngineMetrics(
            registry=self.registry, tenant=self.io.tenant,
            series_max=self.aion.metrics_series_max)
        self.results: Dict[WindowId, Any] = {}
        self.batch_exec = BatchExecutor(self)
        # pipelined execution (core/pipeline.py): fold rounds submit to
        # a worker instead of running inline; results additionally
        # resolve through result_futures. A passed-in pipeline is shared
        # infrastructure (multi-tenant) and not closed by this engine.
        # Only meaningful on the batched path — a no-contract operator
        # keeps the synchronous reference loop.
        self._owns_pipeline = False
        if pipeline is not None:
            self.pipeline = pipeline if self.batching_enabled else None
        elif self.aion.pipelined_execution and self.batching_enabled:
            from repro_torch.core.pipeline import EnginePipeline
            self.pipeline = EnginePipeline(registry=self.registry)
            self._owns_pipeline = True
        else:
            self.pipeline = None
        self.result_futures: Dict[WindowId, Any] = {}
        # --- self-healing I/O path -------------------------------------
        # circuit breaker on store health driving the degradation ladder
        # (core/health.py); per-engine, so only built when this engine
        # owns its scheduler (a shared multi-tenant scheduler would get
        # conflicting breakers). breaker_error_threshold=0 disables.
        self.health = None
        if self._owns_io and self.aion.breaker_error_threshold > 0:
            from repro_torch.core.health import StoreHealth
            self.health = StoreHealth(
                error_threshold=self.aion.breaker_error_threshold,
                cooldown_ticks=self.aion.breaker_cooldown_ticks,
                registry=self.registry,
                max_transitions=self.aion.health_transitions_max,
                tenant=self.io.tenant)
            self.io.health = self.health
            # single source of truth for the shed order: the metrics
            # field aliases the breaker's transition log
            self.metrics.ladder_transitions = self.health.transitions
        self._health_signal_last = 0
        # ingest backpressure (ladder rung 4): deferred (batch, now)
        # pairs readmitted by poll() once the breaker steps back down —
        # deferral is bounded ADMISSION, not loss: every deferred batch
        # is eventually folded (flush_deferred() is the drain barrier)
        self._deferred: List[Tuple[EventBatch, float]] = []
        # failed pipelined fold rounds retry ONCE through a backup
        # executor (folds are pure functions of bucket contents —
        # idempotent). min_deadline is large so the straggler race never
        # issues a CONCURRENT duplicate against this engine's pool state;
        # the retry itself (after the primary failed) is sequential.
        self.round_backup = None
        if self.pipeline is not None and self.aion.fold_round_retry:
            from repro_torch.distributed.fault import BackupExecutor
            self.round_backup = BackupExecutor(workers=2,
                                               min_deadline=30.0)

    @property
    def batching_enabled(self) -> bool:
        """Batched path is on AND the operator implements the contract."""
        return self.aion.batched_execution and self.operator.supports_batch

    # ------------------------------------------------------------- helpers
    @property
    def is_baseline(self) -> bool:
        return isinstance(self.policy, InMemoryPolicy)

    def _state_for(self, wid: WindowId) -> WindowState:
        st = self.windows.get(wid)
        if st is None:
            st = WindowState(wid.start, wid.end, self.value_width,
                             self.aion.block_size)
            self.windows[wid] = st
        return st

    def device_bytes(self) -> int:
        return self.budget.used_bytes

    def host_bytes(self) -> int:
        return sum(s.host_bytes() for s in self.windows.values())

    # -------------------------------------------------------------- ingest
    def ingest(self, batch: EventBatch, now: float) -> int:
        """Admit a batch of events. Returns the number of events
        DEFERRED by ingest backpressure (0 = fully admitted): at the
        ladder's top rung admission is bounded and overflow batches park
        in the deferral queue, to be readmitted by ``poll`` when the
        breaker steps down (or force-drained by ``flush_deferred``).
        Deferral is visible, not silent — callers that care (soak
        drivers, serving layers) can count what was deferred."""
        if len(batch) == 0:
            return 0
        span = self.tracer.root("ingest", events=len(batch))
        if self.health is not None and self.health.backpressures():
            self._deferred.append((batch, now))
            self.metrics.deferred_events += len(batch)
            span.end(deferred=len(batch))
            return len(batch)
        with span:
            self._admit(batch, now, span=span)
        return 0

    def _admit(self, batch: EventBatch, now: float,
               span=NULL_SPAN) -> None:
        if self.watermark_gen is not None:
            self.watermark_gen.observe(batch.timestamps)
        wm = self.tracker.watermark
        late_mask = batch.timestamps < wm
        lateness = wm - batch.timestamps[late_mask]
        if len(lateness):
            self.cleanup.observe(lateness)
        self.metrics.ingested += len(batch)
        n_late = int(late_mask.sum())
        self.metrics.ingested_late += n_late
        if span.sampled:
            span.set(late=n_late, watermark=wm)

        identity = None
        for wid, idx in self.assigner.assign(batch.timestamps):
            # select by the index list DIRECTLY (fancy indexing keeps
            # order and duplicates). The old mask-based selection took
            # the whole batch whenever len(idx) == len(batch) — which
            # misfiles events for any assigner whose full-length index
            # list is not the identity — and silently deduplicated
            # repeated indices. Only a verified identity skips the copy.
            idx = np.asarray(idx, np.intp)
            if len(idx) == len(batch):
                if identity is None:
                    identity = np.arange(len(batch))
                sub = batch if np.array_equal(idx, identity) \
                    else batch.select(idx)
            else:
                sub = batch.select(idx)
            state = self._state_for(wid)
            late = wid.end <= wm
            new_blocks = state.append_events(sub, late)
            self.policy.on_append(state, new_blocks, self.io, late, now)
            if late:
                self.io.request_late_write(state, new_blocks, parent=span)
                self._plan_reexecutions(wid, state, now)
                if self.prestage_enabled and len(sub) and np.isfinite(wm):
                    # per-key lateness samples for the learned prefetch
                    # backend's CDF fits (no-op on the fixed scheduler)
                    self.prestage.observe_late(
                        wid, sub.keys,
                        np.maximum(wm - sub.timestamps, 1e-9))
                if self.prestage_enabled:
                    plan = self.reexec_plans.get(wid)
                    if plan and plan.next_idx < len(plan.times):
                        self.prestage.plan(wid, state,
                                           plan.times[plan.next_idx], now,
                                           self.prestage_margin)

        if self.watermark_gen is not None:
            wm_new = self.watermark_gen.maybe_emit(now)
            if wm_new is not None:
                self.advance_watermark(wm_new, now, trace_parent=span)

    def flush_deferred(self, now: Optional[float] = None) -> int:
        """Force-admit every backpressure-deferred batch (each at its
        original ingest time unless ``now`` overrides). The drain
        barrier paths (close, checkpoint, end-of-stream sweeps) call
        this so deferral never turns into loss. Returns events
        admitted."""
        n = 0
        while self._deferred:
            batch, t = self._deferred.pop(0)
            n += len(batch)
            self.metrics.readmitted_events += len(batch)
            self._admit(batch, now if now is not None else t)
        return n

    def _readmit_deferred(self, now: float) -> None:
        """Per-poll backpressure drain: below the top rung the whole
        queue readmits (the breaker closed — service resumes); at the
        top rung one oldest batch trickles through per poll so deferred
        events still make progress under sustained pressure."""
        if not self._deferred:
            return
        if self.health is not None and self.health.backpressures():
            batch, t = self._deferred.pop(0)
            self.metrics.readmitted_events += len(batch)
            self._admit(batch, t)
            return
        self.flush_deferred()

    def _health_tick(self) -> None:
        """Feed the breaker one poll tick: the delta of I/O errors +
        retries since the last tick is the health signal (a store that
        stopped failing produces zero and cools the ladder down)."""
        if self.health is None:
            return
        sig = self.io.stats["errors"] + self.io.stats["retries"]
        delta = sig - self._health_signal_last
        self._health_signal_last = sig
        self.metrics.degradation_level = self.health.tick(delta)

    def _plan_reexecutions(self, wid: WindowId, state: WindowState,
                           now: float) -> None:
        if wid in self.reexec_plans and \
                self.reexec_plans[wid].next_idx < len(self.reexec_plans[wid].times):
            return
        horizon = max(self.cleanup.current_bound(), 1e-6)
        offsets = np.asarray(self.trigger.plan(horizon), np.float64)
        expiry_time = state.last_executed_at if np.isfinite(
            state.last_executed_at) else now
        times = [max(expiry_time + o, now) for o in offsets if
                 expiry_time + o > now - 1e-9]
        if not times:
            times = [now]
        self.reexec_plans[wid] = _ReexecPlan(times=times)

    # ----------------------------------------------------------- watermark
    def advance_watermark(self, wm: float, now: float,
                          trace_parent=None) -> None:
        if not self.tracker.advance(wm):
            return
        # root span unless ingest's maybe_emit handed us its span — the
        # explicit parent is what lets a late event's trace follow the
        # advance onto the pipeline worker thread (no thread-locals)
        span = (self.tracer.child(trace_parent, "watermark_advance", wm=wm)
                if trace_parent is not None
                else self.tracer.root("watermark_advance", wm=wm))
        due = [wid for wid in sorted(self.windows)
               if not self.windows[wid].expired and wid.end <= wm]
        if span.sampled:
            span.set(due=len(due))
        demote = (self.pipeline is not None and self.health is not None
                  and self.health.demotes_rounds())
        if demote and due:
            # ladder rung 3: the pipeline would QUEUE rounds against a
            # failing store — demote to the synchronous batched path (no
            # overlap, but nothing in flight to lose either)
            self.metrics.demoted_sync_rounds += 1
            span.event("demoted_sync")
            for wid in due:
                self.windows[wid].expired = True
            self.batch_exec.execute(
                [BatchWorkItem(wid, self.windows[wid], False)
                 for wid in due], now, trace_parent=span)
            for wid in due:
                self.policy.on_expiry(self.windows[wid], self.io, now)
        elif self.pipeline is not None and due:
            # pipelined: the watermark advance fences only the slots it
            # closes — the round (and the expiry destages, which must
            # run AFTER the fold reads the blocks) executes on the
            # pipeline worker while ingestion keeps appending; results
            # resolve through result_futures
            for wid in due:
                self.windows[wid].expired = True
            self._submit_round(
                [BatchWorkItem(wid, self.windows[wid], False)
                 for wid in due], now, expiry=True, parent=span)
        elif self.batching_enabled and len(due) > 1:
            # live batch: every newly-expired window folds in one pass
            for wid in due:
                self.windows[wid].expired = True
            self.batch_exec.execute(
                [BatchWorkItem(wid, self.windows[wid], False)
                 for wid in due], now, trace_parent=span)
            for wid in due:
                self.policy.on_expiry(self.windows[wid], self.io, now)
        else:
            for wid in due:
                state = self.windows[wid]
                state.expired = True
                self.execute_window(wid, now, late=False)
                self.policy.on_expiry(state, self.io, now)
        span.end()

    def _submit_round(self, items: List[BatchWorkItem], now: float,
                      expiry: bool = False, parent=None) -> None:
        """Submit one fold round to the pipeline; with ``expiry`` the
        transfer policy's on_expiry hooks run on the worker after the
        round folds (same order the synchronous path guarantees —
        destaging a window before its fold read the blocks would turn
        the whole round cold)."""
        on_done = None
        if expiry:
            states = [it.state for it in items]

            def on_done():
                for st in states:
                    self.policy.on_expiry(st, self.io, now)
        futs = self.pipeline.submit(self, items, now, on_done=on_done,
                                    trace_parent=parent)
        self.result_futures.update(futs)

    # ----------------------------------------------------------- execution
    def execute_window(self, wid: WindowId, now: float, late: bool) -> Any:
        state = self.windows[wid]
        t0 = _time.time()
        stall = 0.0

        # lazy block iteration: consume m-blocks while staging p-blocks
        # (the shared snapshot helper keeps the double-fold hazard logic
        # in one place)
        m_snapshot, p_blocks = snapshot_block_partition(state)
        stage_done = None
        stage_t0 = _time.time()
        staged_events = sum(b.fill for b in p_blocks)
        if p_blocks:
            if self.operator.blocking:
                ev = self.io.request_stage(state, p_blocks, demand=True)
                w0 = _time.time()
                ev.wait(timeout=60)
                stall += _time.time() - w0
                ev.check()      # a failed demand stage aborts the fold
            else:
                stage_done = self.io.request_stage(state, p_blocks,
                                                   demand=True)

        acc = self.operator.init_acc()
        # pass 1: blocks already on device (fetch_block_arrays prefers
        # device residency — per-block device_data or the pool arena —
        # and falls back to the accounted host read; None = purged)
        for blk in m_snapshot:
            data = self.io.fetch_block_arrays(blk)
            if data is None:
                continue                        # purged mid-execution
            acc = self.operator.fold(acc, data, blk.fill)
        # pass 2: blocks arriving from the p-bucket (staging that could
        # not reserve budget leaves them host-side; same fetch logic)
        if stage_done is not None:
            w0 = _time.time()
            stage_done.wait(timeout=60)
            stall += max(_time.time() - w0 - 0.0, 0.0)
            stage_done.check()  # surface a failed demand stage
        for blk in p_blocks:
            data = self.io.fetch_block_arrays(blk)
            if data is None:
                continue                        # purged mid-execution
            acc = self.operator.fold(acc, data, blk.fill)
        if p_blocks and staged_events:
            self.prestage.cost.observe(_time.time() - stage_t0,
                                       staged_events)

        result = self.operator.finalize(acc)
        state.result = result
        self.results[wid] = result
        state.last_executed_at = now
        state.events_at_last_exec = state.total_events
        self.metrics.fetch_stall_seconds += stall
        self.metrics.exec_seconds += _time.time() - t0
        if late:
            self.metrics.late_executions += 1
        else:
            self.metrics.live_executions += 1
        self._post_execute_destage(wid, state, now)
        return result

    def _post_execute_destage(self, wid: WindowId, state: WindowState,
                              now: float) -> None:
        # keep the m-bucket resident if another re-execution is imminent
        # (avoids destage/restage thrash between planned executions)
        plan = self.reexec_plans.get(wid)
        next_soon = (plan is not None
                     and plan.next_idx + 1 < len(plan.times)
                     and plan.times[plan.next_idx + 1] - now
                     <= 2 * self.prestage_margin)
        if not next_soon:
            self.policy.on_post_execute(state, self.io, now)

    # ----------------------------------------------------------------- poll
    def poll(self, now: float) -> None:
        # 0. breaker tick + backpressure drain: the ladder reacts to the
        #    error/retry delta of the LAST interval, and any deferred
        #    ingest readmits as soon as (and as far as) the rung allows
        span = self.tracer.root("poll", now=now)
        with span:
            self._health_tick()
            self._readmit_deferred(now)
            # 1. due late re-executions first (their demand staging
            #    outranks the speculative pre-staging issued below; live
            #    execution in advance_watermark always went before either)
            if self.batching_enabled:
                self._poll_reexec_batched(now, parent=span)
            else:
                self._poll_reexec_reference(now)
            self._poll_tail(now, parent=span)

    def _poll_reexec_reference(self, now: float) -> None:
        """Per-window reference path: one execution per due plan time."""
        for wid, plan in list(self.reexec_plans.items()):
            state = self.windows.get(wid)
            if state is None:
                del self.reexec_plans[wid]
                continue
            while plan.next_idx < len(plan.times) and \
                    plan.times[plan.next_idx] <= now:
                self.execute_window(wid, now, late=True)
                plan.next_idx += 1
                if self.prestage_enabled and plan.next_idx < len(plan.times):
                    self.prestage.plan(wid, state,
                                       plan.times[plan.next_idx], now,
                                       self.prestage_margin)

    def _poll_reexec_batched(self, now: float, parent=NULL_SPAN) -> None:
        """Batched path: every window with due re-executions folds in ONE
        device pass. A window's multiple already-due plan times collapse
        into a single execution — re-execution is a pure function of
        bucket contents, so executing once at ``now`` yields the same
        result as executing at each elapsed time."""
        due: List[Tuple[WindowId, WindowState, _ReexecPlan]] = []
        for wid, plan in list(self.reexec_plans.items()):
            state = self.windows.get(wid)
            if state is None:
                del self.reexec_plans[wid]
                continue
            n_due = 0
            while plan.next_idx + n_due < len(plan.times) and \
                    plan.times[plan.next_idx + n_due] <= now:
                n_due += 1
            if n_due:
                # leave next_idx on the LAST due time so the imminence
                # check in _post_execute_destage sees the first future one
                plan.next_idx += n_due - 1
                due.append((wid, state, plan))
        if not due:
            return
        items = [BatchWorkItem(wid, state, True) for wid, state, _ in due]
        demote = (self.pipeline is not None and self.health is not None
                  and self.health.demotes_rounds())
        if demote:
            # ladder rung 3 (see advance_watermark): fold inline
            self.metrics.demoted_sync_rounds += 1
            self.batch_exec.execute(items, now, trace_parent=parent)
        elif self.pipeline is not None:
            # late rounds queue behind any live round submitted this
            # tick (FIFO worker = the paper's live-before-late rule at
            # round granularity); plan bookkeeping advances immediately
            # — re-execution is a pure function of bucket contents, so
            # the fold's timing doesn't change its result
            self._submit_round(items, now, parent=parent)
        else:
            self.batch_exec.execute(items, now, trace_parent=parent)
        for wid, state, plan in due:
            plan.next_idx += 1
            if self.prestage_enabled and plan.next_idx < len(plan.times):
                self.prestage.plan(wid, state, plan.times[plan.next_idx],
                                   now, self.prestage_margin)

    def prefetch_round(self, items, parent=None) -> None:
        """Pipelined staging lookahead (``EnginePipeline.submit`` while
        a round is in flight): start staging the new round's cold blocks
        so their I/O overlaps the running fold. With the learned
        prefetch backend the storage half goes first — one sequential
        sweep per log segment, queued in the SAME priority class as the
        stage tasks that follow (FIFO runs the sweeps first), so the
        pool fills read cache hits instead of per-record seeks."""
        states = [it.state for it in items if it.state.p_blocks()]
        if not states:
            return
        if self.health is not None and self.health.sheds_prefetch():
            # ladder rung 2: next-round prefetch is speculative load on
            # a struggling store — the round's own demand staging will
            # still fetch what the fold needs
            self.metrics.shed_prefetch_rounds += 1
            return
        readahead_now = getattr(self.prestage, "readahead_now", None)
        if readahead_now is not None and self.io.store is not None:
            readahead_now(self.io, states)
        for state in states:
            self.io.request_stage(state, parent=parent)

    def _poll_tail(self, now: float, parent=NULL_SPAN) -> None:
        # 2. due pre-staging (for future re-executions), preceded by
        #    store readahead for the pre-stagings coming up within the
        #    lead margin: proactive caching drives the persistent tier's
        #    sequential sweep BEFORE the staging deadline, so the stage
        #    itself reads cache hits
        if self.prestage_enabled:
            if self.health is not None and self.health.sheds_readahead():
                # ladder rung 1: speculative readahead sweeps go FIRST —
                # they are pure optimization, and every sweep against a
                # failing store is another error/retry feeding the
                # breaker. Due pre-staging below still runs (it has a
                # concrete deadline).
                self.metrics.shed_readahead_drives += 1
            else:
                # polymorphic seam: the fixed scheduler issues per-window
                # point readahead; the learned one plans segment sweeps +
                # coalescing against its lateness/bandwidth models
                self.prestage.drive_readahead(self, now,
                                              self.prestage_margin)
            for wid in self.prestage.due(now):
                state = self.windows.get(wid)
                if state is not None and state.p_blocks():
                    self.io.request_stage(state, parent=parent)
        # 3. predictive cleanup: purge emits store tombstones; the
        #    compaction request after the loop consumes them (bounded
        #    storage, paper §3.4)
        purged_any = False
        wm = self.tracker.watermark
        if np.isfinite(wm):
            for wid in list(self.windows):
                state = self.windows[wid]
                if state.expired and self.cleanup.should_purge(wid.end, wm):
                    if self.pipeline is not None \
                            and self.pipeline.window_in_flight(wid):
                        # a queued/executing fold round references this
                        # window — purging now would fold empty state; the
                        # next poll retries once the round completes
                        continue
                    # drop_all reports the device bytes committed at drop
                    # time; an in-flight stage that commits later sees the
                    # dropped flag and releases its own reservation
                    freed, device_bytes = state.drop_all()
                    self.budget.release(device_bytes)
                    self.metrics.purged_windows += 1
                    self.metrics.purged_bytes += freed
                    self.prestage.cancel(wid)
                    self.reexec_plans.pop(wid, None)
                    del self.windows[wid]
                    purged_any = True
        if purged_any:
            self.io.request_compaction()
        # 4. policy tick (idle destaging / memory-pressure handling)
        self.policy.on_tick(self.windows, self.io, now)
        # per-poll byte sample: the scheduler's O(1) tracked figure
        # (destaged/storage-loaded host copies), NOT the O(windows)
        # re-sum of host_bytes() — a long-running engine polls this
        # every tick; exact full sums stay available via host_bytes()
        self.metrics.snapshot(now, self.device_bytes(),
                              self.io.host_bytes_tracked())

    # -------------------------------------------------------- observability
    def observability(self, export: Optional[str] = None):
        """One call, every surface: engine counters, I/O scheduler +
        transfer executor, store, device pool, breaker ladder and the
        trace ring's own accounting — all read off the shared metrics
        registry, so this is the same data the exporters serialize.

        ``export='prometheus'`` returns the text exposition of the whole
        registry; ``export='json'`` its flat JSON snapshot; ``None``
        (default) a nested dict keyed by subsystem.
        """
        if export is not None:
            from repro_torch.obs import to_json, to_prometheus
            if export == "prometheus":
                return to_prometheus(self.registry)
            if export == "json":
                return to_json(self.registry)
            raise ValueError(f"unknown export format: {export!r}")
        eng = self.metrics.scalars()
        eng["mean_batch_occupancy"] = self.metrics.mean_batch_occupancy
        eng["device_seconds_per_execution"] = \
            self.metrics.device_seconds_per_execution
        snap: Dict[str, Any] = {
            "engine": eng,
            "io": self.io.stats.copy(),
            "executor": self.io.executor.stats.copy(),
            "store": (self.store.stats.copy()
                      if self.store is not None else {}),
            "pool": {},
            "health": {},
            "pipeline": (self.pipeline.stats.copy()
                         if self.pipeline is not None else {}),
            "fold": {},
            "trace": self.tracer.stats(),
        }
        if self.pool is not None:
            snap["pool"] = dict(self.pool.stats.copy(),
                                free_slots=self.pool.free_slots(),
                                pool_slots=self.pool.pool_slots,
                                arena_bytes=self.pool.arena_bytes)
        if self.health is not None:
            snap["health"] = dict(self.health.stats.copy(),
                                  level=self.health.level,
                                  level_name=self.health.name,
                                  transitions=list(self.health.transitions))
        shapes = getattr(getattr(self.operator, "fold_batch", None),
                         "launch_shapes", None)
        if shapes is not None:
            # distinct fold launch shapes (the JAX package's jit cache
            # size has no eager counterpart)
            snap["fold"]["launch_shapes"] = len(shapes)
        return snap

    # ------------------------------------------------------------ shutdown
    def close(self, drain_timeout: float = 30.0) -> None:
        """Drain pipeline + I/O and shut down owned infrastructure.

        Raises: ``PipelineError`` if a pipelined round failed (or the
        pipeline cannot drain), ``RuntimeError`` if the I/O executor
        did not drain in time — close must not silently discard
        in-flight work."""
        # backpressure-deferred ingest folds BEFORE the drains: deferral
        # bounds admission, it never loses events
        self.flush_deferred()
        try:
            if self.pipeline is not None:
                from repro_torch.core.pipeline import PipelineError
                if not self.pipeline.drain(timeout=drain_timeout * 4,
                                           raise_on_error=True):
                    raise PipelineError(
                        "fold pipeline failed to drain before close")
                if self._owns_pipeline:
                    self.pipeline.close()
        finally:
            # after the drain — queued rounds may still retry through it
            if self.round_backup is not None:
                self.round_backup.shutdown()
                self.round_backup = None
        if not self.io.drain(timeout=drain_timeout):
            raise RuntimeError(
                "I/O executor failed to drain before close "
                f"(last_error={self.io.stats['last_error']!r})")
        if self._owns_io:
            self.io.shutdown()

    # -------------------------------------------------- engine checkpointing
    def restore_state(self, snap: Dict[str, Any]) -> None:
        """Restore from ``checkpoint_state()`` output: watermark, lateness
        histogram, and window bucket contents.

        Blocks are rebuilt 1:1 — same fill boundaries, block ids and
        ``persisted`` flags as at checkpoint time — rather than
        re-appended (which would re-pack events into different blocks and
        lose the on-time/late provenance). Inline-data blocks restore
        into the host tier; manifest blocks (``stored: True`` — written
        by ``checkpoint_state(include_stored_data=False)``) restore into
        the STORAGE tier, re-linked to their records in the engine's
        (reopened) store, and load lazily on demand. After the rebuild
        the store is reconciled: records not referenced by any restored
        block are orphans (post-checkpoint spills of a crashed run, or
        purges whose tombstones never committed) and get tombstoned so
        compaction can reclaim them."""
        from repro_torch.core.buckets import _BLOCK_IDS
        store = self.io.store
        self.tracker.watermark = snap["watermark"]
        self.cleanup.hist.counts = np.asarray(snap["hist_counts"],
                                              np.float32)
        self.cleanup.hist.total = snap["hist_total"]
        self.windows.clear()
        max_bid = 0
        live_keys = []
        for w in snap["windows"]:
            wid = WindowId(w["start"], w["end"])
            st = self._state_for(wid)
            st.expired = w["expired"]
            for b in w["blocks"]:
                data = b.get("data")
                fill = int(b["fill"])
                stored = bool(b.get("stored", False))
                if fill == 0 or (not data and not stored):
                    continue
                blk = Block.new(st.block_capacity, st.width)
                blk.window_key = (wid.start, wid.end)
                if "block_id" in b:
                    blk.block_id = int(b["block_id"])
                    max_bid = max(max_bid, blk.block_id)
                blk.fill = fill
                blk.persisted = bool(b.get(
                    "persisted", b.get("tier") != Tier.DEVICE.value))
                if stored and not data:
                    held = None if store is None else store.current_fill(
                        blk.window_key, blk.block_id)
                    if held is None or held < fill:
                        raise KeyError(
                            f"checkpoint references store record "
                            f"{blk.window_key}/{blk.block_id} (fill "
                            f"{fill}) that the store does not hold")
                    if held > fill:
                        # the block grew after the checkpoint (a partial
                        # block back on the host takes appends) and its
                        # record was rewritten at the longer fill: blocks
                        # are append-only, so the record's first ``fill``
                        # events are the checkpoint's. They restore
                        # inline, and the reconcile below drops the
                        # longer record (ROADMAP Queue 3, item 20)
                        data = store.get(blk.window_key, blk.block_id)
                if stored and not data:
                    # manifest block: the record IS the data — verify it
                    # survived (WAL recovery guarantees acknowledged
                    # commits did) and restore cold
                    blk.store = store
                    blk.storage_ref = store.locate(blk.window_key,
                                                   blk.block_id)
                    blk.host_data = None
                    blk.tier = Tier.STORAGE
                    live_keys.append((blk.window_key, blk.block_id))
                else:
                    blk.host_data["keys"][:fill] = \
                        np.asarray(data["keys"], np.int32)[:fill]
                    blk.host_data["timestamps"][:fill] = \
                        np.asarray(data["timestamps"], np.float64)[:fill]
                    blk.host_data["values"][:fill] = \
                        np.asarray(data["values"], np.float32)[:fill]
                st.blocks.append(blk)
            st.total_events = w["total_events"]
            st.late_events = w["late_events"]
        # new blocks must never collide with restored ids (the store
        # keys records by them)
        _BLOCK_IDS.bump_to(max_bid)
        if store is not None:
            store.reconcile(live_keys)

    @staticmethod
    def _block_ckpt_data(b: Block) -> Dict[str, Any]:
        """Serializable event arrays for one block, whatever its tier
        (spilled blocks are read back through the store without mutating
        the block's residency).

        Read order is race-critical vs the concurrent destage thread:
        grab the device dict reference FIRST (destage clears the
        reference, not the dict), then prefer the host copy — destage
        writes host_data before dropping device_data, so at least one of
        the two snapshots is always complete."""
        dd = b.device_data
        hd = b.host_data
        if hd is not None:
            return {k: np.asarray(v).tolist() for k, v in hd.items()}
        if dd is not None:
            return {k: to_numpy(v).tolist() for k, v in dd.items()}
        if b.in_storage:
            # checked BEFORE the pool: a persistent copy carries the
            # real timestamps, which the arena does not
            if b.store is not None and b.storage_ref is not None:
                d = b.store.get(b.window_key, b.block_id)
                if d is not None:
                    return {k: np.asarray(v).tolist()
                            for k, v in d.items()}
            if b.storage_path is not None and b.storage_path.exists():
                with np.load(b.storage_path) as z:
                    return {k: z[k].tolist()
                            for k in ("keys", "timestamps", "values")}
        if b.pool is not None and b.pool_slot is not None:
            # pooled blocks normally keep their host copy; this covers a
            # defensively-rebuilt one (timestamps restore as zeros)
            d = b.pool.read_host(b)
            if d is not None:
                return {k: np.asarray(v).tolist() for k, v in d.items()}
        return {}

    def _block_ckpt_entry(self, b: Block,
                          include_stored_data: bool) -> Dict[str, Any]:
        entry = {"fill": b.fill, "tier": b.tier.value,
                 "persisted": b.persisted, "block_id": b.block_id}
        store = self.io.store
        # manifest references require a crash-durable backend: the npz
        # fallback loses fill/window metadata across a reopen (its
        # on-disk layout is the bare arrays), so its checkpoints always
        # inline the data
        if not include_stored_data and store is not None \
                and store.durable_writes \
                and b.in_storage and b.store is store \
                and store.current_fill(b.window_key,
                                       b.block_id) == b.fill:
            # the store's record IS this block's exact content (fill
            # identifies it — blocks are append-only): a manifest
            # reference replaces the inline copy, and restore reads it
            # back from the recovered log
            entry["stored"] = True
            entry["data"] = {}
        else:
            entry["data"] = self._block_ckpt_data(b)
        return entry

    def checkpoint_state(self, include_stored_data: bool = True,
                         drain_timeout: float = 30.0) -> Dict[str, Any]:
        """Serializable engine state for fault tolerance (bucket manifests,
        watermark, lateness histogram, re-execution plans).

        ``include_stored_data=False`` writes *manifest* checkpoints:
        blocks whose exact content is already durable in the persistent
        store serialize as ``(window, block_id, fill)`` references
        instead of inline arrays — the checkpoint shrinks to metadata
        for everything the value log already holds, and restore +
        WAL recovery reassemble the state (``tests/
        test_storage_recovery.py`` drives the crash matrix). The final
        group commit below makes that sound: the store index reflects
        ``put`` (pre-ack), so a referenced record might otherwise still
        be sitting in an unacknowledged tail a crash would truncate —
        committing before the checkpoint is handed out guarantees every
        reference is durable."""
        # deferred ingest must be IN the checkpoint (it was acknowledged
        # to the caller as deferred, not dropped)
        self.flush_deferred()
        if self.pipeline is not None:
            from repro_torch.core.pipeline import PipelineError
            # a checkpoint must capture post-fold state: wait out (and
            # surface failures of) every submitted round first
            if not self.pipeline.drain(timeout=drain_timeout * 4,
                                       raise_on_error=True):
                raise PipelineError(
                    "fold pipeline failed to drain before checkpoint")
        if not include_stored_data:
            # manifest checkpoints reference store records by (id, fill)
            # — an in-flight spill/late-write racing the snapshot could
            # commit a record AFTER the manifest captured a different
            # fill. drain() returning False used to be silently ignored
            # here (it returned None); now a failed drain aborts the
            # checkpoint instead of handing out racy references.
            if not self.io.drain(timeout=drain_timeout):
                raise RuntimeError(
                    "I/O executor failed to drain before manifest "
                    "checkpoint (last_error="
                    f"{self.io.stats['last_error']!r})")
        snap = {
            "watermark": self.tracker.watermark,
            "hist_counts": np.asarray(self.cleanup.hist.counts).tolist(),
            "hist_total": self.cleanup.hist.total,
            "windows": [
                {
                    "start": wid.start, "end": wid.end,
                    "total_events": st.total_events,
                    "late_events": st.late_events,
                    "expired": st.expired,
                    "blocks": [
                        self._block_ckpt_entry(b, include_stored_data)
                        for b in st.blocks
                    ],
                }
                for wid, st in self.windows.items()
            ],
        }
        if not include_stored_data and self.io.store is not None:
            self.io.store.commit()
        return snap
