"""Engine configuration for the port: ``AionConfig``, the knobs of the
paper's technique (section 3), as a frozen dataclass, and ``to_json``.

The LM-side schema of the JAX package (model, shape and mesh configs)
belongs to a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class AionConfig:
    """Engine-level knobs for the paper's technique (§3)."""
    # block granularity of buckets (events per block; KV tokens per block)
    block_size: int = 512
    # m-bucket capacity in blocks per window / per session
    m_bucket_blocks: int = 64
    # standard-policy bootstrap fraction kept resident after destage
    rho_min: float = 0.05
    # predictive cleanup: cover this fraction of late events ...
    cleanup_coverage: float = 0.99
    # ... at this confidence (one-sided DKW band on the empirical CDF)
    cleanup_confidence: float = 0.95
    # staleness trigger
    max_staleness: float = 0.05
    trigger_max_iters: int = 512
    trigger_tol: float = 1e-4
    # global policy memory-pressure thresholds (fractions of HBM budget)
    pressure_moderate: float = 0.75
    pressure_severe: float = 0.90
    # watermark period (processing-time seconds) for periodic watermarks
    watermark_period: float = 1.0
    # batched multi-window execution (core/batch_exec.py): fold every due
    # window of one priority class in a single device pass when the
    # operator implements the batch contract; the per-window path remains
    # the reference and the fallback
    batched_execution: bool = True
    # slot-sharded multi-device batched fold: partition window slots of a
    # batch across a 1-D mesh of local devices (shard_map over the
    # composite (window_slot, key) segment axis, psum-free — slots are
    # disjoint). The executor round-robins due windows onto device-local
    # slot ranges and pads each shard to a common power-of-two row count.
    # Safe no-op on single-device hosts (falls back to the unsharded
    # batched path); requires batched_execution and a batch-contract
    # operator to take effect.
    slot_sharding: bool = False
    # how many local devices the slot mesh spans; 0 = every local device
    # (clamped to the number actually present)
    slot_shard_devices: int = 0
    # mesh axis name for the slot shard (only needs changing if an outer
    # mesh already uses 'slots')
    slot_shard_axis: str = "slots"
    # device-side row stacking for the batched gather: m-bucket rows that
    # are already device-resident are stacked with a device concat
    # (torch.stack) instead of being pulled back to the host — the sharded
    # path never round-trips hot blocks through host memory. Cold
    # p-blocks still arrive via IOScheduler.fetch_block_host (accounted,
    # simulated-cost-charged). False stacks on the host with
    # np.stack and copies once to the device. Only reached when
    # ``block_pool`` is off (or as the pool's per-row fallback).
    device_stacking: bool = True
    # persistent device block pool (core/block_pool.py): staging writes
    # blocks INTO a preallocated [pool_slots, block_capacity(, W)] device
    # arena (an in-place ``index_copy_`` at a pool slot) instead of a
    # per-block device copy, and the batched fold consumes a BLOCK TABLE
    # of pool-slot indices — the block-table CUDA kernel reads each row
    # out of the arena, with zero per-batch copies for already-resident
    # blocks. Safe fallback: pool exhaustion degrades a block to the
    # legacy per-block copy / stack path.
    block_pool: bool = True
    # arena capacity in blocks; rounded up to a multiple of the slot-shard
    # count, and clamped so the arena never exceeds the device budget
    pool_slots: int = 256
    # split-K chunked fold over the block table (flash-decoding part 2):
    # > 0 partitions a round's pooled rows into fixed-shape chunks of
    # this many rows, folds each chunk into its own partial accumulator,
    # and merges partials through the operator's merge identity. Launch
    # shapes then depend only on the chunk repertoire ({1,2,4,8} chunks
    # per launch), never the raw batch size — zero recompiles as batches
    # vary, and a Zipf-hot window's rows fold across chunk programs
    # instead of serializing one segment stripe. Under slot sharding the
    # executor instead deals rows round-robin across the mesh (balanced
    # split-K) when the operator supports it. 0 disables (one stripe per
    # window, pow2-bucketed shapes); auto-disabled for rounds smaller
    # than one chunk per device.
    splitk_chunk_rows: int = 0
    # overlap demand pool-fills of cold p-blocks with the fold of the
    # already-resident shard: the executor issues PRIO_DEMAND_STAGE fills,
    # folds the resident block table while the I/O thread stages, then
    # folds the newly-filled slots and merges the accumulators. False
    # reads cold p-blocks host-side instead.
    pool_overlap_prefetch: bool = True
    # persistent tier of the p-bucket (repro.storage): 'log' is the
    # log-structured store — segmented append-only value log, per-record
    # checksums, WAL group commit (a crash loses nothing acknowledged),
    # index rebuilt from segment footers on open, batched/readahead
    # reads, and cleanup-driven compaction that consumes purge
    # tombstones. 'npz' is the legacy file-per-block fallback (eager
    # unlink on purge, no batching) kept for ablations.
    store_backend: str = "log"
    # value-log segment size; sealed segments carry an index footer and
    # become compaction victims
    store_segment_bytes: int = 1 << 20
    # compaction bound: background compaction keeps on-disk bytes <=
    # max(ratio x live record bytes, one segment) — the paper's §3.4
    # "storage consumption stays bounded" claim, enforced
    store_compact_ratio: float = 2.0
    # store read-cache budget for batched readahead sweeps
    store_readahead_bytes: int = 16 << 20
    # pipelined asynchronous execution (core/pipeline.py): watermark
    # advances and due re-executions SUBMIT fold rounds to a dedicated
    # worker instead of folding inline, so ingestion/staging overlap the
    # previous round's fold and emission is futures-based
    # (StreamEngine.result_futures resolve when the round's device work
    # completes). Requires batched_execution + a batch-contract operator;
    # otherwise the synchronous loop is kept.
    pipelined_execution: bool = False
    # pipelined staging lookahead: submitting a round while another is
    # in flight immediately queues PRIO_STAGE pool fills for the new
    # round's cold blocks, so its I/O runs while the current round folds
    # (staging stays continuously in flight instead of fenced per round)
    pipeline_prefetch: bool = True
    # per-pool-slot epoch/sequence scheme: under the pipelined executor,
    # arena pins shrink to the snapshot->dispatch window and rows are
    # validated by (slot, epoch) instead of holding the pin across the
    # whole round — ingest-time
    # fills that land mid-round donate in place (O(block)) rather than
    # taking the functional copy path. Rows whose slot epoch moved
    # between classification and dispatch demote to the stacked fallback.
    pool_slot_epochs: bool = True
    # bound on the engine's per-poll metrics series (batch occupancy,
    # device/host byte samples): each series keeps at most this many
    # recent entries (oldest half is shed when the cap is hit, so appends
    # stay amortized O(1)). 0 disables the bound.
    metrics_series_max: int = 4096
    # ---- learned prefetch subsystem (prefetch/) -----------------------
    # 'fixed' keeps the paper's fixed-margin proactive caching (whole
    # windows, one EWMA Δt lead) — the differential-testing baseline;
    # 'learned' swaps in the lateness-model-driven, segment-granular
    # readahead planner (per-key-class empirical-CDF re-execution
    # probabilities, per-segment sequential sweeps priced against a
    # bandwidth/slack cost model, coalescing rewrites of scattered hot
    # windows)
    prefetch_backend: str = "fixed"
    # readahead planning horizon in event-time seconds (how far past the
    # staging margin the planner looks for prefetch-worthy windows);
    # 0 = auto (4x the pre-stage margin)
    prefetch_horizon: float = 0.0
    # prior store bandwidth for the sweep cost model until measured
    # sweeps take over (EWMA)
    prefetch_bandwidth_bytes_per_s: float = 64e6
    # per-drive cap on issued sweep bytes; 0 = the store read-cache
    # budget (issuing more than the cache holds evicts our own work)
    prefetch_budget_bytes: int = 0
    # windows whose predicted re-execution probability falls below this
    # are not swept (their keys went quiet; re-evaluated every drive)
    prefetch_min_probability: float = 0.05
    # number of key classes the lateness model fits separate CDFs for
    prefetch_key_classes: int = 8
    # coalescing rewrites: scattered windows predicted to re-execute
    # (probability >= the threshold) are rewritten into one contiguous
    # run, once, so the re-stage becomes a single dense sweep
    prefetch_coalesce: bool = True
    prefetch_coalesce_probability: float = 0.25
    # WAL commit coalescing: spill batches and late-write tasks share
    # one group commit (fsync) via a deferred flush task instead of
    # each paying their own
    wal_coalesce_commits: bool = True
    # ---- self-healing I/O path ---------------------------------------
    # transient store failures (OSError/timeouts — see
    # storage.is_transient_error) retry up to this many times with
    # exponential backoff + jitter before surfacing; permanent failures
    # surface immediately. 0 disables retries.
    io_retry_limit: int = 4
    # base backoff delay in seconds; attempt k sleeps
    # io_retry_backoff * 2^k * jitter, jitter uniform in [0.5, 1.5)
    io_retry_backoff: float = 0.01
    # circuit breaker on store health: when one engine poll tick sees at
    # least this many new I/O errors + retries, the degradation ladder
    # escalates one rung (shed readahead -> shed pipelined prefetch ->
    # demote pipelined rounds to sync -> ingest backpressure); after
    # breaker_cooldown_ticks consecutive clean ticks it steps back down.
    # 0 disables the ladder entirely.
    breaker_error_threshold: int = 8
    breaker_cooldown_ticks: int = 2
    # ladder rung 4: ingest() defers incoming batches to a bounded queue
    # (reporting the deferred count) instead of admitting them while the
    # breaker is fully open; deferred batches re-admit on later polls
    # and are always flushed by checkpoint/close — no event is dropped
    ingest_backpressure: bool = True
    # failed pipelined fold rounds retry once through
    # distributed.fault.BackupExecutor (folds are pure functions of
    # bucket contents, so the retry is idempotent) before the failure
    # poisons the pipeline
    fold_round_retry: bool = True
    # ---- observability layer -----------------------------------------
    # fraction of root spans (ingest / watermark_advance / poll) that
    # are traced; children (fold rounds, I/O tasks) inherit the parent's
    # decision. 0.0 keeps tracing entirely off the hot path (every span
    # is the shared no-op NULL_SPAN); 1.0 traces everything and must
    # stay under 5% fold-throughput overhead (see `make bench-obs`)
    trace_sample_rate: float = 0.0
    # finished spans are kept in a bounded ring buffer of this many
    # records; oldest are dropped (counted in tracer stats)
    trace_ring_max: int = 4096
    # default format for engine.observability(export=...): "json" or
    # "prometheus"
    metrics_export: str = "json"
    # wrap fold launches in torch.profiler.record_function so device
    # traces line up with engine spans
    profiler_annotations: bool = False
    # cap on StoreHealth.transitions / EngineMetrics.ladder_transitions
    # (BoundedSeries; sheds oldest half at the cap)
    health_transitions_max: int = 4096


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
