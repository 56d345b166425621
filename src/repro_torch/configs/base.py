"""Configuration schema for the port, copied from the JAX package's
``configs/base.py`` (plain frozen dataclasses, nothing of JAX in them):
the LM side (``ModelConfig``, ``MoEConfig``, ``SSMConfig``,
``ShapeConfig``, ``MeshConfig``, the family tags, the shape cells and the
meshes) and the engine side (``AionConfig``, the knobs of the paper's
technique, section 3), with ``to_json``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


# ---------------------------------------------------------------------------
# Model family tags (drive which blocks the assembly uses)
# ---------------------------------------------------------------------------
FAMILY_DENSE = "dense"      # decoder-only dense transformer (GQA)
FAMILY_MOE = "moe"          # decoder-only with MoE FFN
FAMILY_SSM = "ssm"          # attention-free state-space (mamba2 / SSD)
FAMILY_HYBRID = "hybrid"    # parallel attention + SSM heads (hymba)
FAMILY_ENCDEC = "encdec"    # encoder-decoder (seamless)
FAMILY_VLM = "vlm"          # vision frontend (stub) + dense decoder backbone
FAMILY_AUDIO = "audio"      # audio frontend (stub) + enc-dec backbone

ALL_FAMILIES = (
    FAMILY_DENSE, FAMILY_MOE, FAMILY_SSM, FAMILY_HYBRID,
    FAMILY_ENCDEC, FAMILY_VLM, FAMILY_AUDIO,
)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN parameters."""
    num_experts: int = 0
    top_k: int = 0
    # capacity factor for dense-dispatch (tokens routed per expert =
    # capacity_factor * tokens * top_k / num_experts, rounded up to 128)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD parameters (state-space duality, arXiv:2405.21060)."""
    state_size: int = 0          # N: SSM state dimension (per group)
    head_dim: int = 64           # P: SSD head dim
    expand: int = 2              # d_inner = expand * d_model
    chunk_size: int = 256        # SSD chunk length (Q in the paper)
    conv_width: int = 4          # short causal conv width
    n_groups: int = 1            # B/C groups shared across heads (MVA analog)

    @property
    def enabled(self) -> bool:
        return self.state_size > 0


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture. Dims follow the assignment table verbatim."""
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int            # GQA kv heads (0 for attention-free)
    d_ff: int                    # FFN hidden (per-expert hidden for MoE)
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # enc-dec: encoder layer count (decoder uses num_layers)
    encoder_layers: int = 0
    # frontends (vlm/audio): number of stub embedding positions prepended
    frontend_tokens: int = 0
    # hymba: sliding-window size for the attention heads (sub-quadratic)
    attn_window: int = 0         # 0 -> full causal attention
    mlp_variant: str = "swiglu"  # 'swiglu' (3 mats) | 'gelu' (2 mats)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    use_bias: bool = False
    # dtype policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat policy for scan-over-layers: 'none' | 'full' | 'dots'
    remat: str = "full"
    source: str = ""             # provenance tag from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def is_subquadratic(self) -> bool:
        """True if a 500k-token decode step is feasible (SSM state or
        sliding-window attention keeps per-step state o(seq))."""
        if self.family == FAMILY_SSM:
            return True
        if self.family == FAMILY_HYBRID and self.attn_window > 0:
            return True
        return False

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        total = V * d                                    # embedding
        if not self.tie_embeddings:
            total += V * d                               # unembedding
        per_layer = 0
        if self.has_attention:
            q = d * (self.num_heads * hd)
            kv = 2 * d * (self.num_kv_heads * hd)
            o = (self.num_heads * hd) * d
            per_layer += q + kv + o
        if self.ssm.enabled:
            d_inner = self.ssm.expand * self.d_model
            nheads = max(d_inner // self.ssm.head_dim, 1)
            g = self.ssm.n_groups
            # in_proj: z, x, B, C (per group), dt (per head)
            per_layer += d * (2 * d_inner + 2 * self.ssm.state_size * g + nheads)
            per_layer += d_inner * d                     # out_proj
            per_layer += self.ssm.conv_width * (d_inner + 2 * self.ssm.state_size * g)
            per_layer += 2 * nheads                      # A_log, D
        n_mlp_mats = 3 if self.mlp_variant == "swiglu" else 2
        if self.moe.enabled:
            per_layer += d * self.moe.num_experts        # router
            per_layer += self.moe.num_experts * n_mlp_mats * d * self.d_ff
        elif self.d_ff > 0:
            per_layer += n_mlp_mats * d * self.d_ff      # SwiGLU: gate, up, down
        per_layer += 2 * d                               # 2 RMSNorm scales
        total += L * per_layer
        if self.encoder_layers:
            # encoder: self-attn + FFN, decoder adds cross-attn
            enc_layer = 0
            if self.has_attention:
                q = d * (self.num_heads * hd)
                kv = 2 * d * (self.num_kv_heads * hd)
                o = (self.num_heads * hd) * d
                enc_layer += q + kv + o
            enc_layer += 3 * d * self.d_ff + 2 * d
            total += self.encoder_layers * enc_layer
            # decoder cross-attention (added per decoder layer)
            if self.has_attention:
                total += L * (d * (self.num_heads * hd)
                              + 2 * d * (self.num_kv_heads * hd)
                              + (self.num_heads * hd) * d + d)
        total += d                                       # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts FFNs)."""
        if not self.moe.enabled:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        n_mlp_mats = 3 if self.mlp_variant == "swiglu" else 2
        inactive_ffn = (self.moe.num_experts - self.moe.top_k) * n_mlp_mats * d * self.d_ff
        return self.param_count() - L * inactive_ffn


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell. ``kind`` selects which step gets lowered."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. ``shape`` and ``axes`` zip together."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


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
