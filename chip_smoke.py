#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--windows 6] [--splitk-windows 2]
                          [--lrb-windows 3] [--pipeline-windows 6]
                          [--failure-windows 2] [--tenant-seconds 60]
                          [--chaos-windows 3] [--recovery-windows 3]
                          [--out FILE]

Phases (the first failed check exits non-zero, with no result line):

0. The card's name and power limit, then the nvcc builds of the kernels
   (``src/repro_torch/kernels/csrc/{segment_aggregate,segment_splitk,
   attention,decode_hopper,flash_attention_bwd,flash_fwd_hopper,
   flash_bwd_hopper,ssd_scan,ssd_hopper}.cu`` for sm_90a, one nvcc per source,
   started together), with each kernel's registers and spills as ptxas
   reports them.
1. Aion's late-event loop: ``StreamEngine`` with the stock operator at the
   Table-1 deployment (10,000 events/s into 30 s tumbling windows,
   1,664-byte payloads, 128 keys, lognormal lateness from
   ``WorkloadGenerator``) with a 3,072-slot device block pool (2.6 GB of
   window state on the card) and a small host budget that spills to the
   log store. The stream runs ``--windows`` windows of processing time,
   then closes out (watermark past the end, polls, one batched sweep of
   every window) and every window's result is held against a numpy
   oracle over all events. Every K2 launch whose block partial fits
   shared memory must take its smem design (``launches_by_design``).
2. The same deployment with ``splitk_chunk_rows=64`` and a 1,024-slot
   pool below the live state, over ``--splitk-windows`` windows: the
   split-K fold and the stacked fallback under pool pressure. Three
   quarters of the way, a manifest ``checkpoint_state`` is restored into
   a new engine over the same log store (``restore_state``), which
   finishes the stream. Every K3 launch must take its shared-memory
   design (``launches_by_design``).
3. Kernel checks on the loop's own launches. While phases 1, 2 and 12
   run, a recorder around the fold entry points of ``repro_torch.kernels``
   keeps the inputs of each kernel's largest call (most rows): the value
   columns the fold reads, the ids, valid flags, table and window slots.
   Each kernel (K1 stacked: Linear Road's fold of phase 12, its row of
   the table, and the stock fallback of phases 1-2; K2 block table, K3
   split-K) is replayed on those inputs and held against its plain
   PyTorch version on the card: the unread value columns are random, and
   pool slot 0, which only padding rows name, holds NaN (they must stay
   inert). Each is timed with CUDA events beside its plain version, one
   PyTorch ``index_add_`` of the same sums (a yardstick only) and its
   bound. Each runs on both of its designs (K3 also on rows that its
   wrapper must pad and as raw partials), with the earlier design's time
   (``earlier_ms``, the global-atomic kernel the rule keeps for partials
   past shared memory) and the time of the launch alone (the C call on
   prepared arguments, ``launch_ms``) beside the wrapper's; K3 with one
   live row's valid flags cleared, a control that ``compare`` must
   reject; and a NaN case for min/max in K1, on both designs. In phases
   1, 2 and 12 every K1, K2 and K3 launch whose block partial fits shared
   memory must take its smem design (``launches_by_design``).
4. LM serving at starcoder2-7b's attention width (32 layers, 36 heads, 4
   KV heads of 128, bf16, from ``repro_torch.configs``): a
   ``TieredKVCache`` of 14,336 pages of 16 tokens (15.0 GB of KV on the
   card) under ``ContinuousBatcher(max_batch=16, pages_per_seq=520)``. 48
   requests with prompts of 2,048-8,192 tokens: each prompt's layer-0
   q/k/v go through ``ops.flash_attention`` (K5), its 32-layer K/V are
   submitted, then every request decodes 32 tokens through
   ``ContinuousBatcher.step`` (K4), the clock advancing by 0.05 per
   step. The pool holds fewer pages than the live sessions, so pages go
   to the host and back. Every 8th K4 launch is held against the plain
   version at launch time, and two or more sessions whose pages came
   back are held against attention over their K/V kept aside untiered;
   that check must reject the same attention with a restaged page
   holding another page's K/V (a planted control). Every K4 launch must
   take its split-KV design (``launches_by_design``).
5. Kernel replays: K4 on its largest launch of phase 4 (and, as a
   control that must be rejected, with one page of one row dropped),
   timed beside its earlier CUDA-core design (``earlier_ms``) and its
   split-KV design with one split per sequence (``one_split_ms``: the
   grid of the earlier design, 64 blocks) and with runs of 8, 16 and 64
   pages, each also held within one bf16 ulp; K5
   on the longest prefill and on a sliding-window case at hymba-1.5b's
   width (25 heads, 5 KV heads of 64, window 1,024, 4,096 tokens), each
   held against the fp32 plain version on the same bf16 inputs (K5, on
   its wgmma design, within the limits of ``kernels/flash_limits.py``;
   with its last key tile of 128 dropped, as a control, it must read at
   least CONTROL_FACTOR times its limit) and timed beside its plain
   version, K5's earlier CUDA-core design on the same inputs
   (``earlier_ms``), one ``scaled_dot_product_attention`` call (a
   yardstick only; for K4 on K/V gathered into contiguous padded
   tensors, the gather untimed) and its bound. K5 also runs the same
   replays in float32 (its CUDA-core design) against the plain version
   within the float32 tolerances.

6. LM training at starcoder2-7b's full width (``configs/starcoder2_7b.py``:
   d_model 4,608, 36 heads, 4 KV heads of 128, d_ff 18,432 GELU, biases,
   vocab 49,152; fp32 parameters, bf16 compute, ``remat="full"``) with 8 of
   its 32 layers: 2.19 B parameters from a seeded generator. 6a: one loss
   and backward on 1 x 1,024 tokens through K5/K6 and again through their
   plain versions, the loss within LOSS_TOL and every parameter's gradient
   within GRAD_RTOL of its norm; the same with K6's dq of the last layer's
   first query tile zeroed must be rejected (a planted control). 6b: six
   steps of ``make_train_step`` (AdamW) on ``token_batches`` of 2 x 4,096
   tokens through ``PrefetchPipeline``: every loss finite, K5 launched
   2 x 8 times a step (forward and remat recompute) and K6 8 times; K6's
   first launch is kept for phase 8.
7. The port's entry point, ``launch.train``, at its default config
   (``reduced(starcoder2-7b)``, as the JAX command line always trains) to 4
   steps with checkpoints, then asked for 8: it must resume from LATEST
   with the saved parameters bit for bit, and ``RestartManager`` may
   restart nothing (it restarts on any exception, which would hide a
   kernel fault).
8. K6 replays: its training launch of phase 6 and a sliding-window case at
   hymba-1.5b's width (25 heads, 5 KV heads of 64, window 1,024, 4,096
   tokens), dq, dk and dv each held against the fp32 plain version on the
   same bf16 inputs within the limits of ``kernels/flash_limits.py``
   (``flash_close``), K6 with the last key tile of 64 dropped read at
   least CONTROL_FACTOR times its limit (a control), each timed beside
   its plain version, its earlier CUDA-core design (``earlier_ms``), the
   backward of one ``scaled_dot_product_attention`` (a yardstick only),
   K5 on the same q/k/v and the bound; and the same replays in float32
   (the CUDA-core design) within the float32 tolerance.

9. SSM serving at mamba2-780m's full width and depth
   (``configs/mamba2_780m.py``: 48 layers, d_model 1,536, 48 SSD heads of
   64, state 128, vocab 50,280, tied embeddings; fp32 parameters from a
   seeded generator, bf16 compute), all on the card. 9a:
   ``make_prefill_step`` on 4 x 32,768 tokens (the prefill_32k cell's
   prompt, its batch of 32 cut to 4), K7 once per layer (every launch on
   its tensor design), then 32 steps
   of ``make_decode_step``; then one prefill of 1 x 32,768 under
   ``torch.profiler`` (device time by kernel, the device's busy share).
   9b, in bf16 and again in float32 compute: prefill of 2 x 4,096 then
   one ``decode_step`` against the last logits of the prefill of the
   4,097 tokens; ``prefill_streaming`` of 1 x 16,384 in chunks of 4,096
   (K7 carrying the state through ``init_state``) against the whole
   prefill (logits, every layer's SSM state and conv tail); in float32,
   1 x 4,096 in chunks of 256 against the whole, and the same with
   ``init_state`` dropped on its last chunk (a control that must be
   rejected; over a chunk of 4,096 the random model forgets a dropped
   state). 9c: ``prefill_streaming`` of
   1 x 131,072 tokens (long_500k's prompt cut to a quarter) in chunks of
   4,096, then 16 decode steps.
10. Hybrid serving at hymba-1.5b's full width and depth (32 layers,
   d_model 1,600, 25 heads with 5 KV heads of 64, window 1,024, 50 SSD
   heads of 64, state 16, d_ff 5,504): prefill of 4 x 4,096 tokens (K5
   with the window, K7) and 32 decode steps through ``attn_decode``'s
   ring, with the 16-bit cache, then with ``kv_cache_bits=8``, in float32
   compute, and in float32 compute with ``kv_cache_bits=8``, all fed the
   16-bit run's tokens: each int8 run's logits within the JAX int8
   test's rule of its compute type's 16-bit run, and in float32 compute
   (where only the quantization differs) its argmaxes agreeing on 99% and
   every int8 K/V vector within half a quantization step of the float32
   one (all layers after the prefill, layer 0 after decoding), with a
   zeroed slot scale and decode writes one slot off as controls that
   must be rejected; then prefill of 2 x 4,096 and one decode against
   the prefill of 4,097 (4,096 is a multiple of the window: ROADMAP
   Queue 3).
11. K7 replays on its tensor design: its launch of 9a, one of 9c with a
   carried state, and hymba's of phase 10, each with y within one bf16
   ulp of the plain version (tiled as the design tiles) on the same bf16
   inputs and the final state within K7_STATE_RTOL, a control without the
   carried state rejected; the same at each chunk the design is built for
   (64, 128), each timed; its earlier CUDA-core design on the same
   inputs, held the same way against the plain version tiled by its own
   chunk and timed (``earlier_ms``); the plain version and the bound (no
   single PyTorch call computes the scan: no library time). Hymba's
   launch cast to float32, the type the float32-compute runs of phases
   9b and 10 give K7, goes through the CUDA-core design, held against
   the plain version within K7_FP32_RTOL. In phase 10 every bf16 K7
   launch takes the tensor design and every float32 one the CUDA-core
   design.
12. Linear Road, the paper's fourth Table-1 deployment (10,000 events/s
   into 60 s tumbling windows, 1,536-byte payloads, 256 road segments,
   lognormal lateness; ``configs/workloads.py: LRB``), through
   ``StreamEngine`` with the lrb operator and a 4,096-slot block pool
   (3.2 GB of window state on the card), over ``--lrb-windows`` windows
   of processing time (1.8 M events), as phase 1 runs and closes out
   stock. Every window against a numpy oracle over all events: count,
   accident (2 or more stopped vehicles) and toll exact, avg_speed within
   the mean's tolerance. The operator gathers each table row's full
   payload, derives [speed, stopped] and folds every execution through
   K1; the close-out's re-execution of every window runs under
   ``torch.profiler``: device time of K1, of the row gathers and of the
   rest, and the device's busy share. It runs after phase 2, so that
   phase 3 replays its largest K1 launch.
13. Phase 1's deployment, seed and pool, pipelined with learned
   prefetch (``AionConfig(pipelined_execution=True,
   prefetch_backend="learned")``) over ``--pipeline-windows`` windows
   (default phase 1's): every fold round, the close-out's sweep too, on
   the engine's pipeline worker thread. Every window against the oracle
   as in phase 1; every K1-K3 launch must have gone out from the worker
   thread on the arena's stream (the recorder keeps each launch's thread
   and stream), no round may have failed, and every K2 launch that fits
   shared memory must take its smem design. Printed: events/s beside
   phase 1's of the same run (over the loop and the time the rounds it
   submitted took to fold after it, the backlog; the loop alone beside
   it), the pipeline's rounds and retries, epoch-
   demoted, pooled and fallback rows, demand fills and their stall, the
   learned scheduler's and the store's counts (sweeps, bytes swept,
   readahead hits, coalesced windows) and, under ``torch.profiler``, the
   close-out's device busy share.
   13b. Failure controls on ``--failure-windows`` windows of the same
   deployment, each over a log store that fails one demand read once
   (``PermanentStoreError``, which the I/O path does not retry): with
   ``fold_round_retry`` the round must be retried through the engine's
   backup executor and win, and every window still meet the oracle;
   without it the pipeline's ``drain()`` after the stream must raise
   ``PipelineError``.
14. ``MultiTenantEngine.from_profiles`` with four tenants of
   ``configs/workloads.py: TENANT_PROFILES``: qwen3_moe_30b,
   command_r_35b and mistral_large_123b (the Table-1 stock deployment,
   I/O weights 2, 2, 4) share one 4,096-slot arena (3.5 GB), and
   granite_34b (Linear Road, weight 2), whose width is not the arena's,
   takes the unpooled per-block path; pipelined with learned prefetch,
   one 8 GiB device budget, one 2 GiB host budget sliced by the
   profiles, one log store, one transfer executor and one pipeline.
   Each tenant streams at its Table-1 rate (40,000 events/s in all) for
   ``--tenant-seconds`` of processing time (2.4 M events), then closes
   out; every stock window is held to the stock oracle and the Linear
   Road window to its own, every tenant must have had I/O executed
   (``fairness_stats``), and every fold launch must have gone out from
   the shared pipeline's worker thread.
15. Aion's failure path on phase 1's deployment, seed, 3,072-slot pool
   and budgets, each run over ``--chaos-windows`` windows (900,000 events
   at the default 3): the log store behind a ``FaultyBlockStore`` whose
   ``FaultInjector`` (``repro_torch.testing``; seed 77, max_consecutive
   2) fails a quarter of the store's get, put, commit and readahead
   calls, with ``AionConfig(io_retry_backoff=0.0,
   breaker_error_threshold=2)``, the JAX chaos soak's settings
   (``tests/test_soak_differential.py``). 15a runs synchronously, 15b
   pipelined with learned prefetch. Checks, each exact: every window
   against the oracle as in phase 1, every event ingested, no retry given
   up (``gave_up == 0``), at least 100 faults injected and retried, the
   degradation ladder engaged with ``(0, 1)`` first and one rung at a
   time, every deferred event readmitted, the pool's books balanced
   after the close-out (free + held + quarantined slots == pool_slots),
   every K1-K3 launch on the arena's stream, and every K2 launch that
   fits shared memory on its smem design. Printed: events/s beside phase
   1's, injected faults by operation, retries, shed readahead drives,
   the ladder's transitions and highest rung, demoted rounds and the
   launches by thread.
16. Crash and recovery at full size: phase 13's deployment (pipelined,
   learned prefetch, the same pool and budgets) over ``--recovery-windows``
   windows, its store failing 5% of the data path (seed 5), an
   ``EngineRecovery`` manifest checkpoint every 10 s of processing time
   (the injector paused). At the half, as
   ``tests/test_soak_differential.py::test_soak_differential_chaos_restart``:
   drain, destage every device block and spill every host block (paused),
   poison every ``get``: the next watermark, poll and close must raise
   ``PipelineError`` or ``StagingError``; heal, close the pipeline, shut
   the I/O down, and crash the store with 66 bytes torn off its log's
   tail (``FaultyBlockStore.crash``). The dead engine's arena must be
   unreachable and device memory one arena lower; ``EngineRecovery.
   restore()`` reopens the store (the WAL replay) into a fresh engine and
   pool on the card, the batches after the checkpoint are replayed, and
   the stream runs to its end. Checks: one restart, a torn tail
   truncated, no record the checkpoint references lost (``restore_state``
   raises ``KeyError``), no retry given up after the restore, memory after
   the restore within 256 MiB of the reading before the crash, the pool's
   books, every window against the oracle. Printed: the seconds of
   ``restore()`` and of the replay to its first poll, the events replayed,
   the bytes truncated, the device memory at the three readings and the
   restored engine's K1-K3 launches.

K4's and K7's outputs are held within one bf16 ulp of the plain
version's (``attn_close``); K5's and K6's bf16 outputs on their wgmma
design (bf16 at head dims 64 and 128) within the limits that
``tests/test_torch_flash_rounding.py`` anchors on the Pallas kernels'
readings (``flash_close``); the prefill's log-sum-exp within LSE_TOL.
The kernels' launch counters (and K5's and K6's counts by design) are
set to 0 just before each of phases 1, 2, 12, 13, 14, 15a, 15b, 16, 4,
6b, 7, 9a, 9c and 10 and read just after; every bf16 launch of K5 and
K6 in phases 4, 6b and 10 must have gone through the wgmma design. A segment kernel's
``launches`` is its count in the run whose launch it replays (K1 the
Linear Road run, K2 the main run, K3 the split-K run;
``launches_by_run`` gives every run's count); K4's and K5's are their counts in
phase 4, K6's in phase 6b, K7's in phase 9a. The
last line of the output is ``{"ok": true, "device": {...}}``; the line
before it holds the kernels' numbers as one JSON object, and the line
before that the card's name and power limit as ``nvidia-smi`` gives
them.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import importlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor fp32 and
# the bf16 dense tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# sum tolerance: rtol, and atol per unit of max|v| x events in the segment
SUM_RTOL = 1e-5
SUM_ATOL = 1e-5
SEED = 0

JAX_FILE = "src/repro/kernels/segment_aggregate.py"
SOURCE = "src/repro_torch/kernels/csrc/segment_aggregate.cu"
#: K3's shared-memory design; SOURCE keeps its earlier, global-atomic one
SPLITK_SOURCE = "src/repro_torch/kernels/csrc/segment_splitk.cu"
ATTN_SOURCE = "src/repro_torch/kernels/csrc/attention.cu"
#: K4's split-KV design (bf16 at head dims 64 and 128, G <= 16);
#: ATTN_SOURCE keeps its earlier CUDA-core design for the rest
DECODE_SOURCE = "src/repro_torch/kernels/csrc/decode_hopper.cu"
#: K5's and K6's tensor-core (wgmma) design, which every bf16 launch of
#: the main paths takes; ATTN_SOURCE and BWD_SOURCE keep their earlier
#: CUDA-core design, for float32 and bf16 at head dims 32 and 256
FWD_SOURCE = "src/repro_torch/kernels/csrc/flash_fwd_hopper.cu"
BWD_HOPPER_SOURCE = "src/repro_torch/kernels/csrc/flash_bwd_hopper.cu"
# the serving phases' widths come from these configs
SERVE_ARCH = "starcoder2-7b"
WINDOW_ARCH = "hymba-1.5b"
# the prompt lengths of phase 4: under seed 0 the JAX victim policy sends
# pages of one session only to the host and back; under seed 1, of three
# sessions, two of which are launched with such a page resident, which the
# check against untiered attention needs
PROMPT_SEED = 1
# attention outputs (bf16) within one bf16 ulp of the plain version's:
# the kernel and the plain version both compute in fp32 and round once, so
# they differ by one ulp at most (by half of one against an fp32 result).
# Magnitudes below ATTN_ULP_FLOOR count as that floor (one ulp there is
# 2**-17), so the fp32 rounding of an output that cancels to near 0 stays
# inside; a page of wrong or missing K/V moves outputs by about 1e-3.
ATTN_ULP_FLOOR = 2.0 ** -10
# the prefill's log-sum-exp (fp32, about 9 for 8,192 keys), absolute: a
# dropped tile of 64 keys moves it by about 8e-3
LSE_TOL = 1e-3
# the float32 replays of K5 and K6 (their CUDA-core design) against the
# plain version, rtol and atol, as tests/test_torch_attention_gpu.py and
# tests/test_torch_flash_bwd_gpu.py hold them: both compute in fp32 and
# sum in another order (K6's dk and dv over up to G x Sq products)
FP32_ATTN_TOL = 2e-5
FP32_LSE_TOL = 1e-4
FP32_GRAD_TOL = 1e-4
# phase 4's deployment: pages of 16 tokens, 48 prompts of
# 2,048-8,192 tokens, 32 tokens decoded each, the clock advancing by 0.05
# per step, every 8th K4 launch held against the plain version at launch,
# and 2 to 4 restaged sessions against their K/V kept aside untiered
SERVE_RUN = dict(num_device_pages=14_336, max_batch=16, pages_per_seq=520,
                 requests=48, prompt=(2048, 8192))
PAGE_SIZE = 16
MAX_NEW = 32
STEP_DT = 0.05
CHECK_EVERY = 8
UNTIERED = (2, 4)
# its CPU rehearsal (``run_serve(..., small=True)``): narrow heads, few
# layers and short prompts on a pool still below the live pages, so that
# pages go to the host and back and restaged sessions are checked
SMALL_RUN = dict(heads=2, kv_heads=1, head_dim=64, layers=2,
                 num_device_pages=120, max_batch=4,
                 pages_per_seq=28, requests=12,
                 prompt=(100, 400))


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


# ------------------------------------------------------------------ phase 0
def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The last component of an Itanium-mangled function name, with its
    integer template arguments: ``_ZN..22flash_fwd_wgmma_kernelILi128EE..``
    is ``flash_fwd_wgmma_kernel<128>``."""
    import re
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while True:
        m = re.match(r"(\d+)", mangled[i:])
        if not m:
            break
        n = int(m.group(1))
        i += len(m.group(1))
        name, i = mangled[i:i + n], i + n
    args = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ", ".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
    return name


def ptxas_lines(build_log: str):
    """(kernel, its registers and spills) for each entry function of an
    ``nvcc -Xptxas -v`` log, and each error line as it is."""
    import re
    entries = []
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entries.append([kernel_name(m.group(1)), ""])
        elif entries and ("registers" in line or "spill" in line):
            entries[-1][1] += line.split(":", 1)[-1].strip() + "; "
        elif "error" in line:
            yield "error", line.strip()
    for name, info in entries:
        yield name, info.rstrip("; ")


# --------------------------------------------------- the launch recorder
#: each kernel: its name, the line of the TPU kernel it replaces in
#: JAX_FILE, and the fold entry point of ``repro_torch.kernels`` (and the
#: ``*_cuda`` / ``*_plain`` pair of the module) that reaches it
KERNELS = {
    "K1": ("seg_agg_flat_smem (K1, Linear Road's fold and the stock "
           "fallback)", 165, "segment_aggregate_batched"),
    "K2": ("seg_agg_block_table_smem (K2, resident block-table fold)", 339,
           "segment_aggregate_block_table"),
    "K3": ("seg_agg_splitk_smem (K3, split-K block-table fold)", 505,
           "segment_aggregate_block_table_splitk"),
}
ENTRY_POINTS = {k: v[2] for k, v in KERNELS.items()}


class LaunchRecorder:
    """Wraps the fold entry points of ``repro_torch.kernels`` while it is
    entered, and keeps the inputs of each one's largest call (most rows):
    the value columns the fold reads, ids, valid flags, table and window
    slots, as device copies on the caller's stream. The operators import
    the entry points when they are made, so the engine is built inside."""

    def __init__(self):
        self.largest = {}
        self.fits = dict.fromkeys(ENTRY_POINTS, 0)
        # each kernel's launches by the thread that made them, and the
        # CUDA streams (raw handles; None for a CPU tensor) they went to
        self.threads = {k: {} for k in ENTRY_POINTS}
        self.streams = {k: set() for k in ENTRY_POINTS}
        self._saved = {}

    def __enter__(self):
        import inspect
        kernels = importlib.import_module("repro_torch.kernels")
        for key, name in ENTRY_POINTS.items():
            fn = getattr(kernels, name)
            self._saved[name] = fn
            setattr(kernels, name,
                    self._wrap(key, fn, inspect.signature(fn)))
        return self

    def __exit__(self, *exc):
        kernels = importlib.import_module("repro_torch.kernels")
        for name, fn in self._saved.items():
            setattr(kernels, name, fn)
        return False

    def _wrap(self, key, fn, sig):
        def recorded(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            self._keep(key, bound.arguments)
            return fn(*args, **kw)
        return recorded

    def _keep(self, key, a) -> None:
        import threading
        import torch
        vals = a["values"] if key == "K1" else a["values_arena"]
        name = threading.current_thread().name
        self.threads[key][name] = self.threads[key].get(name, 0) + 1
        self.streams[key].add(
            torch.cuda.current_stream(vals.device).cuda_stream
            if vals.is_cuda else None)
        rows = vals.shape[0] if key == "K1" else a["table"].shape[0]
        slots = a["num_slots"] if a["num_slots"] is not None else rows
        if rows and slots and vals.shape[1] and a["num_segments"]:
            # a launch whose block partial fits shared memory, which the
            # folds' design rule sends to their smem design
            sa = importlib.import_module(
                "repro_torch.kernels.segment_aggregate")
            w_out = vals.shape[2] if key == "K1" \
                else a["num_cols"] or vals.shape[2]
            self.fits[key] += sa.splitk_design(
                sa.norm_stats(a["stats"]), slots * a["num_segments"],
                w_out) == "smem"
        if rows <= self.largest.get(key, {}).get("rows", 0):
            return
        rec = {"rows": rows, "num_segments": a["num_segments"],
               "num_slots": a["num_slots"], "stats": tuple(a["stats"])}
        for k in ("segment_ids", "valid", "slot_ids"):
            rec[k] = a[k].clone()
        if key == "K1":
            # [B, cap, w]: the columns the fold reads (the stock fallback's
            # price column out of its width-W rows, LRB's stacked [speed,
            # stopped]) and the stride of an event's row
            rec["values"] = vals.clone()
            rec["row_width"] = vals.stride(1)
        else:
            cols = a["num_cols"] or vals.shape[2]
            table = a["table"]
            rec.update(arena_shape=tuple(vals.shape),
                       num_cols=a["num_cols"], table=table.clone(),
                       values=vals[:, :, :cols].index_select(
                           0, table.long()))
            if key == "K3":
                rec["chunk_rows"] = a["chunk_rows"]
        self.largest[key] = rec


# ------------------------------------------------------------------ phase 3
def _sync_time_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA
    events, after one warm-up call), with Python's garbage collector off
    while they run, as ``timeit`` does: a collection over the serving
    run's objects would otherwise stall the launches of a short kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    was_on = gc.isenabled()
    gc.disable()
    try:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    finally:
        if was_on:
            gc.enable()
    return start.elapsed_time(end) / iters


def compare(out: dict, ref: dict, scale: float) -> float:
    """Hold a kernel's stats against the plain version's: count, min and
    max exactly (NaN where the plain version has NaN), sums within
    SUM_RTOL x |ref| + SUM_ATOL x max|v| x events-in-segment. Returns the
    largest absolute difference over the finite entries."""
    import torch
    check(set(out) == set(ref), f"stats {sorted(out)} != {sorted(ref)}")
    worst = 0.0
    rows = float(ref["count"].max()) if "count" in ref else 1.0
    for k in ref:
        a, b = out[k].float(), ref[k].float()
        check(a.shape == b.shape, f"{k}: shape {tuple(a.shape)} != "
                                  f"{tuple(b.shape)}")
        check(torch.equal(torch.isnan(a), torch.isnan(b)),
              f"{k}: NaN positions differ")
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a)) and torch.equal(
            a[~fin & ~torch.isnan(b)], b[~fin & ~torch.isnan(b)]),
            f"{k}: infinite entries differ")
        diff = (a[fin] - b[fin]).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        worst = max(worst, err)
        if k == "sum":
            tol = SUM_RTOL * b[fin].abs() + SUM_ATOL * scale * max(rows, 1.0)
            check(bool((diff <= tol).all()),
                  f"sum: max error {err} beyond tolerance")
        else:
            check(err == 0.0, f"{k}: max error {err}, must be exact")
    return worst


def _bound(n_events: int, n_valid: int, w_out: int, n_rows: int,
           s_total: int, stats, row_bytes: int) -> tuple:
    """Least time (ms) for the fold on an H100, and what bounds it. Bytes:
    every event's valid flag (1 B), each valid event's id (4 B) and its
    w_out value columns (4 B each), ``row_bytes`` per row (K2 and K3: 8,
    the pool slot and the window slot; K1: 4, the window slot), the
    outputs written once. Operations: one per value stat per column and
    one count per valid event, in fp32."""
    n_val = sum(1 for s in stats if s != "count")
    out_bytes = s_total * 4 * (w_out * n_val + ("count" in stats))
    nbytes = (n_events + n_valid * (4 + 4 * w_out) + row_bytes * n_rows
              + out_bytes)
    ops = n_valid * (w_out * n_val + ("count" in stats))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_sum_ms(vals_col, comp, valid, s_total: int, iters: int):
    """One ``index_add_`` of the valid events' values into their composite
    segments: the sums alone, as PyTorch computes them (a yardstick)."""
    import torch
    ids = torch.where(valid.reshape(-1), comp.reshape(-1).long(), s_total)
    v = vals_col.reshape(ids.shape[0], -1).contiguous()
    acc = torch.zeros(s_total + 1, v.shape[1], device=v.device)

    def call():
        acc.index_add_(0, ids, v)
    return _sync_time_ms(call, iters)


def replay(key: str, rec: dict, g) -> dict:
    """A recorded launch's inputs, rebuilt on the recording's device: the
    wrapper's positional and keyword arguments, its kernel and plain
    functions, and the value columns the fold reads (for the yardstick
    and the tolerance). K2/K3 get an arena of the recorded shape with
    random unread columns, the recorded column written into the rows the
    table names, and NaN in pool slot 0 (a live row that held slot 0
    moves to a slot the table does not name, past the recorded ones
    where the table names every slot)."""
    import torch
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    valid = rec["valid"]
    dev = valid.device
    kw = dict(valid=valid, slot_ids=rec["slot_ids"],
              num_slots=rec["num_slots"], stats=rec["stats"])
    kernel = getattr(sa, KERNELS[key][2] + "_cuda")
    plain = getattr(sa, KERNELS[key][2] + "_plain")

    def prices(shape):
        return torch.rand(shape, generator=g, device=dev) * 490.0 + 10.0

    if key == "K1":
        b, cap, w = rec["values"].shape
        full = prices((b, cap, max(rec["row_width"], w)))
        full[:, :, :w] = rec["values"]
        read = full[:, :, :w]
        args = (read, rec["segment_ids"], rec["num_segments"])
        return dict(kernel=kernel, plain=plain, args=args, kw=kw,
                    read=read, scale=float(read.abs().max()))
    p, cap, w = rec["arena_shape"]
    table = rec["table"].clone()
    live = valid.any(1)
    moved = torch.nonzero(live & (table == 0)).flatten()
    extra = 0
    if moved.numel():
        free = torch.ones(p, dtype=torch.bool, device=dev)
        free[table.long()] = False
        spare = torch.nonzero(free).flatten()
        extra = max(moved.numel() - spare.numel(), 0)
        spare = torch.cat([spare, torch.arange(p, p + extra, device=dev)])
        table[moved] = spare[:moved.numel()].to(table.dtype)
    arena = prices((p + extra, cap, w))
    cols = rec["values"].shape[2]
    arena[table[live].long(), :, :cols] = rec["values"][live]
    arena[0] = float("nan")
    kw["num_cols"] = rec["num_cols"]
    args = (arena, rec["segment_ids"], table, rec["num_segments"])
    if key == "K3":
        args += (rec["chunk_rows"],)
    return dict(kernel=kernel, plain=plain, args=args, kw=kw,
                read=arena[:, :, :cols].index_select(0, table.long()),
                scale=float(rec["values"][live].abs().max()))


def check_replay(key: str, rp: dict) -> float:
    """The kernel against its plain version on a replayed launch (for
    K3 also on rows its wrapper must pad, and as raw partials). No output
    of K2/K3 may hold NaN: only padding rows name pool slot 0. Returns
    the largest absolute error."""
    import torch
    kernel, plain, args, kw = rp["kernel"], rp["plain"], rp["args"], rp["kw"]
    cases = [(args, kw)]
    if key == "K3":
        chunk = args[4]
        cut = args[2].shape[0] - 1
        check(cut > 0 and cut % chunk, "K3: no rows left to pad")
        cases.append(((args[0], args[1][:cut], args[2][:cut], args[3],
                       chunk), dict(kw, valid=kw["valid"][:cut],
                                    slot_ids=kw["slot_ids"][:cut])))
        cases.append((args, dict(kw, merge=False)))
    cases += [(a, dict(k, design="global")) for a, k in cases]
    err = 0.0
    for a, k in cases:
        out = kernel(*a, **k)
        if key != "K1":
            check(not any(bool(torch.isnan(v).any()) for v in out.values()),
                  f"{key}: a padding row read the NaN-poisoned pool slot 0")
        ref = plain(*a, **{n: v for n, v in k.items() if n != "design"})
        err = max(err, compare(out, ref, rp["scale"]))
    return err


#: events a block of K1's smem design at which phase 3 times its launch
#: alone (the design's SPLITK_EVENTS_PER_BLOCK is 2,048)
K1_PER_BLOCK = (2048, 4096, 8192, 16384)


def smem_extras(key: str, rp: dict, iters: int) -> dict:
    """Phase 3's additions for K1, K2 and K3 on their replay: the earlier
    design's time, the launch alone (the smem design's C call on
    arguments prepared once, CUDA events around the C call only; for K1
    also at each of K1_PER_BLOCK events a block) and, for K3, the
    cleared-row control."""
    import torch
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    from repro_torch.kernels._build import library
    kernel, plain, args, kw = rp["kernel"], rp["plain"], rp["args"], rp["kw"]
    prepared = (kw["valid"], kw["slot_ids"], kw["num_slots"],
                sa.norm_stats(kw["stats"]))
    if key == "K1":
        launch, outs, keep = sa.flat_smem_launch(*args, *prepared)
        entry = "seg_agg_flat_smem"
    elif key == "K3":
        launch, outs, keep = sa.splitk_smem_launch(*args, *prepared,
                                                   kw["num_cols"], True)
        entry = "seg_agg_splitk_smem"
    else:
        launch, outs, keep = sa.block_table_smem_launch(*args, *prepared,
                                                        kw["num_cols"])
        entry = "seg_agg_block_table_smem"
    lib = library("segment_splitk.cu")
    launch_ms = _sync_time_ms(lambda: lib.call(entry, *launch), iters)
    del outs, keep
    extra = {}
    if key == "K1":
        # the launch alone by events a block, each result held against
        # the plain version
        ref = plain(*args, **kw)
        extra["per_block_ms"] = {}
        for per in K1_PER_BLOCK:
            launch, outs, keep = sa.flat_smem_launch(*args, *prepared,
                                                     per_block=per)
            extra["per_block_ms"][per] = _sync_time_ms(
                lambda: lib.call(entry, *launch), iters)
            compare(outs, ref, rp["scale"])
            del outs, keep
    if key == "K3":
        valid = kw["valid"].clone()
        row = int(torch.nonzero(valid.any(1)).flatten()[0])
        valid[row] = False
        must_fail(f"K3 with live row {row}'s valid flags cleared",
                  lambda: compare(kernel(*args, **dict(kw, valid=valid)),
                                  plain(*args, **kw), rp["scale"]))
    return dict(
        earlier_ms=_sync_time_ms(lambda: kernel(*args, design="global",
                                                **kw), iters),
        launch_ms=launch_ms, **extra)


def nan_check(dev, g) -> float:
    """K1 with NaN values, on both designs: NaN wins min/max as
    jnp.minimum/maximum, and a NaN value poisons only its own segment's
    sum."""
    import torch
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    n = 5000
    v = torch.rand((n, 3), generator=g, device=dev) * 10.0 - 5.0
    v[7, 1] = float("nan")
    v[4000, 0] = float("nan")
    sid = torch.randint(0, 37, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    ok = torch.rand(n, generator=g, device=dev) > 0.2
    ok[7] = True
    ok[4000] = True
    ref = sa.segment_aggregate_plain(v, sid, 37, valid=ok)
    return max(compare(sa.segment_aggregate_cuda(v, sid, 37, valid=ok,
                                                 design=d), ref, 5.0)
               for d in sa.SPLITK_DESIGNS)


def kernel_record(key: str, rec: dict, g, iters: int) -> dict:
    """Phase 3 for one kernel: replay its recorded launch, check it and
    time it beside its plain version, the yardstick and its bound."""
    rp = replay(key, rec, g)
    err = check_replay(key, rp)
    kernel, plain, args, kw = rp["kernel"], rp["plain"], rp["args"], rp["kw"]
    valid, slots, ids = kw["valid"], kw["slot_ids"], args[1]
    s_total = rec["num_slots"] * rec["num_segments"]
    comp = slots[:, None] * rec["num_segments"] + ids
    n_valid = int(valid.sum())
    bound, by = _bound(valid.numel(), n_valid, rp["read"].shape[2],
                       rec["rows"], s_total, rec["stats"],
                       4 if key == "K1" else 8)
    if key == "K1":
        b, cap, w = rec["values"].shape
        shape = (f"stacked [{b}, {cap}, {max(rec['row_width'], w)}] "
                 f"(columns {list(range(w))} read)")
    else:
        shape = (f"arena {list(args[0].shape)}, table [{rec['rows']}]"
                 f" ({int(valid.any(1).sum())} live rows), num_cols="
                 f"{rec['num_cols']}")
        if key == "K3":
            shape += (f", chunk_rows={rec['chunk_rows']}, "
                      f"{-(-rec['rows'] // rec['chunk_rows'])} partials")
    shape += (f", S={rec['num_segments']}, slots={rec['num_slots']}, "
              f"valid={n_valid}")
    name, line, _ = KERNELS[key]
    out = dict(
        name=name, route="cuda", source=SPLITK_SOURCE,
        replaces=f"{JAX_FILE}:{line}", max_abs_err=err,
        ms=_sync_time_ms(lambda: kernel(*args, **kw), iters),
        plain_ms=_sync_time_ms(lambda: plain(*args, **kw),
                               max(iters // 4, 1)),
        bound_ms=bound, bound_by=by,
        library_ms=_library_sum_ms(rp["read"], comp, valid, s_total, iters),
        shape=shape)
    out.update(smem_extras(key, rp, iters), earlier_source=SOURCE)
    return out


# --------------------------------------------------------------- phases 1-2
def stock_oracle(keys, ts, price, window: float, num_keys: int) -> dict:
    """Per-window per-key mean / min / max over every event (float64)."""
    import numpy as np
    wstart = np.floor(ts / window) * window
    out = {}
    for s in np.unique(wstart):
        sel = wstart == s
        k = keys[sel] % num_keys
        p = price[sel].astype(np.float64)
        mn = np.full(num_keys, np.inf)
        mx = np.full(num_keys, -np.inf)
        sm = np.zeros(num_keys)
        ct = np.zeros(num_keys)
        np.minimum.at(mn, k, p)
        np.maximum.at(mx, k, p)
        np.add.at(sm, k, p)
        np.add.at(ct, k, 1.0)
        out[(float(s), float(s) + window)] = {
            "mean": sm / np.maximum(ct, 1.0), "min": mn, "max": mx,
            "count": ct}
    return out


def lrb_oracle(keys, ts, speed, window: float, num_keys: int) -> dict:
    """Per-window per-segment vehicle count, average speed, accident flag
    and toll over every event: counts and sums in float64; the stopped
    test (speed <= 1e-3) and the toll in float32, as the operator takes
    them."""
    import numpy as np
    wstart = np.floor(ts / window) * window
    out = {}
    for s in np.unique(wstart):
        sel = wstart == s
        k = keys[sel] % num_keys
        v = np.asarray(speed[sel], np.float32)
        ct = np.zeros(num_keys)
        sm = np.zeros(num_keys)
        stopped = np.zeros(num_keys)
        np.add.at(ct, k, 1.0)
        np.add.at(sm, k, v.astype(np.float64))
        np.add.at(stopped, k, (v <= np.float32(1e-3)).astype(np.float64))
        count = ct.astype(np.float32)
        accident = stopped >= 2
        toll = np.where(accident, 0.0,
                        2.0 * np.maximum(count - 50, 0.0) ** 2 * 1e-4)
        out[(float(s), float(s) + window)] = {
            "count": ct, "avg_speed": sm / np.maximum(ct, 1.0),
            "accident": accident, "toll": toll}
    return out


def hold_stock(wid, got: dict, ref: dict, num_keys: int, max_v: float):
    """A stock window against the oracle: min and max exact, the mean
    within SUM_RTOL x |mean| + SUM_ATOL x max|price|. Returns the mean's
    largest error."""
    import numpy as np
    for k in ("min", "max"):
        a = np.asarray(got[k], np.float32)
        check(a.shape == (num_keys,), f"{wid} {k} shape {a.shape}")
        check(np.array_equal(a, ref[k].astype(np.float32)),
              f"{wid} {k} differs from the oracle")
    mean = np.asarray(got["mean"], np.float64)
    check(mean.shape == (num_keys,) and np.isfinite(mean).all(),
          f"{wid} mean not finite / wrong shape")
    err = np.abs(mean - ref["mean"])
    # mean = sum / count: the sum tolerance divided by the count
    tol = SUM_RTOL * np.abs(ref["mean"]) + SUM_ATOL * max_v
    check(bool((err <= tol).all()),
          f"{wid} mean max error {err.max()} beyond tolerance")
    return float(err.max())


def hold_lrb(wid, got: dict, ref: dict, num_keys: int, max_v: float):
    """A Linear Road window against the oracle: count, accident and toll
    exact, avg_speed within the stock mean's tolerance (max_v the largest
    speed). Returns avg_speed's largest error."""
    import numpy as np
    for k in ("count", "accident", "toll"):
        a = np.asarray(got[k])
        check(a.shape == (num_keys,), f"{wid} {k} shape {a.shape}")
        check(np.array_equal(a.astype(ref[k].dtype), ref[k]),
              f"{wid} {k} differs from the oracle")
    avg = np.asarray(got["avg_speed"], np.float64)
    check(avg.shape == (num_keys,) and np.isfinite(avg).all(),
          f"{wid} avg_speed not finite / wrong shape")
    err = np.abs(avg - ref["avg_speed"])
    tol = SUM_RTOL * np.abs(ref["avg_speed"]) + SUM_ATOL * max_v
    check(bool((err <= tol).all()),
          f"{wid} avg_speed max error {err.max()} beyond tolerance")
    return float(err.max())


#: the Table-1 deployments the streaming phases run: the workload (its
#: name in ``repro_torch.configs.workloads``), the operator's keyword for
#: the key count, the oracle and the check of one window
DEPLOYMENTS = {"stock": ("STOCK_MARKET", "num_keys", stock_oracle,
                         hold_stock),
               "lrb": ("LRB", "num_segments", lrb_oracle, hold_lrb)}


def run_stream(device, *, windows: float, pool_slots: int, splitk: int,
               seed: int, spill_root: Path, operator: str = "stock",
               rate: float = None,
               width: int = None, device_budget: int = 6 << 30,
               host_budget: int = 512 << 20, step_seconds: float = 1.0,
               late_horizon: float = 300.0,
               restore_at: float = None, profile: bool = False,
               pipelined: bool = False, prefetch_backend: str = "fixed",
               fold_round_retry: bool = True, store_wrap=None,
               on_engine=None, aion_kw: dict = None, drill=None) -> dict:
    """Drive the port's ``StreamEngine`` with the Table-1 deployment of
    ``operator`` (stock market or Linear Road, ``DEPLOYMENTS``) for
    ``windows`` windows of processing time, close out, and hold every
    window against the oracle. ``restore_at`` (a fraction of the stream)
    takes a manifest checkpoint there, closes the engine, and resumes in a
    new engine restored from it over the same log store. ``profile`` runs
    the close-out's re-execution of every window under ``torch.profiler``
    (``device_profile``). ``rate`` and ``width`` default to Table 1 (CPU
    rehearsals pass smaller ones). ``pipelined`` folds every round on the
    engine's pipeline worker (the close-out's sweep too, submitted as one
    round), with ``prefetch_backend`` and ``fold_round_retry`` as in
    ``AionConfig``; ``store_wrap`` wraps the log store the engine gets,
    and ``on_engine`` is called with the engine once it is built.
    ``aion_kw`` adds ``AionConfig`` fields (phase 15's retry and breaker
    settings). ``drill`` (a ``CrashDrill``, phase 16) sees every step
    and may crash the engine, which the run then restores through it.
    The close-out readmits deferred ingest first, and the record keeps
    the ladder's transitions, the I/O retry counts and the pool's books
    (``pool_books``). Returns the run's record."""
    import numpy as np
    from repro_torch.configs import workloads
    from repro_torch.configs.base import AionConfig
    from repro_torch.core import PredictiveCleanup, StreamEngine, \
        TumblingWindows
    from repro_torch.core.batch_exec import BatchWorkItem
    from repro_torch.core.operators import make_operator
    from repro_torch.data.generators import make_generator
    from repro_torch.storage import make_store

    wl_name, keys_kw, oracle, hold = DEPLOYMENTS[operator]
    wl = getattr(workloads, wl_name)
    if width is not None:
        wl = workloads.WorkloadConfig(**{**wl.__dict__,
                                         "value_width": width})
    rate = rate or wl.max_ingestion_rate
    gen = make_generator(wl, seed=seed)
    w = gen.width
    wd = wl.window_duration

    class KeepAll(PredictiveCleanup):
        # the oracle keeps every event: no window is ever purged
        def should_purge(self, window_end, watermark):
            return False

    aion = AionConfig(pool_slots=pool_slots, splitk_chunk_rows=splitk,
                      pipelined_execution=pipelined,
                      prefetch_backend=prefetch_backend,
                      fold_round_retry=fold_round_retry,
                      **(aion_kw or {}))
    per_step = int(round(rate * step_seconds))
    steps = int(round(windows * wd / step_seconds))
    spill = Path(tempfile.mkdtemp(prefix="store_", dir=spill_root))
    counted = ("ingested", "ingested_late", "live_executions",
               "late_executions", "batch_executions", "batched_windows",
               "pooled_rows", "fallback_rows", "demand_pool_fills",
               "splitk_launches", "dropped", "purged_windows",
               "pipeline_rounds", "epoch_demoted_rows",
               "demoted_sync_rounds", "batch_stall_seconds",
               "shed_readahead_drives", "shed_prefetch_rounds",
               "deferred_events", "readmitted_events")
    counts = dict.fromkeys(counted, 0)
    io_counted = ("errors", "retries", "gave_up", "readahead_shed",
                  "staged_blocks")
    io_counts = dict.fromkeys(io_counted, 0)
    transitions = []

    def make():
        store = None
        if store_wrap is not None:
            store = store_wrap(make_store(
                aion.store_backend, spill,
                segment_bytes=aion.store_segment_bytes,
                readahead_bytes=aion.store_readahead_bytes))
        eng = StreamEngine(
            assigner=TumblingWindows(wd),
            operator=make_operator(operator, aion.block_size, w,
                                   device=device,
                                   **{keys_kw: wl.num_keys}),
            aion=aion, value_width=w,
            cleanup=KeepAll(coverage=aion.cleanup_coverage,
                            confidence=aion.cleanup_confidence),
            device_budget_bytes=device_budget,
            host_budget_bytes=host_budget, spill_dir=spill, store=store,
            device=device)
        if on_engine is not None:
            on_engine(eng)
        return eng

    def absorb(e):
        for k in counted:
            counts[k] += getattr(e.metrics, k)
        for k in io_counted:
            io_counts[k] += e.io.stats[k]
        transitions.extend(e.metrics.ladder_transitions)

    t_build = time.perf_counter()
    eng = make()
    if drill is not None:
        drill.bind(make)
    secs = {"build": time.perf_counter() - t_build, "generate": 0.0,
            "ingest": 0.0, "advance_watermark": 0.0, "poll": 0.0}
    restore_step = -1 if restore_at is None else int(restore_at * steps)
    ledger_k, ledger_t, ledger_p = [], [], []
    now = 0.0
    t_stream = time.perf_counter()
    for i in range(steps):
        t0 = time.perf_counter()
        batch = gen.batch(per_step, now)
        ledger_k.append(batch.keys)
        ledger_t.append(batch.timestamps)
        ledger_p.append(batch.values[:, 0].copy())
        t1 = time.perf_counter()
        eng.ingest(batch, now)
        t2 = time.perf_counter()
        eng.advance_watermark(now, now)
        t3 = time.perf_counter()
        eng.poll(now)
        t4 = time.perf_counter()
        secs["generate"] += t1 - t0
        secs["ingest"] += t2 - t1
        secs["advance_watermark"] += t3 - t2
        secs["poll"] += t4 - t3
        now += step_seconds
        if drill is not None:
            t0 = time.perf_counter()
            if drill.step(i + 1, now, eng, batch) is None:
                # the drill crashed the engine: drop it, then restore
                absorb(eng)
                eng = None
                eng = drill.restore(now)
            secs["drill"] = secs.get("drill", 0.0) + \
                time.perf_counter() - t0
        if i + 1 == restore_step:
            t0 = time.perf_counter()
            snap = eng.checkpoint_state(include_stored_data=False)
            absorb(eng)
            eng.close(drain_timeout=600)
            eng = make()
            eng.restore_state(snap)
            blocks = [b for win in snap["windows"] for b in win["blocks"]]
            secs["checkpoint_restore"] = time.perf_counter() - t0
            log(f"  t={now:6.1f}s checkpoint -> restore: "
                f"{len(snap['windows'])} windows, {len(blocks)} blocks "
                f"({sum(1 for b in blocks if b.get('stored'))} as store "
                f"references) in {secs['checkpoint_restore']:.2f} s")
            del snap, blocks
        if (i + 1) % max(steps // 6, 1) == 0:
            progress(eng, now, time.perf_counter() - t_stream)
    loop_s = (time.perf_counter() - t_stream - secs["generate"]
              - secs.get("checkpoint_restore", 0.0) - secs.get("drill", 0.0))
    # the stream's work is done when its rounds have folded: the
    # pipelined loop returns before they do, so their backlog counts
    stream_s = loop_s + backlog_drain(eng.pipeline, secs)

    # close out as the soak does: watermark past every lateness, the
    # remaining plans fire, then one batched sweep of every window
    t0 = time.perf_counter()
    end = now
    eng.advance_watermark(end + late_horizon, end)
    for t in np.linspace(end, end + 70.0, 6):
        eng.poll(float(t))
    # backpressure deferral bounds admission, it never loses events
    eng.flush_deferred(end + 70.0)
    if eng.pipeline is not None:
        check(eng.pipeline.drain(timeout=600), "pipeline did not drain")
    check(eng.io.drain(timeout=600), "I/O executor did not drain")
    items = [BatchWorkItem(wid, eng.windows[wid], True)
             for wid in sorted(eng.windows, key=lambda x: x.start)]
    if eng.pipeline is not None:
        sweep = functools.partial(pipelined_sweep, eng, items, end + 70.0)
    else:
        sweep = functools.partial(eng.batch_exec.execute, items,
                                  end + 70.0)
    prof = device_profile(sweep) if profile else sweep()
    secs["close_out"] = time.perf_counter() - t0
    results = {(wid.start, wid.end): r for wid, r in eng.results.items()}
    absorb(eng)
    obs = eng.observability()
    arena_bytes = eng.pool.arena_bytes if eng.pool is not None else 0
    prefetch = dict(eng.prestage.stats)
    stream = pool_stream(eng.pool)
    # the books are read with the I/O thread idle (a destage or a
    # prefetch stage the sweep left queued moves a slot while they count)
    check(eng.io.drain(timeout=600), "I/O executor did not drain")
    books = pool_books(eng)
    io_final = {k: eng.io.stats[k] for k in io_counted}
    eng.close(drain_timeout=600)
    shutil.rmtree(spill, ignore_errors=True)

    t0 = time.perf_counter()
    keys = np.concatenate(ledger_k)
    first = np.concatenate(ledger_p)
    want = oracle(keys, np.concatenate(ledger_t), first, wd, wl.num_keys)
    check(set(results) == set(want),
          f"windows {sorted(results)} != oracle {sorted(want)}")
    # the largest value: Table 1's stock prices lie in [10, 500)
    max_v = 500.0 if operator == "stock" else float(first.max())
    worst = max(hold(wid, results[wid], ref, wl.num_keys, max_v)
                for wid, ref in want.items())
    secs["oracle"] = time.perf_counter() - t0
    return {
        "events": int(keys.shape[0]), "windows": len(want),
        "events_per_s": keys.shape[0] / stream_s, "stream_s": stream_s,
        "loop_events_per_s": keys.shape[0] / loop_s,
        "seconds": secs, "counts": counts, "arena_bytes": arena_bytes,
        "max_mean_abs_err": worst, "observability": obs,
        "width": w, "rate": rate, "operator": operator,
        "profile": prof if profile else None,
        "pipeline": obs.get("pipeline", {}), "prefetch": prefetch,
        "pool_stream": stream, "books": books, "io": io_counts,
        "io_final": io_final, "transitions": transitions,
        "drill": drill.record if drill is not None else None,
    }


def progress(eng, now: float, elapsed: float) -> None:
    """One line of a stream's progress. (A helper, so that the run's frame
    keeps no reference into an engine that a drill replaces.)"""
    m = eng.metrics
    log(f"  t={now:6.1f}s windows={len(eng.windows)} "
        f"live={m.live_executions} late={m.late_executions} "
        f"pooled_rows={m.pooled_rows} fallback_rows={m.fallback_rows} "
        f"device={eng.device_bytes() / 2**30:.2f}GiB "
        f"host={eng.host_bytes() / 2**30:.2f}GiB elapsed={elapsed:.1f}s")


def pool_books(eng):
    """The block pool's books after a close-out: free slots, slots held by
    the engine's blocks and quarantined slots, which must add up to the
    pool's slots (None without a pool), with no slot both free and held,
    on the free list twice or held by two blocks."""
    pool = eng.pool
    if pool is None:
        return None
    blocks = [b for st in eng.windows.values() for b in st.blocks]
    with pool._lock:
        # slots attach and detach under the pool's lock: one snapshot
        held = [b.pool_slot for b in blocks if b.pool_slot is not None]
        free = [s for f in pool._free for s in f]
        quarantined = len(pool._quarantine)
        pending = len(pool._pending)
        pins = pool._pins
    return {"slots": pool.pool_slots, "free": len(free),
            "distinct_free": len(set(free)), "held": len(held),
            "distinct_held": len(set(held)),
            "free_and_held": len(set(free) & set(held)),
            "quarantined": quarantined, "pending_writes": pending,
            "pins": pins}


def check_books(tag: str, books) -> None:
    """``pool_books`` balanced: no slot leaked or counted twice."""
    check(books is not None, f"{tag}: no block pool")
    check(books["held"] == books["distinct_held"],
          f"{tag}: two blocks hold one pool slot: {books}")
    check(books["free"] == books["distinct_free"]
          and books["free_and_held"] == 0,
          f"{tag}: a slot is on the free list twice, or free and held: "
          f"{books}")
    check(books["pins"] == 0, f"{tag}: a pin is still held: {books}")
    check(books["free"] + books["held"] + books["quarantined"]
          == books["slots"], f"{tag}: the pool's books do not balance "
                             f"(free + held + quarantined != slots): "
                             f"{books}")


def pool_stream(pool):
    """The raw handle of the CUDA stream an arena's writes and folds run
    on (None off the card or without a pool)."""
    if pool is None or pool.device.type != "cuda":
        return None
    import torch
    with pool.stream():
        return torch.cuda.current_stream(pool.device).cuda_stream


def backlog_drain(pipeline, secs: dict) -> float:
    """Wait for the rounds a pipelined stream submitted to fold (a failed
    round raises ``PipelineError`` here); records and returns the
    seconds it took (0 without a pipeline)."""
    if pipeline is None:
        return 0.0
    t0 = time.perf_counter()
    check(pipeline.drain(timeout=600), "pipeline did not drain")
    secs["backlog_drain"] = time.perf_counter() - t0
    return secs["backlog_drain"]


def pipelined_sweep(eng, items, now: float) -> dict:
    """The close-out's re-execution of ``items`` as one round on the
    engine's pipeline worker; drains it and returns the results."""
    futs = eng.pipeline.submit(eng, items, now)
    check(eng.pipeline.drain(timeout=600), "pipeline did not drain")
    return {wid: f.result() for wid, f in futs.items()}


class FailOnceStore:
    """A log store that fails one demand read once (phase 13b): once
    ``arm``-ed, the next ``get`` made inside a demand fill's I/O task (a
    task whose handle ``demand`` registered; ``task_hook``, installed as
    the executor's ``fault_hook``, tells the store which task its thread
    runs) raises ``PermanentStoreError``, which the I/O path does not
    retry, so the demand fill and with it its fold round fail. A read by
    any other task (a prefetch stage of the same record) goes through,
    so the failure lands in a fold round. Every other call goes to the
    store."""

    def __init__(self, store):
        import threading
        self._store = store
        self._lock = threading.Lock()
        self._armed = False
        self._demand = weakref.WeakSet()     # handles of demand fills
        self._local = threading.local()
        self.failures = 0

    def __getattr__(self, name):
        return getattr(self._store, name)

    def task_hook(self, task) -> None:
        self._local.handle = task.handle

    def demand(self, handle) -> None:
        with self._lock:
            self._demand.add(handle)

    def arm(self) -> None:
        with self._lock:
            self._armed = not self.failures

    def get(self, window_key, block_id):
        from repro_torch.storage.blockstore import PermanentStoreError
        with self._lock:
            hit = self._armed and \
                getattr(self._local, "handle", None) in self._demand
            if hit:
                self._armed = False
                self.failures += 1
        if hit:
            raise PermanentStoreError(
                "planted: one demand read fails once")
        return self._store.get(window_key, block_id)


def failure_control(device, *, retry: bool, **run) -> dict:
    """Phase 13b: ``run_stream`` pipelined with learned prefetch over a
    ``FailOnceStore``, armed by the first demand fill that asks for a
    record in storage. With ``retry`` (``fold_round_retry``) the failed round
    is retried through the engine's backup executor and must win, and the
    run holds every window to the oracle as any other; without it the
    pipeline's ``drain()`` after the stream raises ``PipelineError``,
    which this function re-raises after closing the engine."""
    from repro_torch.core import PipelineError, Tier
    stores, engines = [], []

    def wrap(store):
        stores.append(FailOnceStore(store))
        return stores[-1]

    def arm_on_demand(eng):
        engines.append(eng)
        real = eng.io.request_stage
        store = stores[-1]
        eng.io.executor.fault_hook = store.task_hook

        def request_stage(window, blocks=None, demand=False, parent=None):
            stored = demand and not store.failures and any(
                b.tier == Tier.STORAGE and b.in_storage
                for b in (blocks if blocks is not None else ()))
            handle = real(window, blocks, demand=demand, parent=parent)
            if stored:
                store.demand(handle)
                store.arm()
            return handle
        eng.io.request_stage = request_stage

    try:
        rec = run_stream(device, pipelined=True, prefetch_backend="learned",
                         fold_round_retry=retry, store_wrap=wrap,
                         on_engine=arm_on_demand, **run)
    except PipelineError:
        eng = engines[-1]
        eng.close(drain_timeout=600)      # the failure was consumed
        check(stores[-1].failures == 1, "the control failed elsewhere")
        raise
    rec["store_failures"] = stores[-1].failures
    return rec


#: the store operations the chaos phases inject faults on: the data path,
#: as the JAX chaos soak (``tests/test_soak_differential.py``)
CHAOS_OPS = ("get", "put", "commit", "readahead")
#: phase 15's settings: the JAX chaos soak's injector (seed 77, a quarter
#: of the calls failing, runs of at most 2, below ``io_retry_limit``, so
#: every retry wins) and its chaos axis of ``AionConfig``
CHAOS_SEED, CHAOS_RATE = 77, 0.25
CHAOS_AION = dict(io_retry_backoff=0.0, breaker_error_threshold=2)
#: phase 16's settings: the JAX restart soak's injector and ``AionConfig``
#: fields, a checkpoint every 10 s of processing time, and the bytes torn
#: off the log's tail at the crash
RECOVERY_SEED, RECOVERY_RATE = 5, 0.05
RECOVERY_AION = dict(io_retry_backoff=0.0, breaker_error_threshold=4)
CHECKPOINT_EVERY = 10.0
TORN_TAIL_BYTES = 66
#: device bytes phase 16 allows beyond its readings (one arena apart)
MEMORY_SLACK = 256 << 20


def chaos_stream(device, *, pipelined: bool, **run) -> dict:
    """Phase 15: ``run_stream`` over a ``FaultyBlockStore`` that fails a
    quarter of its get/put/commit/readahead calls (``CHAOS_SEED``,
    ``max_consecutive=2``), with ``CHAOS_AION``; synchronous, or
    pipelined with learned prefetch. Adds the injector's counts to the
    record (``injected``)."""
    from repro_torch.testing import FaultInjector, FaultyBlockStore
    inj = FaultInjector(seed=CHAOS_SEED,
                        rates={op: CHAOS_RATE for op in CHAOS_OPS},
                        max_consecutive=2)
    rec = run_stream(device, pipelined=pipelined,
                     prefetch_backend="learned" if pipelined else "fixed",
                     aion_kw=CHAOS_AION,
                     store_wrap=lambda store: FaultyBlockStore(store, inj),
                     **run)
    rec["injected"] = dict(inj.stats)
    return rec


class CrashDrill:
    """Phase 16, ``tests/test_soak_differential.py::
    test_soak_differential_chaos_restart`` step for step on
    ``run_stream``: the engine's store is a ``FaultyBlockStore`` (5% of
    the data path failing, runs of at most 2); every
    ``CHECKPOINT_EVERY`` seconds of processing time
    ``EngineRecovery.checkpoint`` takes a manifest checkpoint under
    ``paused()``. At step ``crash_step`` the engine drains, destages
    every device block and spills every host block (paused), then every
    ``get`` is poisoned: the next watermark, poll and close must raise
    ``PipelineError`` or ``StagingError``. The engine is healed, its
    pipeline closed and its I/O drained and shut down, and the store
    crashes with ``TORN_TAIL_BYTES`` torn off its log's tail. ``step``
    then returns None; the run drops the engine and calls ``restore``,
    which checks that the dead engine's arena is gone, rebuilds through
    ``EngineRecovery.restore()`` (the factory reopens the store: the WAL
    replay) and replays the batches after the checkpoint. ``record``
    keeps the readings."""

    def __init__(self, *, crash_step: int, late_horizon: float):
        from repro_torch.testing import FaultInjector
        self.inj = FaultInjector(seed=RECOVERY_SEED,
                                 rates={op: RECOVERY_RATE
                                        for op in CHAOS_OPS},
                                 max_consecutive=2)
        self.crash_step, self.late_horizon = crash_step, late_horizon
        self.store = None        # the store the live engine writes
        self.pending = []        # (step, batch) after the last checkpoint
        self.last_checkpoint = 0.0
        self.recovery = None
        self.crashed = False
        self.device = None       # the dead engine's
        self._dead = []          # weak references to its arena
        self.record = {"checkpoints": 0, "checkpoint_s": 0.0}

    def wrap(self, store):
        """``run_stream``'s ``store_wrap``: every store the engines get
        (the first, and the one each restore reopens) fails through the
        one injector."""
        from repro_torch.testing import FaultyBlockStore
        self.store = FaultyBlockStore(store, self.inj)
        return self.store

    def bind(self, make) -> None:
        from repro_torch.distributed import EngineRecovery
        self.recovery = EngineRecovery(make, max_restarts=1)

    def step(self, step: int, now: float, eng, batch):
        self.pending.append((step, batch))
        if now - self.last_checkpoint >= CHECKPOINT_EVERY:
            t0 = time.perf_counter()
            with self.inj.paused():
                self.recovery.checkpoint(eng, token=(step, now, now))
            self.record["checkpoints"] += 1
            self.record["checkpoint_s"] += time.perf_counter() - t0
            self.last_checkpoint = now
            self.pending = []
        if self.crashed or step != self.crash_step:
            return eng
        self.crash(eng, now)
        return None

    def crash(self, eng, now: float) -> None:
        from repro_torch.core import PipelineError, StagingError, Tier
        self.crashed = True
        rec = self.record
        self.device = eng.device
        rec["memory_before"] = _allocated(eng.device)
        rec["arena_bytes"] = eng.pool.arena_bytes
        t0 = time.perf_counter()
        with self.inj.paused():
            check(eng.pipeline.drain(timeout=600), "16: no drain")
            check(eng.io.drain(timeout=600), "16: no I/O drain")
            for st in eng.windows.values():
                for blk in list(st.blocks):
                    if blk.tier == Tier.DEVICE:
                        eng.io.destage_block_sync(blk)
            eng.io.spill_blocks_sync(
                [b for st in eng.windows.values() for b in st.blocks
                 if b.tier == Tier.HOST and b.fill > 0])
        rec["spill_s"] = time.perf_counter() - t0
        self.inj.poison(("get",))
        try:
            eng.advance_watermark(now + self.late_horizon, now)
            eng.poll(now)
            eng.close(drain_timeout=600)
        except (PipelineError, StagingError) as e:
            rec["poisoned"] = f"{type(e).__name__}: {str(e)[:200]}"
            log(f"  control rejected, as it must be: the poisoned engine "
                f"raised {rec['poisoned']}")
        else:
            raise SmokeFailure("16: the engine with every get poisoned "
                               "closed clean")
        self.inj.heal()
        eng.pipeline.close()
        check(eng.io.drain(timeout=600), "16: the dead engine's I/O did "
                                         "not drain")
        eng.io.shutdown()
        self.store.crash(torn_tail_bytes=TORN_TAIL_BYTES)
        # what must die with the engine: its arena (weak references only)
        self._dead = [weakref.ref(eng.pool.keys),
                      weakref.ref(eng.pool.values)]

    def restore(self, now: float):
        """Rebuild after ``crash`` (the run holds no reference to the dead
        engine any more): returns the restored engine, the batches after
        the checkpoint replayed into it and polled once."""
        import torch
        rec = self.record
        gc.collect()
        check(all(r() is None for r in self._dead),
              "16: the dead engine's arena is still reachable")
        rec["memory_after_teardown"] = _allocated(self.device)
        t0 = time.perf_counter()
        try:
            with self.inj.paused():
                eng, (ck_step, ck_now, _) = self.recovery.restore()
        except KeyError as e:
            raise SmokeFailure(f"16: the reopened store lost a record the "
                               f"checkpoint references: {e}") from e
        rec["restore_s"] = time.perf_counter() - t0
        store = eng.io.store
        rec["truncated_bytes"] = store.stats["recovery_truncated_bytes"]
        rec["recovered_records"] = store.stats["recovered_records"]
        t0 = time.perf_counter()
        replayed = 0
        now = max(now, ck_now)
        for _, batch in self.pending:
            eng.ingest(batch, now)
            replayed += len(batch)
        eng.poll(now)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        rec["replay_s"] = time.perf_counter() - t0
        rec.update(replayed_events=replayed, checkpoint_step=ck_step,
                   restarts=self.recovery.restarts,
                   device=str(eng.device),
                   pool_device=str(eng.pool.device),
                   memory_after_restore=_allocated(eng.device),
                   launches_at_restore=_launches())
        self.pending = []
        return eng


def _allocated(device):
    """``torch.cuda.memory_allocated`` on a CUDA device (None elsewhere)."""
    if device.type != "cuda":
        return None
    import torch
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def _launches() -> dict:
    """K1-K3's launch counts as their wrappers hold them now."""
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    return {k: fn.launches for k, fn in zip(KERNELS, sa.KERNEL_WRAPPERS)}


def crash_recovery(device, *, windows: float, **run) -> dict:
    """Phase 16: ``run_stream`` pipelined with learned prefetch and
    ``RECOVERY_AION`` under a ``CrashDrill`` crashing at the stream's
    half; the record's ``drill`` holds its readings."""
    from repro_torch.configs.workloads import STOCK_MARKET
    steps = int(round(windows * STOCK_MARKET.window_duration
                      / run.get("step_seconds", 1.0)))
    drill = CrashDrill(crash_step=steps // 2,
                       late_horizon=run.get("late_horizon", 300.0))
    rec = run_stream(device, windows=windows, pipelined=True,
                     prefetch_backend="learned", aion_kw=RECOVERY_AION,
                     store_wrap=drill.wrap, drill=drill, **run)
    rec["injected"] = dict(drill.inj.stats)
    return rec


def _threads_line(recorder) -> str:
    streams = {k: sorted(map(str, v)) for k, v in recorder.streams.items()}
    return (f"launches by thread {json.dumps(recorder.threads)}, streams "
            f"{streams}")


def chaos_checks(tag: str, rec: dict, recorder, main: dict = None) -> None:
    """Phase 15 beyond the checks every streaming phase takes (each
    exact, as the JAX chaos soak's): every event ingested, no retry given
    up, at least 100 faults injected and retried, the ladder engaged with
    ``(0, 1)`` first and one rung at a time, every deferred event
    readmitted, the pool's books balanced, every K1-K3 launch on the
    arena's stream. Prints the numbers, and, pipelined, the threads the
    fold launches came from once rung 3 demoted rounds to the main
    thread."""
    c, io, inj, tr = rec["counts"], rec["io"], rec["injected"], \
        [tuple(t) for t in rec["transitions"]]
    top = max((to for _, to in tr), default=0)
    vs = "" if main is None else (
        f" against phase 1's {main['events_per_s']:.1f} in this run "
        f"({rec['events_per_s'] / main['events_per_s']:.3f}x)")
    log(f"  {tag}: {rec['events_per_s']:.1f} events/s{vs}; injected "
        f"{json.dumps(inj)}; I/O {json.dumps(io)}; shed readahead drives "
        f"{c['shed_readahead_drives']}, shed prefetch rounds "
        f"{c['shed_prefetch_rounds']}, demoted_sync_rounds "
        f"{c['demoted_sync_rounds']}, deferred {c['deferred_events']} / "
        f"readmitted {c['readmitted_events']} events; pipeline "
        f"{json.dumps(rec['pipeline'])}")
    log(f"  {tag}: ladder {len(tr)} transitions, highest rung {top}, first "
        f"{tr[:12]}; pool books {json.dumps(rec['books'])}")
    log(f"  {tag}: {_threads_line(recorder)}")
    check(c["ingested"] == rec["events"],
          f"{tag}: ingested {c['ingested']} of {rec['events']} events")
    check(io["gave_up"] == 0, f"{tag}: {io['gave_up']} retries given up")
    check(inj["injected"] >= 100 and io["retries"] > 0,
          f"{tag}: {inj['injected']} faults injected, {io['retries']} "
          "retries: the chaos did not happen")
    check(bool(tr) and tr[0] == (0, 1),
          f"{tag}: the ladder's first transitions {tr[:3]}, not (0, 1)")
    check(all(abs(b - a) == 1 for a, b in tr),
          f"{tag}: the ladder skipped a rung: {tr}")
    check(c["deferred_events"] == c["readmitted_events"],
          f"{tag}: {c['deferred_events']} events deferred, "
          f"{c['readmitted_events']} readmitted")
    check_books(tag, rec["books"])
    for k in KERNELS:
        check(recorder.streams[k] <= {rec["pool_stream"]},
              f"{tag}: {k} launched on streams {recorder.streams[k]}, not "
              f"the arena's ({rec['pool_stream']})")
    if rec["pipeline"]:
        # a demoted round of one window folds per window, with no K1-K3
        # launch; one of several windows launches from the main thread
        threads = sorted({t for k in KERNELS for t in recorder.threads[k]})
        log(f"  {tag}: rung 3 {'reached' if top >= 3 else 'never reached'}"
            f", {c['demoted_sync_rounds']} rounds demoted to the main "
            f"thread; K1-K3 launched from {threads}")


def recovery_checks(tag: str, rec: dict, recorder) -> None:
    """Phase 16 beyond the checks every streaming phase takes: the
    poisoned engine raised, one restart, a torn tail truncated, no retry
    given up after the restore, the restored engine on the run's device,
    the dead engine's arena gone (``CrashDrill.restore``) and, on the
    card, device memory after the teardown one arena below the reading
    before the crash and after the restore back at it, each within
    ``MEMORY_SLACK``; the pool's books balanced. Prints the readings."""
    d = rec["drill"]
    gib = 2.0 ** 30
    mem = {k: (None if d[k] is None else round(d[k] / gib, 3)) for k in (
        "memory_before", "memory_after_teardown", "memory_after_restore")}
    log(f"  {tag}: recovery: restore() {d['restore_s']:.3f} s (store "
        f"reopen, {d['recovered_records']} records, and the manifest "
        f"restore), replay of {d['replayed_events']} events to the first "
        f"poll {d['replay_s']:.3f} s; the reopen truncated "
        f"{d['truncated_bytes']} bytes; checkpoint at step "
        f"{d['checkpoint_step']}; {d['checkpoints']} checkpoints in "
        f"{d['checkpoint_s']:.2f} s; the spill before the crash "
        f"{d['spill_s']:.2f} s")
    log(f"  {tag}: device GiB before the crash / after the teardown / after "
        f"the restore {json.dumps(mem)} (arena "
        f"{d['arena_bytes'] / gib:.3f} GiB); injected "
        f"{json.dumps(rec['injected'])}; I/O after the restore "
        f"{json.dumps(rec['io_final'])}; pool books "
        f"{json.dumps(rec['books'])}")
    log(f"  {tag}: {_threads_line(recorder)}")
    check("poisoned" in d, f"{tag}: the poisoned engine did not raise")
    check(d["restarts"] == 1, f"{tag}: {d['restarts']} restarts")
    check(d["truncated_bytes"] > 0, f"{tag}: the reopen truncated nothing")
    check(rec["io_final"]["gave_up"] == 0,
          f"{tag}: {rec['io_final']['gave_up']} retries given up after the "
          "restore")
    check(d["pool_device"] == d["device"],
          f"{tag}: the restored pool is on {d['pool_device']}, the engine "
          f"on {d['device']}")
    if d["memory_before"] is not None:
        check(d["memory_after_teardown"] <= d["memory_before"]
              - d["arena_bytes"] + MEMORY_SLACK,
              f"{tag}: the teardown freed "
              f"{d['memory_before'] - d['memory_after_teardown']} bytes, "
              f"not the dead engine's arena of {d['arena_bytes']}")
        check(d["memory_after_restore"] <= d["memory_before"]
              + MEMORY_SLACK,
              f"{tag}: {d['memory_after_restore']} bytes after the restore "
              f"against {d['memory_before']} before the crash")
    check_books(tag, rec["books"])


#: phase 14's tenants (``configs/workloads.py: TENANT_PROFILES``): three
#: stock-market streams sharing the pooled arena and one Linear Road
#: stream, whose width is not the arena's, on the unpooled per-block path
TENANTS = ("qwen3_moe_30b", "command_r_35b", "mistral_large_123b",
           "granite_34b")


def run_tenants(device, *, seconds: float, seed: int, spill_root: Path,
                pool_slots: int = 4096, device_budget: int = 8 << 30,
                host_budget: int = 2 << 30, rate: float = None,
                widths: dict = None, step_seconds: float = 1.0,
                late_horizon: float = 300.0) -> dict:
    """Phase 14: ``MultiTenantEngine.from_profiles`` with ``TENANTS``,
    pipelined with learned prefetch, one shared device budget (the arena
    at most half of it), one host budget sliced by the profiles, one log
    store, one transfer executor and one pipeline. Each tenant streams at
    its Table-1 rate (``rate`` and ``widths``, by operator, override it
    for CPU rehearsals) for ``seconds`` of processing time; then every
    tenant closes out as ``run_stream`` does (its sweep submitted to the
    shared pipeline) and every window is held to its operator's oracle.
    Returns the run's record."""
    import numpy as np
    from repro_torch.configs import workloads
    from repro_torch.configs.base import AionConfig
    from repro_torch.core import MultiTenantEngine
    from repro_torch.core.batch_exec import BatchWorkItem
    from repro_torch.data.generators import make_generator

    profiles = []
    for name in TENANTS:
        p = workloads.get_tenant_profile(name)
        wl = p.workload
        over = {}
        if widths is not None:
            over["value_width"] = widths[wl.operator]
        if rate is not None:
            over["max_ingestion_rate"] = rate
        if over:
            p = dataclasses.replace(p, workload=dataclasses.replace(
                wl, **over))
        profiles.append(p)
    aion = AionConfig(pool_slots=pool_slots, pipelined_execution=True,
                      prefetch_backend="learned")
    spill = Path(tempfile.mkdtemp(prefix="tenants_", dir=spill_root))
    t_build = time.perf_counter()
    mt = MultiTenantEngine.from_profiles(
        profiles, device_budget_bytes=device_budget,
        host_budget_bytes=host_budget, spill_dir=spill, aion=aion,
        device=device)
    secs = {"build": time.perf_counter() - t_build, "generate": 0.0,
            "ingest": 0.0, "advance_watermark": 0.0, "poll": 0.0}
    for eng in mt.engines.values():
        # the oracles keep every event: no window is ever purged
        eng.cleanup.should_purge = lambda window_end, watermark: False
    gens = {p.name: make_generator(p.workload, seed=seed + i)
            for i, p in enumerate(profiles)}
    ledger = {p.name: ([], [], []) for p in profiles}
    steps = int(round(seconds / step_seconds))
    now = 0.0
    t_stream = time.perf_counter()
    for i in range(steps):
        for p in profiles:
            t0 = time.perf_counter()
            batch = gens[p.name].batch(
                int(round(p.workload.max_ingestion_rate * step_seconds)),
                now)
            lk, lt, lv = ledger[p.name]
            lk.append(batch.keys)
            lt.append(batch.timestamps)
            lv.append(batch.values[:, 0].copy())
            t1 = time.perf_counter()
            mt.ingest(p.name, batch, now)
            secs["generate"] += t1 - t0
            secs["ingest"] += time.perf_counter() - t1
        t0 = time.perf_counter()
        mt.advance_watermark(now, now)
        t1 = time.perf_counter()
        mt.poll(now)
        secs["advance_watermark"] += t1 - t0
        secs["poll"] += time.perf_counter() - t1
        now += step_seconds
        if (i + 1) % max(steps // 4, 1) == 0:
            log(f"  t={now:6.1f}s " + " ".join(
                f"{n}: windows={len(e.windows)} "
                f"late={e.metrics.late_executions}"
                for n, e in mt.engines.items())
                + f" elapsed={time.perf_counter() - t_stream:.1f}s")
    loop_s = time.perf_counter() - t_stream - secs["generate"]
    stream_s = loop_s + backlog_drain(mt.pipeline, secs)

    t0 = time.perf_counter()
    end = now
    mt.advance_watermark(end + late_horizon, end)
    for t in np.linspace(end, end + 70.0, 6):
        mt.poll(float(t))
    check(mt.pipeline.drain(timeout=600), "pipeline did not drain")
    for eng in mt.engines.values():
        check(eng.io.drain(timeout=600), "I/O executor did not drain")
        items = [BatchWorkItem(wid, eng.windows[wid], True)
                 for wid in sorted(eng.windows, key=lambda x: x.start)]
        pipelined_sweep(eng, items, end + 70.0)
    secs["close_out"] = time.perf_counter() - t0

    counted = ("ingested", "live_executions", "late_executions",
               "pooled_rows", "fallback_rows", "demand_pool_fills",
               "pipeline_rounds", "epoch_demoted_rows")
    tenants, events, worst = {}, 0, 0.0
    t0 = time.perf_counter()
    for p in profiles:
        eng = mt.engines[p.name]
        wl = p.workload
        _, keys_kw, oracle, hold = DEPLOYMENTS[wl.operator]
        lk, lt, lv = (np.concatenate(x) for x in ledger[p.name])
        want = oracle(lk, lt, lv, wl.window_duration, wl.num_keys)
        got = {(w.start, w.end): r for w, r in eng.results.items()}
        check(set(got) == set(want),
              f"{p.name}: windows {sorted(got)} != oracle {sorted(want)}")
        max_v = 500.0 if wl.operator == "stock" else float(lv.max())
        err = max(hold(wid, got[wid], ref, wl.num_keys, max_v)
                  for wid, ref in want.items())
        worst = max(worst, err)
        events += int(lk.shape[0])
        tenants[p.name] = dict(
            operator=wl.operator, weight=p.weight, events=int(lk.shape[0]),
            windows=len(want), pooled=eng.pool is not None,
            max_err=err, **{k: getattr(eng.metrics, k) for k in counted})
    secs["oracle"] = time.perf_counter() - t0
    rec = {
        "events": events, "events_per_s": events / stream_s,
        "stream_s": stream_s, "loop_events_per_s": events / loop_s,
        "seconds": secs, "tenants": tenants,
        "windows": sum(t["windows"] for t in tenants.values()),
        "fairness": mt.fairness_stats(),
        "pipeline": mt.pipeline.stats.copy(),
        "arena_bytes": mt.pool.arena_bytes if mt.pool is not None else 0,
        "max_mean_abs_err": worst,
        "counts": {k: sum(t[k] for t in tenants.values())
                   for k in counted},
        "operator": "tenants", "profile": None,
        "pool_stream": pool_stream(mt.pool),
        "observability": {"pool": mt.pool.stats.copy()
                          if mt.pool is not None else {},
                          "store": mt.store.stats.copy()},
    }
    mt.close()
    shutil.rmtree(spill, ignore_errors=True)
    return rec


def _print_run(tag: str, rec: dict) -> None:
    mean = "avg_speed" if rec["operator"] == "lrb" else "mean"
    backlog = rec["seconds"].get("backlog_drain")
    log(f"  {tag}: {rec['events']} events, {rec['windows']} windows, "
        f"{rec['events_per_s']:.1f} events/s over {rec['stream_s']:.2f} s "
        "of ingest/watermark/poll"
        + ("" if backlog is None else
           f" and the {backlog:.2f} s its pipeline's backlog took to fold "
           f"(the loop alone: {rec['loop_events_per_s']:.1f} events/s)")
        + f"; max |{mean} - oracle| {rec['max_mean_abs_err']:.3g}")
    log(f"  {tag} seconds: " + json.dumps(
        {k: round(v, 3) for k, v in rec["seconds"].items()}))
    log(f"  {tag} counts: " + json.dumps(rec["counts"]))
    obs = rec["observability"]
    summary = {k: obs.get(k) for k in ("pool", "fold", "store")}
    summary["io"] = {k: v for k, v in obs.get("io", {}).items()
                     if isinstance(v, (int, float))}
    log(f"  {tag} observability: " + json.dumps(summary, default=str))


#: K1's kernels as the profiler names them (its smem design is the
#: strided-row case of the shared fold, its earlier design flat_kernel)
K1_PROFILE_NAMES = ("StridedRows", "flat_kernel")
#: the kernels of ``index_select`` (the operator's row gathers)
GATHER_PROFILE_NAMES = ("gather_kernel", "indexSelect")


def fold_profile(rec: dict) -> dict:
    """The profiled close-out of a run (``run_stream(profile=True)``):
    device time of K1, of the operator's row gathers (``index_select``)
    and of the rest, the device's busy share of the wall time by the
    kernels' summed self time, and the largest kernels. None where the
    profiler recorded no device time."""
    wall, rows = rec["profile"]
    if not rows:
        return None
    busy = sum(r[0] for r in rows)
    k1 = sum(us for us, _, key in rows
             if any(n in key for n in K1_PROFILE_NAMES))
    gather = sum(us for us, _, key in rows
                 if any(n in key for n in GATHER_PROFILE_NAMES))
    return dict(wall_s=wall, busy_s=busy / 1e6, busy_share=busy / 1e6 / wall,
                k1_ms=k1 / 1e3, gather_ms=gather / 1e3,
                rest_ms=(busy - k1 - gather) / 1e3,
                top=[(round(us / 1e3, 4), n, key[:90])
                     for us, n, key in rows[:10]])


# --------------------------------------------------------------- phases 4-5
#: the attention kernels: name, the TPU kernel they replace, and the
#: module of ``repro_torch.kernels`` whose ``*_cuda`` wrapper counts them
ATTN_KERNELS = {
    "K4": ("decode_split_kv (K4, paged decode attention)",
           "src/repro/kernels/decode_attention.py:69", "decode_attention",
           "decode_attention_paged_cuda"),
    "K5": ("flash_fwd_wgmma (K5, prefill flash attention)",
           "src/repro/kernels/flash_attention.py:75", "flash_attention",
           "flash_attention_cuda"),
}


def attn_wrapper(key: str):
    _, _, mod, fn = ATTN_KERNELS[key]
    return getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), fn)


def minus_one_pages(table, lens, page: int) -> int:
    """(row, page) entries of a launched table that are -1 inside the
    row's sequence: pages the kernel skips."""
    import torch
    need = (lens.long() + page - 1) // page
    cols = torch.arange(table.shape[1], device=table.device)[None, :]
    return int(((table < 0) & (cols < need[:, None])).sum())


def resident_positions(table, lens, page: int) -> int:
    """Positions a launch reads: inside its sequence, on a resident
    page."""
    import torch
    pos = torch.arange(table.shape[1] * page, device=table.device)
    res = torch.repeat_interleave(table >= 0, page, dim=1)
    return int(((pos[None, :] < lens.long()[:, None]) & res).sum())


def attn_close(out, ref) -> float:
    """``out`` within one bf16 ulp of ``ref`` elementwise (the ulp of the
    larger magnitude, at least ATTN_ULP_FLOOR's), NaN at the same places.
    Returns the largest absolute difference."""
    import torch
    a, b = out.float(), ref.float()
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    check(torch.equal(torch.isnan(a), torch.isnan(b)),
          "NaN positions differ")
    fin = ~torch.isnan(b)
    a, b = a[fin], b[fin]
    diff = (a - b).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=ATTN_ULP_FLOOR)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    worst = float((diff / ulp).max()) if diff.numel() else 0.0
    check(worst <= 1.0, f"max error {err} ({worst:.2f} bf16 ulps) beyond "
                        "one bf16 ulp")
    return err


def flash_limits():
    return importlib.import_module("repro_torch.kernels.flash_limits")


def zero_counts(fns) -> None:
    """Each wrapper's launch counter, and its counts by design where it
    keeps them (K5, K6), to 0."""
    for fn in fns:
        fn.launches = 0
        for key in getattr(fn, "launches_by_design", {}):
            fn.launches_by_design[key] = 0


def by_design(fns: dict) -> dict:
    """The counts by design of the wrappers that keep them."""
    return {k: dict(fn.launches_by_design) for k, fn in fns.items()
            if hasattr(fn, "launches_by_design")}


def flash_close(out, ref, rtol: float, floor: float) -> dict:
    """A bf16 output of K5's or K6's wgmma design against the fp32 oracle:
    NaN at the same places, the worst row's norm-relative error within
    ``rtol``, elementwise within ULP_LIMIT bf16 ulps (magnitudes below
    ``floor`` counted as ``floor``). Returns the readings."""
    import torch
    FL = flash_limits()
    a, b = out.float(), ref.float()
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    check(torch.equal(torch.isnan(a), torch.isnan(b)),
          "NaN positions differ")
    row, ulps = FL.row_error(a, b), FL.ulp_error(a, b, floor)
    fin = ~torch.isnan(b)
    err = float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0
    check(row <= rtol, f"the worst row is off by {row:.3g} of its norm, "
                       f"beyond {rtol}")
    check(ulps <= FL.ULP_LIMIT, f"{ulps:.1f} bf16 ulps, beyond "
                                f"{FL.ULP_LIMIT}")
    return {"max_abs_err": err, "row_err": row, "ulps": ulps}


def control_reads(what: str, reading: float, limit: float) -> float:
    """A planted fault must read at least CONTROL_FACTOR times the limit
    of the check that holds the kernel. Returns the ratio."""
    factor = flash_limits().CONTROL_FACTOR
    ratio = reading / limit
    check(ratio >= factor, f"control: {what} read {reading:.3g}, "
                           f"{ratio:.1f} x the limit {limit}, below "
                           f"{factor} x")
    log(f"  control rejected, as it must be: {what} read {reading:.3g}, "
        f"{ratio:.1f} x the limit {limit}")
    return ratio


def fp32_close(out, ref, tol: float) -> float:
    """float32 ``out`` within ``tol`` + ``tol`` x |ref| of ``ref``
    elementwise, NaN at the same places. Returns the largest absolute
    difference."""
    import torch
    a, b = out.float(), ref.float()
    check(a.shape == b.shape and torch.equal(torch.isnan(a), torch.isnan(b)),
          "float32: shape or NaN positions differ")
    fin = ~torch.isnan(b)
    diff = (a - b)[fin].abs()
    worst = float((diff / (tol + tol * b[fin].abs())).max()) \
        if diff.numel() else 0.0
    check(worst <= 1.0, f"float32: max error {float(diff.max())} beyond "
                        f"{tol} + {tol} x |ref|")
    return float(diff.max()) if diff.numel() else 0.0


def lse_close(lse, ref) -> float:
    """The fp32 log-sum-exp within LSE_TOL of the plain version's, -inf
    at the same places."""
    import torch
    check(lse.shape == ref.shape and torch.equal(torch.isinf(lse),
                                                 torch.isinf(ref)),
          "lse: shape or -inf positions differ")
    fin = torch.isfinite(ref)
    err = float((lse[fin] - ref[fin]).abs().max()) if fin.any() else 0.0
    check(err <= LSE_TOL, f"lse: max error {err} beyond {LSE_TOL}")
    return err


def must_fail(what: str, fn) -> None:
    """A planted fault: the check that ``fn`` runs must reject it."""
    try:
        fn()
    except SmokeFailure as e:
        log(f"  control rejected, as it must be: {what} ({e})")
        return
    raise SmokeFailure(f"control: {what} passed the check")


def run_serve(device, cfg, *, small: bool = False) -> dict:
    """Drive the port's serving path at ``cfg``'s attention width (all its
    layers, bf16): SERVE_RUN's prompts, of lengths drawn uniformly from
    its ``prompt`` range (``default_rng(PROMPT_SEED)``; the tensors come
    from a ``torch.Generator`` seeded with SEED + 4), go through
    ``ops.flash_attention`` (K5, layer 0) and ``ContinuousBatcher.submit``
    (all layers); then each decodes MAX_NEW tokens through
    ``ContinuousBatcher.step`` (K4) on a ``TieredKVCache`` below the live
    pages, the clock advancing by STEP_DT per step. Every CHECK_EVERY-th
    K4 launch is held against the plain version on the same inputs at
    launch time. For UNTIERED sessions with a page that went to the host
    and came back, one step's output is held against attention over their
    layer-0 K/V kept aside untiered, with the pages that the launched
    table left at -1 masked as K4 masks them (the victim policy evicts
    pages of the batch being launched); the same attention with one
    restaged page's K/V swapped for another page's must fail that check
    (a control). ``small`` runs SMALL_RUN instead, the CPU rehearsal.
    Returns the run's record, with the largest K4 launch and the longest
    prefill for phase 5."""
    import numpy as np
    import torch
    from repro_torch.core.cleanup import PredictiveCleanup
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import \
        decode_attention_paged_plain
    from repro_torch.serve import ContinuousBatcher, Request, TieredKVCache

    secs = {"submit": 0.0, "prefill": 0.0, "steps": 0.0, "staging": 0.0,
            "destaging": 0.0, "checks": 0.0}
    moved = {"destaged": set(), "restaged": set(), "pages": set()}

    class Cache(TieredKVCache):
        """Times the page moves (a destage inside a stage counts once,
        under destaging) and notes the sessions whose pages moved."""

        def _destage_page(self, session_id, logical_idx):
            t0 = time.perf_counter()
            super()._destage_page(session_id, logical_idx)
            secs["destaging"] += time.perf_counter() - t0
            moved["destaged"].add(session_id)

        def _stage_page(self, session_id, logical_idx, now):
            cold = self.sessions[session_id].pages[logical_idx] < 0
            t0 = time.perf_counter()
            d0 = secs["destaging"]
            ok = super()._stage_page(session_id, logical_idx, now)
            secs["staging"] += (time.perf_counter() - t0
                                - (secs["destaging"] - d0))
            if ok and cold:
                moved["restaged"].add(session_id)
                moved["pages"].add((session_id, logical_idx))
            return ok

    run = dict(SMALL_RUN) if small else dict(
        SERVE_RUN, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, layers=cfg.num_layers)
    heads, kv_heads, head_dim, layers, requests, max_new, page_size = (
        run["heads"], run["kv_heads"], run["head_dim"], run["layers"],
        run["requests"], MAX_NEW, PAGE_SIZE)
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    bf16 = torch.bfloat16
    cache = Cache(num_device_pages=run["num_device_pages"],
                  page_size=page_size,
                  num_kv_heads=kv_heads, head_dim=head_dim,
                  num_layers=layers, dtype=bf16, device=device,
                  cleanup=PredictiveCleanup(min_history=10**9,
                                            initial_bound=1e9))
    pool_bytes = 2 * cache.k_pool.numel() * cache.k_pool.element_size()
    sched = ContinuousBatcher(cache, max_batch=run["max_batch"],
                              pages_per_seq=run["pages_per_seq"])
    lo, hi = run["prompt"]
    lens = np.random.default_rng(PROMPT_SEED).integers(lo, hi + 1, requests)
    kept = {}          # session -> [layer-0 K chunks], [V chunks]
    longest = None
    for rid, plen in enumerate(lens.tolist()):
        q = torch.randn((1, plen, heads, head_dim), generator=g,
                        device=device, dtype=bf16)
        kp = torch.randn((layers, plen, kv_heads, head_dim), generator=g,
                         device=device, dtype=bf16)
        vp = torch.randn((layers, plen, kv_heads, head_dim), generator=g,
                         device=device, dtype=bf16)
        t0 = time.perf_counter()
        out = ops.flash_attention(q, kp[0][None], vp[0][None], causal=True)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs["prefill"] += time.perf_counter() - t0
        check(out.shape == q.shape and bool(torch.isfinite(out).all()),
              f"prefill {rid}: output not finite / wrong shape")
        if longest is None or plen > longest["q"].shape[1]:
            longest = {"q": q, "k": kp[0][None].clone(),
                       "v": vp[0][None].clone()}
        kept[rid] = ([kp[0].clone()], [vp[0].clone()])
        t0 = time.perf_counter()
        sched.submit(Request(request_id=rid, session_id=rid,
                             prompt_len=plen, max_new_tokens=max_new,
                             arrived_at=0.0), kp, vp, now=0.0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs["submit"] += time.perf_counter() - t0
        del q, kp, vp, out
    check(cache.stats["alloc_fail"] == 0, "a page allocation failed")
    # page moves while the prompts filled the pool, before any step
    submit_moves = {"stats": dict(cache.stats),
                    "destaging_s": secs["destaging"]}

    rec = {"launches": 0, "checked": 0, "minus_one": 0, "max_err": 0.0,
           "untiered": {}, "largest": None, "nan_rows": 0, "controls": 0}
    sids_now = []

    def q_fn(sids):
        sids_now[:] = sids
        return torch.randn((len(sids), heads, head_dim), generator=g,
                           device=device, dtype=bf16)

    def kv_fn(sids):
        k = torch.randn((len(sids), layers, kv_heads, head_dim),
                        generator=g, device=device, dtype=bf16)
        v = torch.randn((len(sids), layers, kv_heads, head_dim),
                        generator=g, device=device, dtype=bf16)
        for i, sid in enumerate(sids):
            kept[sid][0].append(k[i, 0][None])
            kept[sid][1].append(v[i, 0][None])
        return k, v

    real = ops.decode_attention_paged

    def recorded(q, kp, vp, table, seq_lens, **kw):
        out = real(q, kp, vp, table, seq_lens, **kw)
        t0 = time.perf_counter()
        n = rec["launches"]
        rec["launches"] += 1
        rec["minus_one"] += minus_one_pages(table, seq_lens, page_size)
        has_page = (table >= 0).any(1)
        rec["nan_rows"] += int((~has_page).sum())
        check(bool(torch.isfinite(out[has_page]).all()),
              f"K4 launch {n}: a row with resident pages is not finite")
        positions = resident_positions(table, seq_lens, page_size)
        if rec["largest"] is None or positions > rec["largest"]["positions"]:
            rec["largest"] = {"q": q.clone(), "table": table.clone(),
                              "lens": seq_lens.clone(),
                              "positions": positions}
        if n % CHECK_EVERY == 0:
            rec["max_err"] = max(rec["max_err"], attn_close(
                out, decode_attention_paged_plain(q, kp, vp, table,
                                                  seq_lens)))
            rec["checked"] += 1
        need = (seq_lens.long() + page_size - 1) // page_size
        for i, sid in enumerate(sids_now):
            if sid not in moved["restaged"] or sid in rec["untiered"] \
                    or len(rec["untiered"]) >= UNTIERED[1]:
                continue
            row = table[i, :int(need[i])].tolist()
            back = [li for li, pg in enumerate(row)
                    if pg >= 0 and (sid, li) in moved["pages"]]
            if not back:
                continue             # no restaged page resident here
            n_tok = int(seq_lens[i])
            k0 = torch.cat(kept[sid][0])[:n_tok]
            v0 = torch.cat(kept[sid][1])[:n_tok]
            npg = -(-n_tok // page_size)
            pad = npg * page_size - n_tok
            kpg = torch.nn.functional.pad(k0, (0, 0, 0, 0, 0, pad)) \
                .reshape(npg, page_size, kv_heads, head_dim)
            vpg = torch.nn.functional.pad(v0, (0, 0, 0, 0, 0, pad)) \
                .reshape(npg, page_size, kv_heads, head_dim)
            own = torch.tensor([li if pg >= 0 else -1
                                for li, pg in enumerate(row)],
                               dtype=torch.int32, device=device)[None]
            ref = decode_attention_paged_plain(q[i:i + 1], kpg, vpg, own,
                                               seq_lens[i:i + 1])
            rec["untiered"][sid] = attn_close(out[i:i + 1], ref)
            # control: the restaged page holding another page's K/V
            li, other = back[0], (back[0] + 1) % npg
            kpg[li], vpg[li] = kpg[other].clone(), vpg[other].clone()
            must_fail(f"session {sid}'s restaged page {li} holding page "
                      f"{other}'s K/V", lambda: attn_close(
                          out[i:i + 1], decode_attention_paged_plain(
                              q[i:i + 1], kpg, vpg, own, seq_lens[i:i + 1])))
            rec["controls"] += 1
        secs["checks"] += time.perf_counter() - t0
        return out

    ops.decode_attention_paged = recorded
    now, steps = 1.0, 0
    t0 = time.perf_counter()
    try:
        # each batch of max_batch requests takes MAX_NEW steps; twice that
        # bounds a run whose batches do not fill
        limit = 2 * MAX_NEW * -(-requests // run["max_batch"])
        while len(sched.completed) < requests and steps < limit:
            sched.step(q_fn, kv_fn, now=now)
            now += STEP_DT
            steps += 1
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        ops.decode_attention_paged = real
    secs["steps"] = time.perf_counter() - t0
    tokens = sum(r.generated for r in sched.completed)
    check(len(sched.completed) == requests
          and all(r.generated == max_new for r in sched.completed),
          f"{len(sched.completed)}/{requests} requests completed")
    check(cache.stats["staged"] > 0 and cache.stats["destaged"] > 0,
          f"no page moved between the tiers: {cache.stats}")
    check(len(rec["untiered"]) >= UNTIERED[0],
          f"only {len(rec['untiered'])} restaged sessions were held "
          "against their untiered K/V")
    decode_s = secs["steps"] - secs["checks"]
    return {
        "requests": requests, "steps": steps, "tokens": tokens,
        "prompt_tokens": int(lens.sum()), "tokens_per_s": tokens / decode_s,
        "decode_s": decode_s, "seconds": secs, "stats": dict(cache.stats),
        "pool_bytes": pool_bytes, "k4_launches_checked": rec["checked"],
        "k4_max_err": rec["max_err"], "minus_one_pages_read":
        rec["minus_one"], "rows_without_pages": rec["nan_rows"],
        "untiered_max_err": rec["untiered"],
        "controls_rejected": rec["controls"],
        "submit_moves": submit_moves,
        "sessions_moved": {k: len(moved[k])
                           for k in ("destaged", "restaged")},
        "largest_k4": rec["largest"], "longest_prefill": longest,
        "cache": cache}


def _sdpa_ms(q, k, v, iters: int, **kw) -> float:
    """One ``scaled_dot_product_attention`` call on [B, H, S, D] inputs
    (a yardstick only: the port never calls it)."""
    import torch.nn.functional as F
    return _sync_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw), iters)


def k4_record(cache, launch: dict, iters: int) -> dict:
    """Phase 5 for K4: replay the largest launch of phase 4 on the pool,
    hold it (on its split-KV design, on that design with one split per
    sequence, and on its earlier CUDA-core design) against the fp32 plain
    version on the same bf16 inputs, time each beside the plain version
    (on the bf16 inputs), SDPA over K/V gathered into contiguous padded
    tensors (gather excluded) and its bound."""
    import torch
    dec = importlib.import_module("repro_torch.kernels.decode_attention")
    q, table, lens = launch["q"], launch["table"], launch["lens"]
    kp, vp = cache.k_pool[0], cache.v_pool[0]
    b, h, d = q.shape
    _, page, hkv, _ = kp.shape
    pps = table.shape[1]
    check(dec.decode_design(q.dtype, d, h // hkv) == "split_kv",
          "K4's replay does not take the split-KV design")
    per, n_split = dec.split_plan(page, pps)
    # the plan's split length, a sweep around it, one split per row
    variants = {"split_kv": dict(), "one_split": dict(pages_per_split=pps),
                "cuda_core": dict(design="cuda_core"),
                **{f"pages_per_split={n}": dict(pages_per_split=n)
                   for n in (8, 16, 64) if n != per}}
    ref = dec.decode_attention_paged_plain(q.float(), kp.float(), vp.float(),
                                           table, lens)
    errs = {k: attn_close(dec.decode_attention_paged_cuda(
        q, kp, vp, table, lens, **kw), ref) for k, kw in variants.items()}
    err = max(errs.values())
    # control: the kernel with one resident page of one row dropped
    row = int(torch.argmax(lens))
    need = -(-int(lens[row]) // kp.shape[1])
    resident = torch.nonzero(table[row, :need] >= 0).flatten().tolist()
    col = resident[len(resident) // 2]
    dropped = table.clone()
    dropped[row, col] = -1
    must_fail(f"row {row} without its page {col}", lambda: attn_close(
        dec.decode_attention_paged_cuda(q, kp, vp, dropped, lens), ref))
    del ref, dropped
    # SDPA's inputs: the table's pages gathered contiguously, masked like K4
    safe = table.long().clamp(min=0)
    kg = kp[safe].reshape(b, pps * page, hkv, d).transpose(1, 2).contiguous()
    vg = vp[safe].reshape(b, pps * page, hkv, d).transpose(1, 2).contiguous()
    pos = torch.arange(pps * page, device=q.device)
    mask = ((pos[None, :] < lens.long()[:, None])
            & torch.repeat_interleave(table >= 0, page, dim=1))[:, None, None]
    positions = launch["positions"]
    nbytes = (2 * positions * hkv * d * 2 + 2 * q.numel() * 2
              + table.numel() * 4 + lens.numel() * 4)
    ops_ = 4 * positions * h * d
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / BF16_OPS_PER_S * 1e3
    ms = {k: _sync_time_ms(lambda: dec.decode_attention_paged_cuda(
        q, kp, vp, table, lens, **kw), iters) for k, kw in variants.items()}
    r = dict(max_abs_err=err, errs=errs, ms=ms["split_kv"],
             earlier_ms=ms["cuda_core"], one_split_ms=ms["one_split"],
             pages_per_split=per, n_split=n_split, sweep_ms={
                 k: v for k, v in ms.items() if k.startswith("pages_")},
             # the bytes the bound counts over each design's time
             tb_per_s={k: nbytes / (v * 1e-3) / 1e12 for k, v in ms.items()},
             plain_ms=_sync_time_ms(lambda: dec.decode_attention_paged_plain(
                 q, kp, vp, table, lens), max(iters // 5, 1)),
             bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o
             else "operations",
             library_ms=_sdpa_ms(q[:, :, None], kg, vg, iters,
                                 attn_mask=mask),
             shape=(f"q [{b}, {h}, {d}], pool [{kp.shape[0]}, {page}, {hkv}, "
                    f"{d}] bf16, table [{b}, {pps}], {positions} resident "
                    f"positions (sum of seq_lens {int(lens.sum())}), "
                    f"{minus_one_pages(table, lens, page)} -1 pages inside "
                    f"seq_len, {n_split} splits of {per} pages"))
    del kg, vg, mask
    return r


def _attended_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep: the work this input needs."""
    total = 0
    for qi in range(sq):
        hi = min(sk, qi + 1) if causal else sk
        lo = max(0, qi - window + 1) if window > 0 else 0
        total += max(hi - lo, 0)
    return total


def k5_record(q, k, v, causal: bool, window: int, iters: int) -> dict:
    """Phase 5 for K5 on one input: the wgmma design (o and lse) against
    the fp32 plain version on the same bf16 inputs (``flash_close``), the
    same with its last key tile dropped as a control that must read at
    least CONTROL_FACTOR times the limit, and the CUDA-core design on the
    float32 values against the plain version in float32; timed beside the
    earlier CUDA-core design on the bf16 inputs, the plain version (on the
    bf16 inputs), SDPA and its bound."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    FL = flash_limits()
    tiles = importlib.import_module("repro_torch.kernels.flash_tiles")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window)
    check(tiles.design(q.dtype, d) == "wgmma", "K5's replay is not bf16 at "
                                              "a wgmma head dim")
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    q32, k32, v32 = q.float(), k.float(), v.float()
    ro, rlse = fa.flash_attention_plain(q32, k32, v32, return_lse=True, **kw)
    r = flash_close(o, ro, FL.FWD_ROW_RTOL, ATTN_ULP_FLOOR)
    r["lse_err"] = lse_close(lse, rlse)
    cut = sk - tiles.FWD_TILES[1]
    dropped = fa.flash_attention_cuda(q, k[:, :cut].contiguous(),
                                      v[:, :cut].contiguous(), **kw)
    r["control_ratio"] = control_reads(
        f"K5 with keys {cut}-{sk - 1} (its last key tile) dropped",
        FL.row_error(dropped, ro), FL.FWD_ROW_RTOL)
    del o, lse, ro, rlse, dropped
    o32, l32 = fa.flash_attention_cuda(q32, k32, v32, return_lse=True, **kw)
    ro32, rl32 = fa.flash_attention_plain(q32, k32, v32, return_lse=True,
                                          **kw)
    r["fp32_err"] = fp32_close(o32, ro32, FP32_ATTN_TOL)
    fin = torch.isfinite(rl32)
    r["fp32_lse_err"] = float((l32[fin] - rl32[fin]).abs().max())
    check(torch.equal(torch.isinf(l32), torch.isinf(rl32))
          and r["fp32_lse_err"] <= FP32_LSE_TOL,
          f"float32 lse: {r['fp32_lse_err']} beyond {FP32_LSE_TOL}")
    del q32, k32, v32, o32, l32, ro32, rl32
    pairs = _attended_pairs(sq, sk, causal, window) * b * h
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * sq
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 4 * pairs * d / BF16_OPS_PER_S * 1e3
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window > 0:
        pos = torch.arange(sq, device=q.device)
        band = (pos[:, None] - pos[None, :] < window) \
            & (pos[:, None] >= pos[None, :])
        lib = _sdpa_ms(qt, kt, vt, iters, attn_mask=band)
    else:
        lib = _sdpa_ms(qt, kt, vt, iters, is_causal=causal)
    r.update(ms=_sync_time_ms(lambda: fa.flash_attention_cuda(
                 q, k, v, **kw), iters),
             earlier_ms=_sync_time_ms(lambda: fa.flash_attention_cuda(
                 q, k, v, design="cuda_core", **kw), max(iters // 5, 1)),
             plain_ms=_sync_time_ms(lambda: fa.flash_attention_plain(
                 q, k, v, **kw), max(iters // 5, 1)),
             bound_ms=max(t_b, t_o),
             bound_by="bytes" if t_b >= t_o else "operations",
             library_ms=lib,
             shape=(f"q [{b}, {sq}, {h}, {d}], k/v [{b}, {sk}, {hkv}, {d}] "
                    f"bf16, causal={causal}, window={window}, "
                    f"{pairs} attended pairs"))
    del qt, kt, vt
    return r


# --------------------------------------------------------------- phases 6-8
TRAIN_ARCH = "starcoder2-7b"
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
#: K6: its name, and the TPU kernel it replaces
K6 = ("flash_bwd_wgmma (K6, flash attention backward)",
      "src/repro/kernels/flash_attention_bwd.py:112")
#: phase 6: TRAIN_ARCH at full width with 8 of its layers, six steps of
#: 2 x 4,096 tokens (6b) after a gradient check on 1 x 1,024 (6a)
TRAIN_RUN = dict(layers=8, batch=2, seq=4096, steps=6, grad_seq=1024)
#: its CPU rehearsal (``run_train(..., small=True)``, reduced widths)
SMALL_TRAIN = dict(layers=2, batch=2, seq=128, steps=3, grad_seq=64)
#: phase 7: the entry point at its default config, run to FIRST steps,
#: then asked for SECOND (it must resume from the first run's last save)
ENTRY_RUN = dict(first=4, second=8, save_every=2)
#: 6a: the loss and every parameter's gradient through K5/K6 against the
#: same through their plain versions (same weights, same batch): each
#: gradient within GRAD_RTOL of its norm, the loss within LOSS_TOL. K5
#: and K6 (bf16 at head dim 128: the wgmma design) round P and dS to bf16
#: as the Pallas kernels do, the plain versions only their outputs, and
#: eight layers of bf16 matmuls carry the difference into the loss and
#: the parameters' gradients: on an H100 the worst reading was 2.30% of
#: the norm (layers.6.attn.k.b) and the loss moved by 9.35e-5 (2.05% and
#: 1.6e-5 with the all-fp32 CUDA-core kernels), while the control (one
#: query tile of 64 rows' dq zeroed) moves layers.7.attn.q.w by 50.005%.
GRAD_RTOL = 0.05
LOSS_TOL = 1e-4
#: K6's elementwise check counts magnitudes below GRAD_ULP_FLOOR x the
#: tensor's largest |value| as that floor (gradients of a mean loss are
#: small, so the floor is relative where ATTN_ULP_FLOOR is absolute)
GRAD_ULP_FLOOR = 2.0 ** -10


def k6_wrapper():
    return importlib.import_module(
        "repro_torch.kernels.flash_attention_bwd").flash_attention_bwd_cuda


def grads_rel(got, want) -> tuple:
    """The worst gradient's distance from the plain versions' in units of
    its norm, and its name."""
    import torch
    worst, name = 0.0, None
    for n, w in want[1].items():
        check(bool(torch.isfinite(got[1][n]).all()),
              f"{n}: gradient not finite")
        rel = float(torch.linalg.vector_norm((got[1][n] - w).float())
                    / torch.linalg.vector_norm(w.float()).clamp(min=1e-30))
        if rel >= worst:
            worst, name = rel, n
    return worst, name


def grads_close(got, want) -> dict:
    """(loss, grads) of the kernels' path against the plain versions':
    the loss within LOSS_TOL, each gradient within GRAD_RTOL of its norm.
    Returns the readings."""
    (lk, _), (lp, _) = got, want
    loss_err = abs(lk - lp)
    check(math.isfinite(lk) and loss_err <= LOSS_TOL,
          f"loss {lk} against {lp}: beyond {LOSS_TOL}")
    worst, name = grads_rel(got, want)
    check(worst <= GRAD_RTOL, f"the gradient of {name} is off by "
                              f"{worst:.3g} of its norm, beyond {GRAD_RTOL}")
    return {"loss": lk, "loss_err": loss_err, "grad_rel_err": worst,
            "worst_param": name}


def build_train(device, cfg, *, small: bool = False):
    """The model of phase 6: ``cfg`` with TRAIN_RUN's depth (SMALL_TRAIN's
    for the CPU rehearsal), its parameters drawn from a seeded
    generator."""
    import torch
    from repro_torch.models import build_model
    run = SMALL_TRAIN if small else TRAIN_RUN
    model = build_model(dataclasses.replace(cfg, num_layers=run["layers"]),
                        device=device)
    params = model.init(torch.Generator(device).manual_seed(SEED + 6))
    return model, params, run


def grad_check(model, params, run: dict) -> dict:
    """6a: one loss and backward on 1 x grad_seq tokens through K5/K6, the
    same with the attention's plain versions, held together by
    ``grads_close``; then, as a control that must read at least
    CONTROL_FACTOR times GRAD_RTOL, the kernels' path with K6's dq of its
    first launch's first query tile zeroed (the last layer's, whose
    backward runs first)."""
    import torch
    from repro_torch.data.generators import token_batches
    from repro_torch.kernels import ops
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = model.device
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(token_batches(
        model.cfg.vocab_size, 1, run["grad_seq"], seed=SEED + 6)).items()}

    def grads():
        loss, _ = model.loss(params, batch)
        g = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, g))

    t0 = time.perf_counter()
    kernel = grads()
    real_vjp, real_bwd = ops.flash_attention_vjp, fa.flash_attention_bwd_cuda
    ops.flash_attention_vjp = functools.partial(real_vjp, backend="ref")
    try:
        plain = grads()
    finally:
        ops.flash_attention_vjp = real_vjp
    rec = grads_close(kernel, plain)
    zeroed = []

    def zero_first_tile(*args, **kw):
        dq, dk, dv = real_bwd(*args, **kw)
        if not zeroed:
            dq[:, :64] = 0
            zeroed.append(True)
        return dq, dk, dv

    fa.flash_attention_bwd_cuda = zero_first_tile
    try:
        bad = grads()
    finally:
        fa.flash_attention_bwd_cuda = real_bwd
    worst, name = grads_rel(bad, plain)
    rec["control_ratio"] = control_reads(
        f"K6's dq of the last layer's first query tile zeroed ({name})",
        worst, GRAD_RTOL)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def train_run(model, params, run: dict) -> dict:
    """6b: ``make_train_step`` for run["steps"] steps on ``token_batches``
    through ``PrefetchPipeline``; the loss must be finite at every step.
    Each step's forward (``model.loss``), backward (to the optimizer) and
    optimizer (``adamw_update``) are timed on the device's clock (CUDA
    events; the host's on the CPU). K6's first launch is kept for
    phase 8."""
    import torch
    from repro_torch.data.generators import token_batches
    from repro_torch.data.pipeline import PrefetchPipeline
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import train_step as ts_mod
    from repro_torch.train.optimizer import adamw_init
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = model.device
    cuda = dev.type == "cuda"

    def stamp():
        if not cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def span(a, b) -> float:
        return (b - a) if not cuda else a.elapsed_time(b) / 1e3

    marks, kept = [], {}
    real_loss, real_update, real_bwd = (model.loss, ts_mod.adamw_update,
                                        fa.flash_attention_bwd_cuda)

    def timed_loss(*a, **kw):
        marks.append(stamp())
        out = real_loss(*a, **kw)
        marks.append(stamp())
        return out

    def timed_update(*a, **kw):
        marks.append(stamp())
        out = real_update(*a, **kw)
        marks.append(stamp())
        return out

    def keep_first(q, k, v, o, do, lse, **kw):
        if not kept:
            kept.update(args=tuple(t.detach().clone()
                                   for t in (q, k, v, o, do, lse)), kw=kw)
        return real_bwd(q, k, v, o, do, lse, **kw)

    state = ts_mod.TrainState(params=params, opt=adamw_init(params))
    step_fn = make_train_step(model, OptConfig(
        warmup_steps=1, total_steps=run["steps"]))
    data = PrefetchPipeline(token_batches(model.cfg.vocab_size, run["batch"],
                                          run["seq"], seed=SEED + 7),
                            depth=2, device=dev)
    model.loss, ts_mod.adamw_update = timed_loss, timed_update
    fa.flash_attention_bwd_cuda = keep_first
    losses, wall, parts = [], [], []
    try:
        for _ in range(run["steps"]):
            marks.clear()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, next(data))
            losses.append(float(metrics["loss"]))
            if cuda:
                torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            f0, f1, u0, u1 = marks
            parts.append((span(f0, f1), span(f1, u0), span(u0, u1)))
            check(math.isfinite(losses[-1]),
                  f"step {len(losses)}: loss {losses[-1]} is not finite")
    finally:
        model.loss = real_loss
        ts_mod.adamw_update = real_update
        fa.flash_attention_bwd_cuda = real_bwd
        data.close()
    tokens = run["batch"] * run["seq"]
    timed = wall[1:] or wall
    return {"losses": losses, "step_s": wall,
            "tokens_per_s": tokens * len(timed) / sum(timed),
            "forward_s": [p[0] for p in parts],
            "backward_s": [p[1] for p in parts],
            "optimizer_s": [p[2] for p in parts],
            "grad_norm": float(metrics["grad_norm"]), "largest_k6": kept}


def run_entry(device, tmp_root: Path) -> dict:
    """Phase 7: ``launch.train`` at its default config (reduced
    TRAIN_ARCH, as the CLI always trains) to ENTRY_RUN["first"] steps with
    checkpoints, then asked for ENTRY_RUN["second"]: it must resume from
    LATEST with the first run's final parameters bit for bit, and neither
    run may restart (``RestartManager`` restarts on any exception, which
    would hide a kernel fault)."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as LT
    cfg = reduced(get_config(TRAIN_ARCH))
    ckpt = Path(tempfile.mkdtemp(prefix="ckpt_", dir=tmp_root))
    kw = dict(ckpt_dir=ckpt, save_every=ENTRY_RUN["save_every"],
              log_every=1, device=device)
    first = LT.train(cfg, steps=ENTRY_RUN["first"], **kw)
    saved = {n: p.detach().clone() for n, p in first["state"].params.items()}
    seen = {}
    real = LT.restore_checkpoint

    def spy(path, like):
        out = real(path, like)
        seen.update({n: p.detach().clone() for n, p in out.params.items()})
        return out

    LT.restore_checkpoint = spy
    try:
        second = LT.train(cfg, steps=ENTRY_RUN["second"], **kw)
    finally:
        LT.restore_checkpoint = real
    check(first["restarts"] == 0 and second["restarts"] == 0,
          f"restarts {first['restarts']}, {second['restarts']}: a step "
          "raised inside RestartManager")
    check(second["resumed_from"] == ENTRY_RUN["first"],
          f"resumed from {second['resumed_from']}")
    check(set(seen) == set(saved) and all(
        torch.equal(seen[n], saved[n]) for n in saved),
        "the restored parameters are not the saved ones bit for bit")
    losses = first["losses"] + second["losses"]
    check(len(losses) == ENTRY_RUN["second"] and all(
        math.isfinite(x) for x in losses), f"losses {losses}")
    check(second["last_saved_step"] == ENTRY_RUN["second"],
          f"last save at {second['last_saved_step']}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"config": cfg.name, "losses": losses,
            "resumed_from": second["resumed_from"],
            "restarts": first["restarts"] + second["restarts"],
            "params": sum(p.numel() for p in saved.values())}


def _sdpa_bwd_ms(q, k, v, do, iters: int, **kw) -> float:
    """The backward of one ``scaled_dot_product_attention`` call on the
    same inputs in [B, H, S, D] (a yardstick only: the port never calls
    it)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)
    dot = do.transpose(1, 2).contiguous()
    ms = _sync_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters)
    del out
    return ms


def rounded_twin_bwd(q, k, v, o, do, lse, *, causal: bool, window: int):
    """The Pallas backward's rounding in plain float32 torch (a
    measurement, not an oracle): ``flash_attention_bwd_plain`` with p and
    ds rounded to bf16 before their products, the GQA group summed in
    float32. Its distance from the oracle is the error that the TPU
    kernel's function itself makes on these inputs."""
    import torch
    ref = importlib.import_module("repro_torch.kernels.ref")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    rnd = lambda t: t.bfloat16().float()          # noqa: E731
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.reshape(b, sq, hkv, g, d), do.reshape(b, sq, hkv, g, d)
    delta = (dof * o.reshape(b, sq, hkv, g, d)).sum(-1)
    lsef = lse.reshape(b, hkv, g, sq)
    mask = ref._mask(sq, sk, causal, window, q.device)
    dq = torch.empty((b, sq, hkv, g, d), device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(hkv):
        s_ = torch.einsum("bqgd,bkd->bgqk", qf[:, :, j], k[:, :, j]) * scale
        p = torch.where(mask, torch.exp(s_ - lsef[:, j, :, :, None]), 0.0)
        dp = torch.einsum("bqgd,bkd->bgqk", dof[:, :, j], v[:, :, j])
        ds = torch.where(mask, p * (dp - delta[:, :, j].transpose(1, 2)
                                    [..., None]), 0.0)
        del s_, dp
        p, ds = rnd(p), rnd(ds)
        dq[:, :, j] = torch.einsum("bgqk,bkd->bqgd", ds, k[:, :, j]) * scale
        dk[:, :, j] = torch.einsum("bgqk,bqgd->bkd", ds, qf[:, :, j]) * scale
        dv[:, :, j] = torch.einsum("bgqk,bqgd->bkd", p, dof[:, :, j])
        del p, ds
    return dq.reshape(b, sq, h, d), dk, dv


def k6_record(q, k, v, o, do, lse, causal: bool, window: int,
              iters: int) -> dict:
    """Phase 8 for one K6 input: dq, dk and dv of the wgmma design against
    the plain version on the float32 values of the same inputs
    (``flash_close``); as a control, K6 with the last key tile of its dq
    pass dropped must read at least CONTROL_FACTOR times the limit; the
    CUDA-core design on the float32 values against the plain version
    within FP32_GRAD_TOL; timed beside the earlier CUDA-core design on the
    bf16 inputs, the plain version, the backward of SDPA, K5 on the same
    q/k/v, and the bound."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fb = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
    FL = flash_limits()
    tiles = importlib.import_module("repro_torch.kernels.flash_tiles")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kw = dict(causal=causal, window=window)
    check(tiles.design(q.dtype, d) == "wgmma", "K6's replay is not bf16 at "
                                              "a wgmma head dim")
    wide = tuple(x.float() for x in (q, k, v, o, do))
    got = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    check(all(bool(torch.isfinite(x).all()) for x in got),
          "a gradient is not finite")
    want = fb.flash_attention_bwd_plain(*wide, lse, **kw)
    reads = [flash_close(a, w, FL.BWD_ROW_RTOL,
                         max(float(w.abs().max()), 1e-30) * GRAD_ULP_FLOOR)
             for a, w in zip(got, want)]
    r = {key: max(x[key] for x in reads)
         for key in ("max_abs_err", "row_err", "ulps")}
    r["row_err_by_output"] = dict(zip(("dq", "dk", "dv"),
                                      (x["row_err"] for x in reads)))
    r["twin_row_err"] = dict(zip(("dq", "dk", "dv"), (
        FL.row_error(a, w) for a, w in zip(
            rounded_twin_bwd(*wide, lse, **kw), want))))
    cut = sk - tiles.DQ_TILES[1]
    dropped = fb.flash_attention_bwd_cuda(q, k[:, :cut].contiguous(),
                                          v[:, :cut].contiguous(), o, do,
                                          lse, **kw)[0]
    r["control_ratio"] = control_reads(
        f"K6's dq with keys {cut}-{sk - 1} dropped",
        FL.row_error(dropped, want[0]), FL.BWD_ROW_RTOL)
    del got, want, dropped
    # device time of each of K6's three passes, from one profiled launch
    _, rows = device_profile(lambda: fb.flash_attention_bwd_cuda(
        q, k, v, o, do, lse, **kw))
    r["passes_ms"] = {name: sum(us for us, _, key in rows if tag in key) / 1e3
                      for name, tag in (("prep", "bwd_prep"),
                                        ("dq", "bwd_dq"),
                                        ("dk/dv", "bwd_dkv"))}
    got32 = fb.flash_attention_bwd_cuda(*wide, lse, **kw)
    want32 = fb.flash_attention_bwd_plain(*wide, lse, **kw)
    r["fp32_err"] = max(fp32_close(a, w, FP32_GRAD_TOL)
                        for a, w in zip(got32, want32))
    del wide, got32, want32
    pairs = _attended_pairs(sq, sk, causal, window) * b * h
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 10 * pairs * d / BF16_OPS_PER_S * 1e3
    if window > 0:
        pos = torch.arange(sq, device=q.device)
        band = (pos[:, None] - pos[None, :] < window) \
            & (pos[:, None] >= pos[None, :])
        lib = _sdpa_bwd_ms(q, k, v, do, iters, attn_mask=band)
    else:
        lib = _sdpa_bwd_ms(q, k, v, do, iters, is_causal=causal)
    r.update(
        ms=_sync_time_ms(lambda: fb.flash_attention_bwd_cuda(
            q, k, v, o, do, lse, **kw), iters),
        earlier_ms=_sync_time_ms(lambda: fb.flash_attention_bwd_cuda(
            q, k, v, o, do, lse, design="cuda_core", **kw), 1),
        plain_ms=_sync_time_ms(lambda: fb.flash_attention_bwd_plain(
            q, k, v, o, do, lse, **kw), 1),
        k5_ms=_sync_time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, **kw), iters),
        bound_ms=max(t_b, t_o),
        bound_by="bytes" if t_b >= t_o else "operations", library_ms=lib,
        shape=(f"q/o/do [{b}, {sq}, {h}, {d}], k/v [{b}, {sk}, {hkv}, {d}] "
               f"bf16, causal={causal}, window={window}, {pairs} attended "
               f"pairs"))
    return r


# --------------------------------------------------------------- phases 9-11
SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "hymba-1.5b"
#: K7's tensor-core design, which every bf16 launch of the main paths
#: takes; SSD_SOURCE keeps its earlier CUDA-core design, for float32
SSD_TENSOR_SOURCE = "src/repro_torch/kernels/csrc/ssd_hopper.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
#: K7: its name, and the TPU kernel it replaces
K7 = ("ssd_tensor (K7, SSD chunk scan)", "src/repro/kernels/ssd_scan.py:66")
#: phase 9: SSM_ARCH at full width and depth. 9a: the prefill_32k cell's
#: prompt length with its batch of 32 cut to 4, then 32 decode steps; 9b:
#: prefill + one decode against a longer prefill, and a streaming prefill
#: in chunks of ``chunk`` against the whole one; 9c: long_500k's prompt cut
#: to a quarter, streamed, then 16 decode steps
SSM_RUN = dict(batch=4, seq=32768, decode=32, check_batch=2,
               check_seq=4096, stream_seq=16384, chunk=4096,
               control_seq=4096, control_chunk=256, long_seq=131072,
               long_decode=16)
#: phase 10: HYBRID_ARCH at full width and depth: 4 prompts of 4,096
#: tokens (a multiple of its 1,024 window, so that the ring is aligned:
#: ROADMAP Queue 3), 32 decode steps with the 16-bit and the int8 cache,
#: and prefill + one decode of 2 x 4,096 against a prefill of 4,097
HYBRID_RUN = dict(batch=4, seq=4096, decode=32, check_batch=2)
#: prefill + decode, and the streaming prefill, against the whole prefill,
#: by compute type: the logits' largest difference within ``logits`` (and
#: in float32 their argmax equal); every layer's SSM state within
#: ``state`` of its largest |value| and its conv tail within ``conv``. In
#: bf16 two prefills that differ only in the order of their sums (cuBLAS
#: on 16,384 rows or on 4,096) part by as much as a dropped state moves
#: them after 48 layers (readings 0.1493 and 0.1685 in the logits, 7.8%
#: in a state, 0.156 in a conv tail), and rounding alone flips the argmax
#: of 8% of this random model's decode positions (phase 10: its top two
#: logits over 32,001 tokens lie about 0.2 apart): the bf16 limits are
#: about three times those readings, with no argmax check, and the
#: argmax checks and the control that must be rejected run in float32
#: compute, where the same readings are 2.8e-5 in the logits.
LIMITS = {"bfloat16": dict(logits=0.5, state=0.25, conv=0.5, argmax=False),
          "float32": dict(logits=1e-2, state=1e-3, conv=1e-3, argmax=True)}
#: K7's final state against the plain version's on the same inputs,
#: relative to its largest |value|
K7_STATE_RTOL = 1e-4
#: K7 in float32 against the plain version on the same inputs, y and the
#: final state alike: within K7_FP32_RTOL x |plain| + K7_FP32_RTOL x the
#: largest |plain| (the float32 rule of ``tests/test_torch_ssd_gpu.py``)
K7_FP32_RTOL = 1e-4
#: the int8 cache's decode logits against the 16-bit cache's, by the JAX
#: int8 test's rules (``test_models_smoke.py``): every logit within
#: INT8_ATOL + INT8_RTOL x |logit|, and the argmaxes equal on INT8_AGREE
#: of the positions. The argmax rule holds in float32 compute (the
#: 16-bit cache float32 there), where only the quantization differs: in
#: bf16, rounding alone flips 8% of this random model's argmaxes
#: (PERF.md, PR 14)
INT8_ATOL = 0.35
INT8_RTOL = 0.1
INT8_AGREE = 0.99
#: each int8 K/V vector, dequantized, against the same vector unquantized
#: (float32 compute): within half a quantization step (its scale), with
#: room for float32's rounding of x / scale and q x scale
INT8_STEP = 0.5 + 1e-3


def k7_wrapper():
    return importlib.import_module(
        "repro_torch.kernels.ssd_scan").ssd_scan_cuda


class K7Tap:
    """While entered, each call of K7's wrapper from ``models/ssm.py`` goes
    through ``fn(call_index, wrapper, *args, **kw)``. The name is replaced
    in ``models/ssm.py``, which calls it, so the wrapper's own launch
    count is untouched."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __enter__(self):
        self.mod = importlib.import_module("repro_torch.models.ssm")
        self.orig = self.mod.ssd_scan_cuda

        def tapped(*args, **kw):
            i = self.calls
            self.calls += 1
            return self.fn(i, self.orig, *args, **kw)

        self.mod.ssd_scan_cuda = tapped
        return self

    def __exit__(self, *exc):
        self.mod.ssd_scan_cuda = self.orig
        return False


class K7Timer(K7Tap):
    """Counts the calls and, on the card, keeps the device milliseconds of
    every call (CUDA events)."""

    def __init__(self):
        super().__init__(self._call)
        self.events = []

    def _call(self, i, fn, *args, **kw):
        import torch
        if not args[0].is_cuda:
            return fn(*args, **kw)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*args, **kw)
        ev[1].record()
        self.events.append(ev)
        return out

    def ms(self) -> float:
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class _Kept(Exception):
    """Ends the run of ``kept_launch`` at the launch it keeps."""


def kept_launch(run, keep: int = 0) -> dict:
    """The inputs (copies, by parameter name) of call ``keep`` of K7's
    wrapper in ``run()``, which ends right there. Run apart from the timed
    and counted runs, so that the copy weighs on none of their times,
    launches or ``max_memory_allocated``; the path is deterministic, so
    its inputs are the same as theirs."""
    import inspect
    import torch
    kept = {}

    def take(i, fn, *args, **kw):
        if i < keep:
            return fn(*args, **kw)
        a = inspect.signature(fn).bind(*args, **kw)
        a.apply_defaults()
        kept.update({k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in a.arguments.items()})
        raise _Kept

    try:
        with K7Tap(take):
            run()
    except _Kept:
        return kept
    raise SmokeFailure(f"K7's wrapper was called fewer than {keep + 1} "
                       "times")


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def _prompt(cfg, b: int, s: int, seed: int, device):
    """Prompt tokens from ``default_rng(seed)``."""
    import numpy as np
    import torch
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32, device=device)


def build_serve(device, cfg, seed: int, **kw):
    """``cfg``'s model on ``device`` with fp32 parameters from a generator
    seeded with ``seed``."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, device=device, **kw)
    return model, model.init(torch.Generator(device).manual_seed(seed))


def decode_loop(step, params, tok, cache, n: int):
    """``n`` greedy steps from ``tok``. Returns the outputs and the
    cache."""
    out = []
    for _ in range(n):
        tok, cache = step(params, tok, cache)
        out.append(tok)
    return out, cache


def ssm_serve(model, params, run: dict, seed: int) -> dict:
    """9a: ``make_prefill_step`` on run's batch x seq tokens, then its
    decode steps through ``make_decode_step``; the device time of K7's
    launches summed."""
    import torch
    from repro_torch.serve import make_decode_step, make_prefill_step
    cfg, dev = model.cfg, model.device
    b, s, n = run["batch"], run["seq"], run["decode"]
    toks = _prompt(cfg, b, s, seed, dev)
    prefill = make_prefill_step(model, max_len=s + n)
    _sync(dev)
    t0 = time.perf_counter()
    with K7Timer() as timer:
        tok, cache = prefill(params, {"tokens": toks})
        _sync(dev)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, cache = decode_loop(make_decode_step(model), params, tok, cache, n)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    ids = torch.cat([tok, *out], dim=1)
    check(tuple(ids.shape) == (b, n + 1) and bool((ids >= 0).all())
          and bool((ids < cfg.vocab_size).all()),
          "9a: generated ids outside the vocabulary")
    check(bool(torch.isfinite(cache["layers"]["ssm"]).all()),
          "9a: non-finite SSM state")
    check(int(cache["pos"]) == s + n, "9a: the cache's position is off")
    return dict(prefill_s=prefill_s, prefill_tokens_per_s=b * s / prefill_s,
                decode_s=decode_s, decode_tokens_per_s=b * n / decode_s,
                k7_calls=timer.calls,
                k7_ms=timer.ms() if dev.type == "cuda" else None,
                sample=ids[0, :16].tolist(),
                largest=lambda: kept_launch(lambda: prefill(
                    params, {"tokens": toks})))


def logits_close(got, want, vocab: int, dtype: str) -> float:
    """The largest logit difference within the limit of ``dtype`` (the
    compute type), and in float32 the same argmax in every row. Returns
    that difference."""
    import torch
    lim = LIMITS[dtype]
    a, b = got[..., :vocab].float(), want[..., :vocab].float()
    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
          f"logits: shape {tuple(a.shape)} / {tuple(b.shape)} or not finite")
    err = float((a - b).abs().max())
    same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    check((same or not lim["argmax"]) and err <= lim["logits"],
          f"logits ({dtype}): argmax equal {same}, max error {err} (limit "
          f"{lim['logits']})")
    return err


def cache_diff(got: dict, want: dict) -> dict:
    """The worst layer's SSM state difference over its largest |value|,
    and the worst conv tail difference."""
    worst = {"ssm": 0.0, "conv": 0.0}
    for name in ("ssm", "conv_x", "conv_b", "conv_c"):
        a, b = got[name].float(), want[name].float()
        check(a.shape == b.shape, f"{name}: shape differs")
        key = "ssm" if name == "ssm" else "conv"
        for i in range(a.shape[0]):
            d = float((a[i] - b[i]).abs().max())
            if name == "ssm":
                d /= max(float(b[i].abs().max()), 1e-30)
            worst[key] = max(worst[key], d)
    return worst


def float32_twin(model, **kw):
    """``model``'s config in float32 compute, on its device (``kw`` to
    ``build_model``): the same parameters run through it."""
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(model.cfg,
                                           compute_dtype="float32"),
                       device=model.device, **kw)


def prefill_then_decode(model, params, b: int, s: int, seed: int) -> dict:
    """Prefill of b x s tokens, one decode step of token s + 1, against
    the last logits of the prefill of all s + 1 tokens, in the model's
    compute type and in float32, each within its limits. Returns the
    largest logit difference by compute type."""
    r = {}
    for m in (model, float32_twin(model)):
        v, dt = m.cfg.vocab_size, m.cfg.compute_dtype
        toks = _prompt(m.cfg, b, s + 1, seed, m.device)
        whole, _ = m.prefill(params, {"tokens": toks}, max_len=s + 2)
        _, cache = m.prefill(params, {"tokens": toks[:, :s]},
                             max_len=s + 1)
        got, _ = m.decode_step(params, toks[:, s:], cache)
        err = float((got - whole)[..., :v].abs().max())
        same = bool((got[..., :v].argmax(-1)
                     == whole[..., :v].argmax(-1)).all())
        log(f"  prefill {b} x {s} + one decode against the prefill of "
            f"{s + 1} ({dt}): max logit error {err:.4g} (|logits| up to "
            f"{float(whole[..., :v].abs().max()):.3g}), argmax equal {same}")
        r[dt] = logits_close(got, whole, v, dt)
    return r



def stream_close(model, got, want) -> dict:
    """A streaming prefill's (logits, cache) against the whole prefill's,
    within the limits of the model's compute type. Returns the
    readings."""
    v = model.cfg.vocab_size
    lim = LIMITS[model.cfg.compute_dtype]
    err = float((got[0] - want[0])[..., :v].abs().max())
    worst = cache_diff(got[1]["layers"], want[1]["layers"])
    log(f"    {model.cfg.compute_dtype}: max logit error {err:.4g}, SSM "
        f"states {worst['ssm']:.3g} of their largest |value|, conv tails "
        f"{worst['conv']:.3g}")
    logits_close(got[0], want[0], v, model.cfg.compute_dtype)
    check(worst["ssm"] <= lim["state"] and worst["conv"] <= lim["conv"],
          f"cache: SSM state off by {worst['ssm']:.3g} (limit "
          f"{lim['state']}), conv tails by {worst['conv']:.3g} (limit "
          f"{lim['conv']})")
    return dict(logits=err, **worst)


def ssm_checks(model, params, run: dict, seed: int) -> dict:
    """9b, in the model's bf16 and again in float32 compute (the same
    parameters): prefill + decode against the longer prefill, and the
    streaming prefill against the whole one (logits, every layer's SSM
    state and conv tail). Then, in float32, the streaming prefill of
    ``control_seq`` tokens in chunks of ``control_chunk`` against the
    whole, and as a control that must be rejected the same with K7's
    ``init_state`` dropped on its last chunk's first layer. (Over a chunk
    of 4,096 tokens the random model's slowest heads decay by exp(-8) or
    more, so a state dropped there leaves the last logits and states as
    they were: the control needs a chunk short enough for a state to
    outlive it.)"""
    cfg, dev = model.cfg, model.device
    wide = float32_twin(model)
    r = {"decode": prefill_then_decode(model, params, run["check_batch"],
                                       run["check_seq"], seed)}

    def stream(m, s: int, chunk: int, toks, tag: str, drop=None):
        log(f"  streaming prefill of 1 x {s} in chunks of {chunk} against "
            "the whole:")
        whole = m.prefill(params, {"tokens": toks}, max_len=s + 1)
        got = m.prefill_streaming(params, {"tokens": toks}, chunk=chunk)
        r[tag] = stream_close(m, got, whole)
        if drop is None:
            return

        def dropped(i, fn, *args, **kw):
            if i == drop:
                kw["init_state"] = None
            return fn(*args, **kw)

        with K7Tap(dropped):
            got = m.prefill_streaming(params, {"tokens": toks}, chunk=chunk)
        must_fail(f"the {m.cfg.compute_dtype} streaming prefill with K7's "
                  f"init_state dropped on its last chunk, layer 0",
                  lambda: stream_close(m, got, whole))

    s, chunk = run["stream_seq"], run["chunk"]
    toks = _prompt(cfg, 1, s, seed + 1, dev)
    for m in (model, wide):
        stream(m, s, chunk, toks, f"stream_{m.cfg.compute_dtype}")
    s, chunk = run["control_seq"], run["control_chunk"]
    stream(wide, s, chunk, _prompt(cfg, 1, s, seed + 2, dev),
           "stream_short_float32",
           drop=(s // chunk - 1) * cfg.num_layers)
    return r


def ssm_long(model, params, run: dict, seed: int) -> dict:
    """9c: ``prefill_streaming`` of 1 x long_seq tokens in chunks, then
    greedy decode steps. ``kept`` takes K7's launch of the second chunk's
    first layer (a carried state) for phase 11."""
    import torch
    from repro_torch.serve import make_decode_step
    cfg, dev = model.cfg, model.device
    s, chunk, n = run["long_seq"], run["chunk"], run["long_decode"]
    toks = _prompt(cfg, 1, s, seed, dev)
    _sync(dev)
    t0 = time.perf_counter()
    with K7Timer() as timer:
        logits, cache = model.prefill_streaming(params, {"tokens": toks},
                                                chunk=chunk)
        _sync(dev)
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    out, cache = decode_loop(make_decode_step(model), params, tok, cache, n)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    check(bool(torch.isfinite(cache["layers"]["ssm"]).all())
          and int(cache["pos"]) == s + n, "9c: bad cache after decoding")
    return dict(prefill_s=prefill_s, prefill_tokens_per_s=s / prefill_s,
                decode_s=decode_s, decode_tokens_per_s=n / decode_s,
                k7_calls=timer.calls,
                kept=lambda: kept_launch(lambda: model.prefill_streaming(
                    params, {"tokens": toks}, chunk=chunk),
                    keep=cfg.num_layers))


def int8_ring_close(c8: dict, ref: dict, what: str) -> float:
    """Every K/V vector of an int8 cache (``c8``: k, v and their scales),
    dequantized, within INT8_STEP quantization steps of the same vector
    unquantized in ``ref``: each ring slot written where it should be,
    each with its scale. Returns the largest error, in steps."""
    worst = 0.0
    for name in ("k", "v"):
        q, sc = c8[name], c8[name + "_scale"].float()[..., None]
        want = ref[name].float()
        check(q.shape == want.shape, f"{what}: {name} shape differs")
        err = float(((q.float() * sc - want).abs() / sc).max())
        check(err <= INT8_STEP, f"{what}: an int8 {name} vector {err:.4g} "
                                f"quantization steps from the unquantized "
                                f"one (limit {INT8_STEP})")
        worst = max(worst, err)
    return worst


def hybrid_serve(device, cfg, run: dict, seed: int) -> dict:
    """Phase 10: prefill (``make_prefill_step``) of batch x seq tokens and
    greedy decode steps (``Model.decode_step``, its logits kept) with the
    16-bit cache; then the same prompts with ``kv_cache_bits=8``, in
    float32 compute, and in float32 compute with ``kv_cache_bits=8`` (the
    same parameters), each of their steps fed the 16-bit run's token.
    The int8 runs' logits stay within the JAX int8 test's rule of their
    compute type's unquantized run's (INT8_ATOL + INT8_RTOL x |logit|);
    in float32 compute their argmaxes agree on INT8_AGREE of the
    positions, and every int8 K/V vector lies within half a quantization
    step of the float32 run's: all layers after the prefill, layer 0
    (whose K/V depend on the token alone) after the decode steps. Two
    controls must be rejected there: a ring slot's k_scale zeroed, and
    every decode step's K/V written one slot off. Returns the runs'
    records, the model and its parameters, and ``largest`` (a call that
    takes K7's first launch of the 16-bit prefill, for phase 11)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.layers import dtype_of
    from repro_torch.serve import make_prefill_step
    model, params = build_serve(device, cfg, seed)
    b, s, n = run["batch"], run["seq"], run["decode"]
    v = cfg.vocab_size
    toks = _prompt(cfg, b, s, seed + 1, device)
    r = {"model": model, "params": params}
    gen, logits, ring = {}, {}, {}
    kv = ("k", "v", "k_scale", "v_scale")
    for tag, m in (("bf16", model),
                   ("int8", build_model(cfg, kv_cache_bits=8,
                                        device=device)),
                   ("fp32", float32_twin(model)),
                   ("fp32_int8", float32_twin(model, kv_cache_bits=8))):
        _sync(device)
        t0 = time.perf_counter()
        tok, cache = make_prefill_step(m, max_len=s + n)(
            params, {"tokens": toks})
        _sync(device)
        prefill_s = time.perf_counter() - t0
        cl = cache["layers"]
        check(cl["k"].dtype == (torch.int8 if "int8" in tag
                                else dtype_of(m.cfg.compute_dtype))
              and cl["k"].shape[2] == min(s + n, cfg.attn_window),
              f"hybrid: the {tag} cache is not the window's ring")
        if tag == "fp32":
            ring["prefill"] = {k: cl[k].clone() for k in ("k", "v")}
        if tag == "fp32_int8":
            ring["int8_prefill"] = int8_ring_close(
                cl, ring["prefill"], "hybrid: the int8 prefill's ring")
            bad = dict(cl, k_scale=cl["k_scale"].clone())
            slot, layer = cl["k"].shape[2] // 3, cfg.num_layers // 2
            bad["k_scale"][layer, :, slot] = 0
            must_fail(f"the int8 prefill's ring with slot {slot}'s k_scale "
                      f"zeroed in layer {layer}",
                      lambda: int8_ring_close(bad, ring["prefill"],
                                              "the int8 ring"))
            del bad, ring["prefill"]
            first = {k: cl[k][0].clone() for k in kv}
        t0 = time.perf_counter()
        gen[tag], logits[tag] = [tok], []
        for i in range(n):
            inp = tok if tag == "bf16" else gen["bf16"][i]
            out, cache = m.decode_step(params, inp, cache)
            tok = torch.argmax(out, dim=-1).to(torch.int32)
            gen[tag].append(tok)
            logits[tag].append(out[:, 0, :v].float())
        _sync(device)
        decode_s = time.perf_counter() - t0
        r[tag] = dict(prefill_s=prefill_s,
                      prefill_tokens_per_s=b * s / prefill_s,
                      decode_s=decode_s, decode_tokens_per_s=b * n / decode_s)
        cl = cache["layers"]
        if tag == "fp32":
            ring["decode"] = {k: cl[k][0].clone() for k in ("k", "v")}
        if tag == "fp32_int8":
            last = {k: cl[k][0] for k in kv}
            ring["int8_decode"] = int8_ring_close(
                last, ring["decode"], "hybrid: layer 0's int8 ring after "
                                      "decoding")
            w0 = s % cfg.attn_window
            off = {}
            for k, t in last.items():
                off[k] = t.clone()
                off[k][:, w0 + 1:w0 + n + 1] = t[:, w0:w0 + n]
                off[k][:, w0] = first[k][:, w0]
            must_fail("layer 0's int8 ring with every decode step written "
                      "one slot off", lambda: int8_ring_close(
                          off, ring["decode"], "the int8 ring"))
        del cache, cl
    for ref, tag in (("bf16", "int8"), ("fp32", "fp32_int8")):
        check(torch.equal(gen[ref][0], gen[tag][0]),
              f"hybrid: the {tag} prefill's token differs from the {ref} "
              "one's (its prefill attends the unquantized K/V)")
    pairs = {"int8": "bf16", "fp32": "bf16", "fp32_int8": "fp32"}
    for tag, ref in pairs.items():
        want = torch.stack(logits[ref])
        diff = (torch.stack(logits[tag]) - want).abs()
        r[tag].update(
            against=ref,
            agree=float((torch.cat(gen[tag][1:], dim=1)
                         == torch.cat(gen[ref][1:], dim=1)).float().mean()),
            max_logit_diff=float(diff.max()),
            outside_jax_rule=int((diff > INT8_ATOL + INT8_RTOL
                                  * want.abs()).sum()))
        log(f"  {tag} against {ref} over {b} x {n} decode logits: argmaxes "
            f"agree on {r[tag]['agree']:.4f}, max logit difference "
            f"{r[tag]['max_logit_diff']:.4g}, {r[tag]['outside_jax_rule']} "
            f"logits outside {INT8_ATOL} + {INT8_RTOL} x |logit|")
    log(f"  the float32 int8 ring within {ring['int8_prefill']:.4g} "
        f"quantization steps after the prefill (all layers) and "
        f"{ring['int8_decode']:.4g} after decoding (layer 0); limit "
        f"{INT8_STEP}")
    for tag in ("int8", "fp32_int8"):
        check(r[tag]["outside_jax_rule"] == 0,
              f"hybrid: {tag} logits outside the JAX int8 test's rule")
    check(r["fp32_int8"]["agree"] >= INT8_AGREE,
          f"hybrid: the float32 int8 run's argmaxes agree on "
          f"{r['fp32_int8']['agree']:.4f} (limit {INT8_AGREE})")
    r["int8_ring_steps"] = {k: ring[k] for k in ("int8_prefill",
                                                 "int8_decode")}
    r["largest"] = lambda: kept_launch(lambda: make_prefill_step(
        model, max_len=s + n)(params, {"tokens": toks}))
    return r


def k7_bound(b: int, s: int, h: int, p: int, n: int, elt: int,
             with_state: bool):
    """(bound ms, what bounds it): the larger of the bytes K7 must move
    (xdt and y of ``elt`` bytes, a fp32, B and C, the states) over the
    HBM rate, and the chunked algorithm's operations at the model's chunk
    of 256 (scores 2 Q^2 n, the causal intra-chunk product Q (Q + 1) h p,
    the inter-chunk term and the state update 4 Q h p n, per chunk and
    batch row) over the bf16 tensor-core rate."""
    nbytes = (2 * b * s * h * p * elt + 4 * b * s * h + 2 * b * s * n * elt
              + 4 * b * h * p * n * (2 if with_state else 1))
    ops = 0
    for c0 in range(0, s, 256):
        q = min(256, s - c0)
        ops += 2 * q * q * n + q * (q + 1) * h * p + 4 * q * h * p * n
    ops *= b
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / BF16_OPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _k7_close(y, st, ry, rst) -> tuple:
    """y within one bf16 ulp of the plain version's, the final state
    within K7_STATE_RTOL of its largest |value|: (max |y - plain|, the
    state's error)."""
    st_err = float((st - rst).abs().max()) / max(float(rst.abs().max()),
                                                 1e-30)
    err = attn_close(y, ry)
    check(st_err <= K7_STATE_RTOL, f"K7 final state off by {st_err:.3g} of "
                                   f"its largest |value| (limit "
                                   f"{K7_STATE_RTOL})")
    return err, st_err


def k7_record(args: dict, iters: int) -> dict:
    """Phase 11 for one K7 launch, on the tensor design: y within one bf16
    ulp of the plain version's, tiled as the design tiles, on the same
    bf16 inputs (``attn_close``), the final state within K7_STATE_RTOL of
    its largest |value|; as a control that must be rejected, the launch
    without the state its inputs carry (with ``init_state`` dropped, or
    over the second half alone); each chunk the design is built for, held
    the same way against the plain version tiled by it and timed; the
    earlier CUDA-core design on the same inputs, held the same way against
    the plain version tiled by its own chunk and timed (``earlier_ms``);
    the plain version at the model's chunk of 256 and the bound."""
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    xdt, a, B, C = (args[k] for k in ("xdt", "a", "B", "C"))
    h0 = args["init_state"]
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    check(ss.ssd_design(xdt.dtype, p, n) == "tensor"
          or not xdt.is_cuda, "K7's replay does not take the tensor design")
    y, st = ss.ssd_scan_cuda(xdt, a, B, C, init_state=h0)
    # tiled another way, the plain version sums in another order, and
    # where y cancels that order moved a bf16 output of 9a's launch by
    # 1.5 ulps
    ry, rst = ss.ssd_scan_plain(xdt, a, B, C,
                                chunk=ss.kernel_chunk(xdt.dtype, p, n),
                                init_state=h0)
    log(f"  K7 on xdt {tuple(xdt.shape)}: max |y - plain| "
        f"{float((y.float() - ry.float()).abs().max()):.3g}")
    err, st_err = _k7_close(y, st, ry, rst)
    if h0 is not None:
        must_fail("K7 with its init_state dropped", lambda: attn_close(
            ss.ssd_scan_cuda(xdt, a, B, C)[0], ry))
    else:
        half = s // 2
        must_fail(f"K7 on tokens {half}-{s - 1} without the state of the "
                  f"tokens before", lambda: attn_close(
                      ss.ssd_scan_cuda(*(t[:, half:].contiguous()
                                         for t in (xdt, a, B, C)))[0],
                      ry[:, half:]))
    del y, st, ry, rst
    ey, est = ss.ssd_scan_cuda(xdt, a, B, C, init_state=h0,
                               design="cuda_core")
    ry, rst = ss.ssd_scan_plain(xdt, a, B, C,
                                chunk=ss.KERNEL_CHUNK["cuda_core"],
                                init_state=h0)
    earlier_err, earlier_st = _k7_close(ey, est, ry, rst)
    del ey, est, ry, rst
    chunks = {}
    for q in ss.TENSOR_CHUNKS:
        cy, cst = ss.tensor_scan(xdt, a, B, C, h0, chunk=q)
        qy, qst = ss.ssd_scan_plain(xdt, a, B, C, chunk=q, init_state=h0)
        q_err, q_st = _k7_close(cy, cst, qy, qst)
        del cy, cst, qy, qst
        chunks[q] = dict(max_abs_err=q_err, state_err=q_st,
                         ms=_sync_time_ms(lambda: ss.tensor_scan(
                             xdt, a, B, C, h0, chunk=q), iters))
    bound, by = k7_bound(b, s, h, p, n, xdt.element_size(), h0 is not None)
    return dict(
        max_abs_err=err, state_err=st_err,
        ms=_sync_time_ms(lambda: ss.ssd_scan_cuda(xdt, a, B, C,
                                                  init_state=h0), iters),
        earlier_ms=_sync_time_ms(lambda: ss.ssd_scan_cuda(
            xdt, a, B, C, init_state=h0, design="cuda_core"),
            max(iters // 5, 1)),
        plain_ms=_sync_time_ms(lambda: ss.ssd_scan_plain(
            xdt, a, B, C, chunk=256, init_state=h0), 1),
        bound_ms=bound, bound_by=by, library_ms=None, chunks=chunks,
        earlier_max_abs_err=earlier_err, earlier_state_err=earlier_st,
        shape=(f"xdt [{b}, {s}, {h}, {p}] {str(xdt.dtype)[6:]}, a "
               f"[{b}, {s}, {h}] fp32, B/C [{b}, {s}, {n}], init_state "
               f"{'carried' if h0 is not None else 'none'}"))


def k7_fp32_record(args: dict, iters: int) -> dict:
    """Phase 11 for K7 in float32, the type the float32-compute runs of
    phases 9b and 10 give it: one launch's inputs cast to float32 go
    through the design the table picks (``cuda_core``), held against the
    plain version tiled by that design's chunk, y and the final state
    within K7_FP32_RTOL; then timed."""
    import torch
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    xdt, B, C = (args[k].float() for k in ("xdt", "B", "C"))
    a, h0 = args["a"], args["init_state"]
    p, n = xdt.shape[-1], B.shape[-1]
    design = ss.ssd_design(xdt.dtype, p, n)
    check(design == "cuda_core", f"K7 in float32 takes {design}, not the "
                                 "CUDA-core design")
    y, st = ss.ssd_scan_cuda(xdt, a, B, C, init_state=h0)
    ry, rst = ss.ssd_scan_plain(xdt, a, B, C,
                                chunk=ss.kernel_chunk(xdt.dtype, p, n),
                                init_state=h0)
    errs = {}
    for name, got, want in (("y", y, ry), ("state", st, rst)):
        check(bool(torch.isfinite(got).all()), f"K7 float32: {name} is not "
                                               "finite")
        scale = max(float(want.abs().max()), 1e-30)
        over = (got - want).abs() - K7_FP32_RTOL * (want.abs() + scale)
        check(float(over.max()) <= 0, f"K7 float32: {name} outside "
                                      f"{K7_FP32_RTOL} x (|plain| + its "
                                      "largest |value|)")
        errs[name] = float((got - want).abs().max())
    del y, st, ry, rst
    return dict(design=design, max_abs_err=errs["y"],
                state_abs_err=errs["state"],
                ms=_sync_time_ms(lambda: ss.ssd_scan_cuda(
                    xdt, a, B, C, init_state=h0), iters))


def device_profile(fn):
    """``fn`` once under ``torch.profiler``: its wall seconds and
    [(device us, calls, kernel)] by the kernels' self time, largest
    first (empty where the profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)               # the CPU rehearsal
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((us, e.count, e.key))
    return wall, sorted(rows, reverse=True)


def profile_prefill(model, params, b: int, s: int, seed: int) -> None:
    """One prefill of b x s tokens under ``torch.profiler``;
    prints the device time by kernel (the ten largest) and the share of
    the wall time the device was busy by the sum of the kernels' times."""
    toks = _prompt(model.cfg, b, s, seed, model.device)
    wall, rows = device_profile(lambda: model.prefill(
        params, {"tokens": toks}, max_len=s + 1))
    if not rows:
        log("  profile: the profiler recorded no device time")
        return
    busy = sum(r[0] for r in rows) / 1e6
    log(f"  profile: prefill {b} x {s} in {wall:.3f} s (profiled), device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%) by the kernels' "
        "summed self time")
    for us, count, key in rows[:12]:
        log(f"    {us / 1e3:10.2f} ms  x{count:<5d} {key[:90]}")


def serve_ssm(dev, every: dict) -> dict:
    """Phases 9-11 on the card: mamba2-780m's serving runs and checks,
    hymba-1.5b's, and K7's replays. ``every`` holds the other kernels'
    wrappers, whose counters must stay at 0 on these paths. Returns K7's
    line of the kernels' JSON, its replay's shape, the runs' records and
    the replays."""
    import torch
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    every = {**every, "K7": k7_wrapper()}
    runs = {}
    # phase 9: SSM serving at SSM_ARCH's full width and depth
    t0 = time.perf_counter()
    scfg = get_config(SSM_ARCH)
    model, params = build_serve(dev, scfg, SEED + 9)
    n_params = sum(p.numel() for p in params.values())
    ssd_heads = scfg.ssm.expand * scfg.d_model // scfg.ssm.head_dim
    log(f"phase 9: {scfg.name} at full width and depth ({scfg.num_layers} "
        f"layers, d_model {scfg.d_model}, {ssd_heads} SSD heads of "
        f"{scfg.ssm.head_dim}, state {scfg.ssm.state_size}, "
        f"vocab {scfg.vocab_size}): {n_params / 1e6:.1f} M parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")
    zero_counts(every.values())
    torch.cuda.reset_peak_memory_stats()
    ssm = ssm_serve(model, params, SSM_RUN, SEED + 10)
    torch.cuda.synchronize()
    ssm["launches"] = {k: fn.launches for k, fn in every.items()}
    ssm["by_design"] = by_design(every)
    ssm["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    largest_9a = ssm.pop("largest")()
    run = SSM_RUN
    log(f"phase 9a: prefill {run['batch']} x {run['seq']} in "
        f"{ssm['prefill_s']:.3f} s ({ssm['prefill_tokens_per_s']:.1f} "
        f"tokens/s; K7 {ssm['k7_ms']:.1f} ms of it over "
        f"{ssm['k7_calls']} launches), {run['decode']} decode steps in "
        f"{ssm['decode_s']:.3f} s ({ssm['decode_tokens_per_s']:.1f} "
        f"tokens/s); launches {ssm['launches']} (K7 by design "
        f"{ssm['by_design']['K7']}); max_memory_allocated "
        f"{ssm['max_memory_allocated'] / 1e9:.2f} GB; sample ids "
        f"{ssm['sample']}")
    for k, n in ssm["launches"].items():
        want = scfg.num_layers if k == "K7" else 0
        check(n == want, f"9a: {k} launched {n} times, the path implies "
                         f"{want}")
    # bf16 compute: every K7 launch on the tensor design
    check(ssm["by_design"]["K7"] == {"tensor": scfg.num_layers,
                                     "cuda_core": 0},
          f"9a: K7 by design {ssm['by_design']['K7']}: a bf16 launch "
          "missed the tensor design")
    profile_prefill(model, params, 1, run["seq"], SEED + 10)
    t0 = time.perf_counter()
    log("phase 9b: checks against the whole prefill (limits: argmax equal, "
        f"and by compute type {LIMITS})")
    ssm["checks"] = ssm_checks(model, params, SSM_RUN, SEED + 11)
    log(f"phase 9b: {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(every.values())
    long = ssm_long(model, params, SSM_RUN, SEED + 12)
    long["launches"] = {k: fn.launches for k, fn in every.items()}
    long["by_design"] = by_design(every)
    long["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    kept_9c = long.pop("kept")()
    check(float(kept_9c["init_state"].abs().max()) > 0,
          "9c: the kept launch carries no state")
    log(f"phase 9c: prefill_streaming of 1 x {run['long_seq']} in chunks of "
        f"{run['chunk']} in {long['prefill_s']:.3f} s "
        f"({long['prefill_tokens_per_s']:.1f} tokens/s), "
        f"{run['long_decode']} decode steps in {long['decode_s']:.3f} s "
        f"({long['decode_tokens_per_s']:.1f} tokens/s); launches "
        f"{long['launches']} (K7 by design {long['by_design']['K7']}); "
        f"max_memory_allocated {long['max_memory_allocated'] / 1e9:.2f} GB")
    check(long["launches"]["K7"] == scfg.num_layers * (
        run["long_seq"] // run["chunk"]), "9c: K7 launches differ from one "
                                          "per layer and chunk")
    check(long["by_design"]["K7"] == {"tensor": long["launches"]["K7"],
                                      "cuda_core": 0},
          f"9c: K7 by design {long['by_design']['K7']}: a bf16 launch "
          "missed the tensor design")
    runs["ssm"], runs["ssm_long"] = ssm, long
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # phase 10: hybrid serving at HYBRID_ARCH's full width and depth
    t0 = time.perf_counter()
    hcfg = get_config(HYBRID_ARCH)
    zero_counts(every.values())
    torch.cuda.reset_peak_memory_stats()
    hyb = hybrid_serve(dev, hcfg, HYBRID_RUN, SEED + 13)
    torch.cuda.synchronize()
    hyb["launches"] = {k: fn.launches for k, fn in every.items()}
    hyb["by_design"] = by_design(every)
    hyb["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    hmodel, hparams = hyb.pop("model"), hyb.pop("params")
    largest_10 = hyb.pop("largest")()
    run = HYBRID_RUN
    log(f"phase 10: {hcfg.name} ({hcfg.num_layers} layers, "
        f"{hcfg.num_heads} heads, {hcfg.num_kv_heads} KV heads of "
        f"{hcfg.resolved_head_dim}, window {hcfg.attn_window}, "
        f"{hcfg.ssm.expand * hcfg.d_model // hcfg.ssm.head_dim} SSD heads, "
        f"state {hcfg.ssm.state_size}, d_ff {hcfg.d_ff})")
    for tag in ("bf16", "int8", "fp32", "fp32_int8"):
        r = hyb[tag]
        log(f"phase 10: {tag}: prefill "
            f"{run['batch']} x {run['seq']} in {r['prefill_s']:.3f} s "
            f"({r['prefill_tokens_per_s']:.1f} tokens/s), {run['decode']} "
            f"decode steps in {r['decode_s']:.3f} s "
            f"({r['decode_tokens_per_s']:.1f} tokens/s)")
    log(f"phase 10: launches {hyb['launches']} (by design "
        f"{hyb['by_design']}); max_memory_allocated "
        f"{hyb['max_memory_allocated'] / 1e9:.2f} GB")
    for k, n in hyb["launches"].items():
        want = 4 * hcfg.num_layers if k in ("K5", "K7") else 0
        check(n == want, f"hybrid: {k} launched {n} times, the path implies "
                         f"{want}")
    # the bf16 and int8 runs compute in bf16 (K5's wgmma design, K7's
    # tensor design), the two float32-compute runs in float32 (each one's
    # CUDA-core design)
    for k, fast in (("K5", "wgmma"), ("K7", "tensor")):
        want = {fast: 2 * hcfg.num_layers, "cuda_core": 2 * hcfg.num_layers}
        check(hyb["by_design"][k] == want,
              f"hybrid: {k} by design {hyb['by_design'][k]}, the runs imply "
              f"{want}")
    hyb["decode_err"] = prefill_then_decode(hmodel, hparams,
                                            run["check_batch"], run["seq"],
                                            SEED + 14)
    runs["hybrid"] = hyb
    del hmodel, hparams
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")

    # phase 11: K7 replays
    t0 = time.perf_counter()
    k7_replays = {"K7": k7_record(largest_9a, iters=5),
                  "K7 carried state": k7_record(kept_9c, iters=20),
                  "K7 hymba": k7_record(largest_10, iters=10)}
    k7_fp32 = k7_fp32_record(largest_10, iters=10)
    del largest_9a, kept_9c, largest_10
    for key, r in k7_replays.items():
        log(f"phase 11: {key}: max_abs_err {r['max_abs_err']:.3g} (within "
            f"one bf16 ulp), final state {r['state_err']:.3g} of its largest"
            f" |value| (limit {K7_STATE_RTOL}) | kernel {r['ms']:.4f} ms, "
            f"earlier {r['earlier_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library none, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) | {r['shape']}")
        log(f"phase 11: {key}: by chunk "
            + "; ".join(f"{q}: {c['ms']:.4f} ms, max_abs_err "
                        f"{c['max_abs_err']:.3g}, state {c['state_err']:.3g}"
                        for q, c in r["chunks"].items())
            + f"; cuda_core: max_abs_err {r['earlier_max_abs_err']:.3g} "
            f"(within one bf16 ulp), state {r['earlier_state_err']:.3g}")
    log(f"phase 11: K7 hymba in float32 on {k7_fp32['design']}: max |y - "
        f"plain| {k7_fp32['max_abs_err']:.3g}, max |state - plain| "
        f"{k7_fp32['state_abs_err']:.3g} (within {K7_FP32_RTOL} x (|plain| "
        f"+ its largest |value|)) | kernel {k7_fp32['ms']:.4f} ms")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    r = k7_replays["K7"]
    kernel = {
        "name": K7[0], "route": "cuda", "source": SSD_TENSOR_SOURCE,
        "earlier_source": SSD_SOURCE,
        "replaces": K7[1], "launches": ssm["launches"]["K7"],
        "launches_by_design": ssm["by_design"]["K7"],
        "path": "ssm", "max_abs_err": max(
            x["max_abs_err"] for x in k7_replays.values()),
        "earlier_max_abs_err": max(
            x["earlier_max_abs_err"] for x in k7_replays.values()),
        "fp32_max_abs_err": k7_fp32["max_abs_err"],
        "fp32_state_abs_err": k7_fp32["state_abs_err"],
        "ms": r["ms"], "earlier_ms": r["earlier_ms"],
        "fp32_ms": k7_fp32["ms"],
        "chunk_ms": {q: c["ms"] for q, c in r["chunks"].items()},
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}
    return dict(kernel=kernel, shape=r["shape"], runs=runs,
                k7_replays=k7_replays, k7_fp32=k7_fp32)



# ------------------------------------------------------------ phases 13-14
def pipelined_checks(tag: str, rec: dict, recorder, main: dict) -> None:
    """Phases 13 and 14 beyond the checks every streaming phase takes:
    rounds went through the pipeline and none failed (a retry would hide
    a fault), every K1-K3 launch went out from the pipeline's worker
    thread on the stream of the arena's writes, and the numbers the
    phase prints (events/s beside phase 1's in the same run, the
    learned scheduler's and the store's counts, the fairness counts)."""
    c, pl = rec["counts"], rec["pipeline"]
    log(f"  {tag}: {rec['events_per_s']:.1f} events/s against phase 1's "
        f"{main['events_per_s']:.1f} in this run "
        f"({rec['events_per_s'] / main['events_per_s']:.3f}x; the loop "
        f"alone {rec['loop_events_per_s']:.1f}, backlog "
        f"{rec['seconds']['backlog_drain']:.2f} s); pipeline "
        f"{json.dumps(pl)}; pipeline_rounds {c['pipeline_rounds']}, "
        f"epoch_demoted_rows {c['epoch_demoted_rows']}, pooled_rows "
        f"{c['pooled_rows']}, fallback_rows {c['fallback_rows']}, "
        f"demand_pool_fills {c['demand_pool_fills']}"
        + (f", batch_stall_seconds {c['batch_stall_seconds']:.3f}"
           if "batch_stall_seconds" in c else ""))
    log(f"  {tag}: {_threads_line(recorder)}")
    check(c["pipeline_rounds"] > 0, f"{tag}: no round went through the "
                                    "pipeline")
    check(pl["round_retries"] == 0, f"{tag}: {pl['round_retries']} fold "
                                    "rounds failed and were retried")
    for k in KERNELS:
        check(set(recorder.threads[k]) <= {"aion-fold-worker"},
              f"{tag}: {k} launched from {sorted(recorder.threads[k])}, "
              "not only from the pipeline's worker thread")
        check(recorder.streams[k] <= {rec["pool_stream"]},
              f"{tag}: {k} launched on streams {recorder.streams[k]}, not "
              f"the arena's ({rec['pool_stream']})")
    if tag == "pipelined":
        st = rec["observability"].get("store", {})
        log(f"  {tag}: learned prefetch {json.dumps(rec['prefetch'])}; "
            f"store " + json.dumps({k: st.get(k) for k in (
                "segment_sweeps", "sweep_bytes_read", "readahead_hits",
                "readahead_misses", "coalesced_windows")}))
    else:
        log(f"  {tag}: fairness (I/O tasks by tenant) "
            f"{json.dumps(rec['fairness'])}")
        for name, t in rec["tenants"].items():
            log(f"    {name}: " + json.dumps(t))
        for name in TENANTS:
            check(rec["fairness"].get(name, 0) > 0,
                  f"{tag}: no I/O executed for tenant {name}")
        check(not rec["tenants"]["granite_34b"]["pooled"]
              and all(t["pooled"] for n, t in rec["tenants"].items()
                      if t["operator"] == "stock"),
              f"{tag}: the stock tenants must share the arena and Linear "
              "Road take the unpooled path")


def failure_controls(dev, spill_root: Path, windows: float) -> dict:
    """Phase 13b: phase 13's deployment over ``windows`` windows with one
    demand read failing once: with ``fold_round_retry`` the round must be
    retried and win and every window meet the oracle; without it the
    pipeline's ``drain()`` must raise ``PipelineError``."""
    from repro_torch.core import PipelineError
    run = dict(windows=windows, pool_slots=3072, splitk=0, seed=SEED + 13,
               spill_root=spill_root)
    t0 = time.perf_counter()
    rec = failure_control(dev, retry=True, **run)
    pl = rec["pipeline"]
    log(f"phase 13b: a demand read failed {rec['store_failures']} time(s) "
        f"with fold_round_retry: pipeline {json.dumps(pl)}; "
        f"{rec['events']} events, {rec['windows']} windows held (max |mean "
        f"- oracle| {rec['max_mean_abs_err']:.3g}) in "
        f"{time.perf_counter() - t0:.1f} s")
    check(rec["store_failures"] == 1, "13b: the planted read never failed")
    check(pl["round_retry_wins"] >= 1, "13b: the failed round was not "
                                       "retried to a win")
    t0 = time.perf_counter()
    try:
        failure_control(dev, retry=False, **run)
    except PipelineError as e:
        log(f"  control rejected, as it must be: the same failure without "
            f"fold_round_retry ({str(e)[:160]}) in "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        raise SmokeFailure("13b control: a failed round without "
                           "fold_round_retry drained clean")
    return {"retry": {k: rec[k] for k in (
        "events", "windows", "events_per_s", "max_mean_abs_err",
        "pipeline", "store_failures", "counts")}}


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=float, default=6.0,
                    help="windows of processing time streamed in phase 1")
    ap.add_argument("--splitk-windows", type=float, default=2.0,
                    help="windows of processing time streamed in phase 2")
    ap.add_argument("--lrb-windows", type=float, default=3.0,
                    help="windows of processing time streamed in phase 12")
    ap.add_argument("--pipeline-windows", type=float, default=None,
                    help="windows of processing time streamed in phase 13 "
                    "(default: phase 1's)")
    ap.add_argument("--failure-windows", type=float, default=2.0,
                    help="windows of processing time streamed by each "
                    "failure control of phase 13b")
    ap.add_argument("--tenant-seconds", type=float, default=60.0,
                    help="seconds of processing time streamed in phase 14")
    ap.add_argument("--chaos-windows", type=float, default=3.0,
                    help="windows of processing time streamed by each run of "
                    "phase 15")
    ap.add_argument("--recovery-windows", type=float, default=3.0,
                    help="windows of processing time streamed in phase 16")
    ap.add_argument("--out", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    args = ap.parse_args(argv)
    if args.pipeline_windows is None:
        args.pipeline_windows = args.windows

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the GPU",
              file=sys.stderr)
        return 2
    import numpy as np  # noqa: F401  (fail early where numpy is missing)
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = gpu_line()
    log(f"phase 0: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{count}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.2f} s "
        "(one nvcc per source, in parallel)")
    for source, lib in libs.items():
        log(f"  {source}: nvcc {lib.build_seconds:.2f} s -> {lib.path.name}")
        for name, line in ptxas_lines(lib.build_log):
            log(f"  ptxas: {name}: {line}")

    report = {"gpu": card, "kind": kind}
    spill_root = ROOT / "build" / "smoke"
    spill_root.mkdir(parents=True, exist_ok=True)
    wrappers = dict(zip(KERNELS, sa.KERNEL_WRAPPERS))
    runs, recorded = {}, {}
    try:
        # the data seeds of these runs stay those of the earlier phase
        # numbering (2 and 3), so the streams match the recorded runs
        for phase, tag, seed, drive, kw, need in (
                (1, "main", SEED + 2, run_stream,
                 dict(windows=args.windows, pool_slots=3072, splitk=0),
                 ("K2",)),
                (2, "splitk", SEED + 3, run_stream,
                 dict(windows=args.splitk_windows, pool_slots=1024,
                      splitk=64, restore_at=0.75), ("K3",)),
                # phase 12 runs here, so that phase 3 replays its launch
                (12, "lrb", SEED + 12, run_stream,
                 dict(operator="lrb", windows=args.lrb_windows,
                      pool_slots=4096, splitk=0, profile=True), ("K1",)),
                # phase 1's deployment and seed, pipelined
                (13, "pipelined", SEED + 2, run_stream,
                 dict(windows=args.pipeline_windows, pool_slots=3072,
                      splitk=0, pipelined=True, prefetch_backend="learned",
                      profile=True), ("K2",)),
                (14, "tenants", SEED + 14, run_tenants,
                 dict(seconds=args.tenant_seconds), ("K2",)),
                # phase 1's deployment and seed over a failing store
                ("15a", "chaos_sync", SEED + 2, chaos_stream,
                 dict(windows=args.chaos_windows, pool_slots=3072,
                      splitk=0, pipelined=False), ("K2",)),
                ("15b", "chaos_pipelined", SEED + 2, chaos_stream,
                 dict(windows=args.chaos_windows, pool_slots=3072,
                      splitk=0, pipelined=True), ("K2",)),
                (16, "recovery", SEED + 2, crash_recovery,
                 dict(windows=args.recovery_windows, pool_slots=3072,
                      splitk=0), ("K2",))):
            zero_counts(wrappers.values())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with LaunchRecorder() as recorder:
                rec = drive(dev, seed=seed, spill_root=spill_root, **kw)
            torch.cuda.synchronize()
            rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            rec["wall_s"] = time.perf_counter() - t0
            runs[tag] = rec
            recorded[tag] = recorder.largest
            rec["by_design"] = by_design(wrappers)
            rec["smem_fits"] = dict(recorder.fits)
            log(f"phase {phase}: {tag} run in {rec['wall_s']:.1f} s, kernel "
                f"launches {rec['launches']} (by design {rec['by_design']}; "
                f"launches whose partial fits shared memory "
                f"{rec['smem_fits']}), "
                f"max_memory_allocated "
                f"{rec['max_memory_allocated'] / 1e9:.3f} GB (arena "
                f"{rec['arena_bytes'] / 1e9:.3f} GB)")
            _print_run(tag, rec)
            if rec["profile"] is not None:
                rec["profile"] = fold_profile(rec)
                pr = rec["profile"]
                if pr is None:
                    log(f"  {tag} profile: the profiler recorded no device "
                        "time")
                else:
                    log(f"  {tag} profile of the close-out's re-execution of "
                        f"every window: {pr['wall_s']:.3f} s wall, device "
                        f"busy {pr['busy_s']:.4f} s "
                        f"({100 * pr['busy_share']:.1f}%): K1 "
                        f"{pr['k1_ms']:.4f} ms, row gathers (index_select) "
                        f"{pr['gather_ms']:.4f} ms, the rest "
                        f"{pr['rest_ms']:.4f} ms")
                    for ms, n, key in pr["top"]:
                        log(f"    {ms:10.4f} ms  x{n:<5d} {key}")
            c = rec["counts"]
            check(c["late_executions"] > 0, f"{tag}: no late executions")
            check(c["pooled_rows"] > 0, f"{tag}: no pooled rows")
            check(rec["max_memory_allocated"] >= rec["arena_bytes"] > 0,
                  f"{tag}: the arena is not on the card")
            for k in need:
                check(rec["launches"][k] > 0, f"{tag}: {k} never launched")
            for k, n in rec["launches"].items():
                check(n == 0 or k in recorder.largest,
                      f"{tag}: {k} launched outside the recorded entry "
                      f"points")
            for k in KERNELS:
                fits = rec["smem_fits"][k]
                check(rec["by_design"][k] == {
                    "smem": fits, "global": rec["launches"][k] - fits},
                    f"{tag}: {k} by design {rec['by_design'][k]}, but "
                    f"{fits} of its {rec['launches'][k]} launches fit "
                    "shared memory: a launch missed the smem design")
            if tag == "splitk":
                check(c["splitk_launches"] > 0, "splitk: no split-K launch")
                check(rec["by_design"]["K3"] == {
                    "smem": rec["launches"]["K3"], "global": 0},
                    f"splitk: K3 by design {rec['by_design']['K3']}: a "
                    "launch missed the shared-memory design")
            if tag in ("pipelined", "tenants"):
                pipelined_checks(tag, rec, recorder, runs["main"])
            if tag.startswith("chaos"):
                chaos_checks(tag, rec, recorder, runs["main"])
            if tag == "recovery":
                recovery_checks(tag, rec, recorder)
                at = rec["drill"]["launches_at_restore"]
                rec["restored_launches"] = {
                    k: rec["launches"][k] - at[k] for k in KERNELS}
                log(f"  {tag}: K1-K3 launches of the restored engine "
                    f"{rec['restored_launches']}")
        report["failure_controls"] = failure_controls(
            dev, spill_root, args.failure_windows)
    finally:
        shutil.rmtree(spill_root, ignore_errors=True)
    fallback = sum(r["counts"]["fallback_rows"] for r in runs.values())
    check(fallback > 0, "no fallback rows in phases 1-2")

    # phase 3: each kernel replays its largest launch of the first run in
    # which it launched, of the runs it serves: K1 Linear Road's (phase
    # 12, its row of the table) and the stock fallback's (main, then
    # split-K); K2 and K3 the stock runs'
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    kernels, shapes = [], []
    for key, label, served in (("K1", "K1", ("lrb",)),
                               ("K1", "K1 stock fallback",
                                ("main", "splitk")),
                               ("K2", "K2", ("main", "splitk")),
                               ("K3", "K3", ("main", "splitk"))):
        by_run = {tag: r["launches"][key] for tag, r in runs.items()}
        path = next((t for t in served if by_run[t] > 0), None)
        check(path is not None, f"{label} was never launched on the main "
                                "path")
        rec = recorded[path][key]
        r = kernel_record(key, rec, g, iters=50)
        if label == "K1":
            r["max_abs_err"] = max(r["max_abs_err"], nan_check(dev, g))
        log(f"phase 3: {label} {r['name']}: max_abs_err "
            f"{r['max_abs_err']:.3g} "
            f"(count/min/max exact, sum rtol {SUM_RTOL} + atol {SUM_ATOL} x "
            f"max|v| x events/segment) | kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})"
            + f", earlier design {r['earlier_ms']:.4f} ms, launch alone "
            f"{r['launch_ms']:.4f} ms"
            + ("" if key != "K1" else " (by events a block: " + ", ".join(
                f"{n}: {t:.4f}" for n, t in r["per_block_ms"].items())
               + " ms)")
            + f" | the largest launch of the {path} run ({by_run}): "
            f"{r['shape']}")
        if label == "K1 stock fallback":
            # the table's K1 row is Linear Road's; the fallback's replay
            # rides along in it
            kernels[0]["stock_fallback"] = dict(r, path=path)
        else:
            shapes.append(r.pop("shape"))
            kernels.append({
                "name": r["name"], "route": r["route"],
                "source": r["source"], "replaces": r["replaces"],
                "launches": by_run[path], "path": path,
                "launches_by_run": by_run, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "earlier_source": r["earlier_source"],
                "earlier_ms": r["earlier_ms"], "launch_ms": r["launch_ms"],
                "launches_by_design": runs[path]["by_design"][key]})
            if "per_block_ms" in r:
                kernels[-1]["per_block_ms"] = r["per_block_ms"]
        torch.cuda.synchronize()
        del rec
        torch.cuda.empty_cache()
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4: serving at the attention width of SERVE_ARCH
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_ARCH)
    attn = {k: attn_wrapper(k) for k in ATTN_KERNELS}
    zero_counts((*wrappers.values(), *attn.values()))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    serve = run_serve(dev, cfg)
    torch.cuda.synchronize()
    serve["launches"] = {k: fn.launches for k, fn in
                         {**wrappers, **attn}.items()}
    serve["by_design"] = by_design(attn)
    serve["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    serve["wall_s"] = time.perf_counter() - t0
    cache = serve.pop("cache")
    largest, longest = serve.pop("largest_k4"), serve.pop("longest_prefill")
    log(f"phase 4: {SERVE_ARCH} serving ({cfg.num_layers} layers, "
        f"{cfg.num_heads} heads, {cfg.num_kv_heads} KV heads of "
        f"{cfg.resolved_head_dim}, bf16) in {serve['wall_s']:.1f} s: "
        f"{serve['requests']} requests, {serve['prompt_tokens']} prompt "
        f"tokens, {serve['tokens']} tokens decoded in {serve['steps']} steps"
        f", {serve['tokens_per_s']:.1f} tokens/s over "
        f"{serve['decode_s']:.2f} s of steps")
    log("  serve seconds: " + json.dumps(
        {k: round(v, 3) for k, v in serve["seconds"].items()}))
    log(f"  serve stats: {json.dumps(serve['stats'])} (while submitting: "
        f"{json.dumps(serve['submit_moves'])}), sessions moved "
        f"{json.dumps(serve['sessions_moved'])}, -1 pages read inside "
        f"seq_len {serve['minus_one_pages_read']}, rows with no resident "
        f"page {serve['rows_without_pages']}")
    log(f"  serve checks (within one bf16 ulp): "
        f"{serve['k4_launches_checked']} K4 launches against the plain "
        f"version (max err {serve['k4_max_err']:.3g}), untiered sessions "
        f"{json.dumps(serve['untiered_max_err'])}, wrong restaged pages "
        f"rejected {serve['controls_rejected']}; "
        f"launches {serve['launches']} (K4 by design "
        f"{serve['by_design']['K4']}, K5 {serve['by_design']['K5']}); KV pool "
        f"{serve['pool_bytes'] / 1e9:.2f} GB, max_memory_allocated "
        f"{serve['max_memory_allocated'] / 1e9:.2f} GB")
    check(serve["max_memory_allocated"] >= serve["pool_bytes"],
          "serve: the KV pool is not on the card")
    for k in ATTN_KERNELS:
        check(serve["launches"][k] > 0, f"serve: {k} never launched")
    check(serve["by_design"]["K4"] == {"split_kv": serve["launches"]["K4"],
                                       "cuda_core": 0},
          f"serve: K4 by design {serve['by_design']['K4']}: a launch "
          "missed the split-KV design")
    check(serve["by_design"]["K5"] == {"wgmma": serve["launches"]["K5"],
                                       "cuda_core": 0},
          f"serve: K5 by design {serve['by_design']['K5']}: a bf16 launch "
          "missed the wgmma design")
    runs["serve"] = serve

    # phase 5: K4 and K5 replays
    t0 = time.perf_counter()
    wcfg = get_config(WINDOW_ARCH)
    wq = torch.randn((1, 4096, wcfg.num_heads, wcfg.resolved_head_dim),
                     generator=g, device=dev, dtype=torch.bfloat16)
    wk, wv = (torch.randn((1, 4096, wcfg.num_kv_heads,
                           wcfg.resolved_head_dim), generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    replays = {
        "K4": k4_record(cache, largest, iters=20),
        "K5": k5_record(longest["q"], longest["k"], longest["v"], True, 0,
                        iters=5),
        "K5 window": k5_record(wq, wk, wv, True, wcfg.attn_window, iters=10),
    }
    del cache, largest, longest, wq, wk, wv
    FL = flash_limits()
    r = replays["K4"]
    log(f"phase 5: K4: max_abs_err {r['max_abs_err']:.3g} (within one bf16 "
        f"ulp; by design {json.dumps(r['errs'])}) | kernel {r['ms']:.4f} ms"
        f", one split {r['one_split_ms']:.4f} ms, earlier "
        f"{r['earlier_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); split lengths {json.dumps(r['sweep_ms'])} "
        f"ms; TB/s of the bound's bytes "
        f"{json.dumps(r['tb_per_s'])} | {r['shape']}")
    for key in ("K5", "K5 window"):
        r = replays[key]
        log(f"phase 5: {key}: worst row {r['row_err']:.3g} of its norm "
            f"(limit {FL.FWD_ROW_RTOL}), {r['ulps']:.1f} ulps (limit "
            f"{FL.ULP_LIMIT}), max_abs_err {r['max_abs_err']:.3g}, lse "
            f"{r['lse_err']:.3g} (within {LSE_TOL}); float32 "
            f"{r['fp32_err']:.3g} (within {FP32_ATTN_TOL}), lse "
            f"{r['fp32_lse_err']:.3g} | kernel {r['ms']:.4f} ms, earlier "
            f"{r['earlier_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) | {r['shape']}")
    for key, (name, replaces, _, _) in ATTN_KERNELS.items():
        r = replays[key]
        shapes.append(r["shape"])
        entry = {
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": replaces, "launches": serve["launches"][key],
            "path": "serve", "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if key == "K4":
            entry.update(
                source=DECODE_SOURCE, earlier_source=ATTN_SOURCE,
                earlier_ms=r["earlier_ms"], one_split_ms=r["one_split_ms"],
                n_split=r["n_split"],
                launches_by_design=serve["by_design"]["K4"])
        if key == "K5":
            entry.update(
                source=FWD_SOURCE, earlier_source=ATTN_SOURCE,
                max_abs_err=max(r["max_abs_err"],
                                replays["K5 window"]["max_abs_err"]),
                row_err=max(r["row_err"], replays["K5 window"]["row_err"]),
                earlier_ms=r["earlier_ms"],
                launches_by_design=serve["by_design"]["K5"])
        kernels.append(entry)
    report["k5_window"] = replays["K5 window"]
    log(f"phase 5: {time.perf_counter() - t0:.1f} s; max_memory_allocated "
        f"since phase 4 {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # phase 6: training at TRAIN_ARCH's full width (phase 4's pool is
    # freed: the last references went with phase 5)
    gc.collect()
    torch.cuda.empty_cache()
    k6 = k6_wrapper()
    every = {**wrappers, **attn, "K6": k6}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, params, run = build_train(dev, get_config(TRAIN_ARCH))
    tcfg = model.cfg
    n_params = sum(p.numel() for p in params.values())
    log(f"phase 6: {tcfg.name} at full width ({tcfg.d_model} wide, "
        f"{tcfg.num_heads} heads, {tcfg.num_kv_heads} KV heads of "
        f"{tcfg.resolved_head_dim}, d_ff {tcfg.d_ff}, vocab "
        f"{tcfg.vocab_size}) with {tcfg.num_layers} of 32 layers: "
        f"{n_params / 1e9:.3f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    grad = grad_check(model, params, run)
    grad["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"phase 6a: gradient check on 1 x {run['grad_seq']} tokens, K5/K6 "
        f"against their plain versions: loss {grad['loss']:.6f} (off by "
        f"{grad['loss_err']:.3g}, limit {LOSS_TOL}), the worst gradient "
        f"{grad['worst_param']} off by {grad['grad_rel_err']:.3g} of its "
        f"norm (limit {GRAD_RTOL}), {grad['seconds']:.1f} s, "
        f"max_memory_allocated {grad['max_memory_allocated'] / 1e9:.2f} GB")
    zero_counts(every.values())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = train_run(model, params, run)
    torch.cuda.synchronize()
    train["launches"] = {k: fn.launches for k, fn in every.items()}
    train["by_design"] = by_design(every)
    train["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    train["wall_s"] = time.perf_counter() - t0
    largest_k6 = train.pop("largest_k6")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {"K5": 2 * tcfg.num_layers, "K6": tcfg.num_layers}
    log(f"phase 6b: {run['steps']} steps of {run['batch']} x {run['seq']} "
        f"tokens in {train['wall_s']:.1f} s: losses "
        f"{[round(x, 4) for x in train['losses']]}, "
        f"{train['tokens_per_s']:.1f} tokens/s over steps 2-{run['steps']}"
        f", launches {train['launches']} (by design "
        f"{train['by_design']}), max_memory_allocated "
        f"{train['max_memory_allocated'] / 1e9:.2f} GB")
    log("  step seconds (wall / forward / backward / optimizer): " + "; ".join(
        f"{w:.3f} / {f:.3f} / {b:.3f} / {o:.3f}" for w, f, b, o in zip(
            train["step_s"], train["forward_s"], train["backward_s"],
            train["optimizer_s"])))
    for k, n in train["launches"].items():
        want = per_step.get(k, 0) * run["steps"]
        check(n == want, f"train: {k} launched {n} times, the path implies "
                         f"{want}")
    for k in ("K5", "K6"):
        check(train["by_design"][k] == {"wgmma": train["launches"][k],
                                        "cuda_core": 0},
              f"train: {k} by design {train['by_design'][k]}: a bf16 "
              "launch missed the wgmma design")
    check(bool(largest_k6), "train: no K6 launch was kept")
    runs["train"] = train
    runs["grad_check"] = grad

    # phase 7: the entry point at its default config, resumed
    zero_counts(every.values())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    entry_root = ROOT / "build" / "smoke"
    entry_root.mkdir(parents=True, exist_ok=True)
    try:
        entry = run_entry(dev, entry_root)
    finally:
        shutil.rmtree(entry_root, ignore_errors=True)
    torch.cuda.synchronize()
    entry["launches"] = {k: fn.launches for k, fn in every.items()}
    entry["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    entry["wall_s"] = time.perf_counter() - t0
    log(f"phase 7: launch.train ({entry['config']}, {entry['params']} "
        f"parameters) to step {ENTRY_RUN['first']}, then resumed from step "
        f"{entry['resumed_from']} to {ENTRY_RUN['second']} with the saved "
        f"parameters bit for bit, restarts {entry['restarts']}, in "
        f"{entry['wall_s']:.1f} s; losses "
        f"{[round(x, 4) for x in entry['losses']]}; launches "
        f"{entry['launches']}; max_memory_allocated "
        f"{entry['max_memory_allocated'] / 1e9:.3f} GB")
    for k in ("K5", "K6"):
        check(entry["launches"][k] > 0, f"entry point: {k} never launched")
    runs["entry"] = entry

    # phase 8: K6 replays: the training launch and hymba-1.5b's window
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    wq, wk, wv = (torch.randn(
        (1, 4096, n, wcfg.resolved_head_dim), generator=g, device=dev,
        dtype=torch.bfloat16) for n in (wcfg.num_heads, wcfg.num_kv_heads,
                                        wcfg.num_kv_heads))
    wo, wlse = attn["K5"](wq, wk, wv, causal=True, window=wcfg.attn_window,
                          return_lse=True)
    wdo = torch.randn(wq.shape, generator=g, device=dev,
                      dtype=torch.bfloat16)
    k6_replays = {
        "K6": k6_record(*largest_k6["args"], iters=3, **largest_k6["kw"]),
        "K6 window": k6_record(wq, wk, wv, wo, wdo, wlse, True,
                               wcfg.attn_window, iters=5),
    }
    del largest_k6, wq, wk, wv, wo, wdo, wlse
    for key, r in k6_replays.items():
        by_out, twin = r["row_err_by_output"], r["twin_row_err"]
        log(f"phase 8: {key}: worst row by output "
            + ", ".join(f"{n} {by_out[n]:.3g}" for n in by_out)
            + "; the Pallas rounding in plain float32 on the same inputs "
            + ", ".join(f"{n} {twin[n]:.3g}" for n in twin))
        log(f"phase 8: {key}: device ms by pass (one profiled launch) "
            + ", ".join(f"{n} {t:.4f}" for n, t in r["passes_ms"].items()))
        log(f"phase 8: {key}: dq, dk, dv: worst row {r['row_err']:.3g} of "
            f"its norm (limit {FL.BWD_ROW_RTOL}), "
            f"{r['ulps']:.1f} ulps (limit {FL.ULP_LIMIT}), "
            f"max_abs_err {r['max_abs_err']:.3g}; float32 "
            f"{r['fp32_err']:.3g} (within {FP32_GRAD_TOL}) | kernel "
            f"{r['ms']:.4f} ms, earlier {r['earlier_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA backward {r['library_ms']:.4f} "
            f"ms, K5 on the same q/k/v {r['k5_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | {r['shape']}")
    r = k6_replays["K6"]
    shapes.append(r["shape"])
    kernels.append({
        "name": K6[0], "route": "cuda", "source": BWD_HOPPER_SOURCE,
        "earlier_source": BWD_SOURCE,
        "replaces": K6[1], "launches": train["launches"]["K6"],
        "launches_by_design": train["by_design"]["K6"],
        "path": "train", "max_abs_err": max(
            x["max_abs_err"] for x in k6_replays.values()),
        "row_err": max(x["row_err"] for x in k6_replays.values()),
        "ms": r["ms"], "earlier_ms": r["earlier_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    report["k6_replays"] = k6_replays
    log(f"phase 8: {time.perf_counter() - t0:.1f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    ssm_out = serve_ssm(dev, every)
    kernels.append(ssm_out["kernel"])
    shapes.append(ssm_out["shape"])
    runs.update(ssm_out["runs"])
    report["k7_replays"] = ssm_out["k7_replays"]
    report["k7_fp32"] = ssm_out["k7_fp32"]

    if args.out is not None:
        report["kernels"] = [dict(x, shape=s)
                             for x, s in zip(kernels, shapes)]
        report["runs"] = runs
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1, default=str))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
