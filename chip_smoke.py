#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--windows 1.5] [--splitk-windows 2]
                          [--lrb-windows 1.5] [--pipeline-windows 1.5]
                          [--failure-windows 1.5] [--tenant-seconds 45]
                          [--chaos-windows 1.5] [--recovery-windows 1.25]
                          [--sharded-windows 3]
                          [--sharded-splitk-windows 2]
                          [--sharded-lrb-windows 1.5]
                          [--sharded-stacked-windows 0.5] [--out FILE]

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
   first query tile zeroed must be rejected (a planted control). 6b: four
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
   7b: the same with ``--arch mamba2-780m`` (``reduced``: K7 on its
   CUDA-core design at head dim 32, and no other kernel).
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
   its tensor design), then 16 steps
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
   4,096, then 8 decode steps.
10. Hybrid serving at hymba-1.5b's full width and depth (32 layers,
   d_model 1,600, 25 heads with 5 KV heads of 64, window 1,024, 50 SSD
   heads of 64, state 16, d_ff 5,504): prefill of 4 x 4,096 tokens (K5
   with the window, K7) and 16 decode steps through ``attn_decode``'s
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
   of processing time (0.9 M events at 1.5), as phase 1 runs and closes out
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
   (default 1.5 since phase 29): every fold round, the close-out's sweep too, on
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
   ``--tenant-seconds`` of processing time (1.8 M events at 45), then
   closes out; every stock window is held to the stock oracle and the Linear
   Road window to its own, every tenant must have had I/O executed
   (``fairness_stats``), and every fold launch must have gone out from
   the shared pipeline's worker thread.
15. Aion's failure path on phase 1's deployment, seed, 3,072-slot pool
   and budgets, each run over ``--chaos-windows`` windows (450,000 events
   at the default 1.5): the log store behind a ``FaultyBlockStore`` whose
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
   (the injector paused). Near the half (5 s past the checkpoint at or
   before it, so that the batches after it are replayed), as
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
17. MoE serving at qwen3-moe-30b's full width and depth
   (``configs/qwen3_moe_30b.py``: 48 layers, d_model 2,048, 32 heads and 4
   KV heads of 128, 128 experts of d_ff 768, top-8, vocab 151,936) with
   bf16 parameters through the config's ``param_dtype`` (the router
   float32): 30.5 B parameters, 61 GB, from a seeded generator, after the
   earlier phases' tensors are released. 17a: ``make_prefill_step`` on 4 x
   2,048 tokens (8,192 routed: an expert keeps 640, so experts overflow),
   K5 once per layer, every launch on wgmma, then 16 greedy
   ``make_decode_step`` steps (each reads every weight); then one prefill
   under ``torch.profiler`` (the device's busy share, the largest device
   operations), and one decode step so profiled. 17b: the prefill's last
   logits and the first decode step's with K5 against the same model,
   weights and tokens with K5's plain version, routed as K5's run routed
   (``RoutingPin``), each row within MOE_LOGITS_RTOL of its norm; the
   plain version routing freely is read beside, not held. 17c: a
   prefill of 2 x 31 tokens and one decode step against ``train_logits``
   of 2 x 32 (the capacity clamps to T: no token can be dropped), both
   in a fixed summing order (``fixed_order``), the argmaxes equal and
   each row within MOE_TF_RTOL. The 4 x 2,048 decode is
   not held against a prefill of one more token: a prefill drops the
   tokens past an expert's capacity, a one-token decode drops none.
18. MoE training at qwen3-moe-30b's full width with 2 of its 48 layers
   (fp32 parameters, bf16 compute, ``remat="full"``; 1.87 B parameters,
   30 GB of state with AdamW's moments): phase 6a's gradient check on 1 x
   1,024 tokens (the loss within LOSS_TOL, every gradient, the router's
   and the experts' included, within GRAD_RTOL of its norm, and its
   zeroed-dq control; the plain and control runs routed as the kernels'
   run, the free run's loss read beside), then four ``make_train_step`` steps on
   ``token_batches`` of 2 x 4,096 through ``PrefetchPipeline``: every loss
   finite and every aux positive, K5 launched 2 x 2 times a step and K6
   twice, all on wgmma.
19. The four examples, each in its own process with ``PYTHONPATH=src``,
   the four started at once (``EXAMPLE_BOOT`` sets the kernels' counters to 0, runs the script as
   ``__main__`` and prints the counts) at their defaults,
   ``torch_train_lm.py`` with ``--steps 40``: each must exit 0 and print
   its closing lines (the quickstart's executions with late > 0, the
   serving example's ``completed 8/8``, the training example's ``loss: a
   -> b`` with b < a, the demos' last line), and launch the kernels
   EXAMPLES names: K2 for the two engine examples (K1 may launch, through
   the stacked fallback), K4 on its CUDA-core design for the serving
   example (float32 pages), K5 and K6 on wgmma for the training example;
   no other.
20. SSM training at mamba2-780m's full width and depth (48 layers, fp32
   parameters, bf16 compute, ``remat="full"``): 20a, phase 6a's gradient
   check on 1 x 4,096 tokens through 4 of the layers, K7 forward and
   ``ssd_scan_bwd`` against ``ssd_scan_plain`` differentiated by autograd
   (``plain_versions``), the loss within SSM_LOSS_TOL (6a's LOSS_TOL is
   passed by K7's bf16 rounding alone here) and every gradient within
   GRAD_RTOL of its norm; the last layer's state adjoint dropped at
   the middle chunk boundary is read beside (``dropped_state_adjoint``:
   a parameter's gradient moves by a few percent of its norm, which
   GRAD_RTOL cannot hold), and held instead on the last layer's own scan
   (``scan_grad_check``): dxdt, da, dB and dC within SCAN_GRAD_RTOL of
   the plain version's, the same dropped adjoint at least CONTROL_FACTOR
   times that limit. 20b: two ``make_train_step`` steps of 2 x 4,096
   tokens through ``PrefetchPipeline``, every loss finite, K7 launched
   twice a layer and step on its tensor design and no other kernel;
   tokens/s over step 2, forward, backward, AdamW and
   ``ssd_scan_bwd`` on CUDA events (the backward's share of the step),
   then one more step under ``torch.profiler`` (busy share, K7's time).
21. The same for hybrid training at hymba-1.5b's full width and depth (32
   layers, window 1,024, 25 heads with 5 KV heads of 64, 50 SSD heads,
   state 16): K5, K6 (window, GQA) and K7 against their plain versions
   in 21a with 6a's zeroed-dq control too (over K6's first dq block of
   128 rows), and in 21b K5 launched twice,
   K6 once and K7 twice a layer and step, K5 and K6 on wgmma, K7 on
   tensor.
22. The training switches at mamba2-780m's full width with 4 layers on
   1 x 4,096 tokens: the loss and gradients under ``remat`` ``full``,
   ``dots`` and ``remat_group=2`` against ``none`` within REMAT_RTOL of
   each norm (bit-for-bit equality printed) and each mode's peak of
   allocated memory; then two steps each of ``compress_grads`` in
   ``int8`` and ``topk`` (1%) with error feedback as the train step's
   ``grad_transform``, one scale and one threshold for each JAX leaf
   (every layer of a stacked name together, as JAX transforms its
   stacked arrays): every sent int8 element within INT8_STEPS of its
   target, the new error feedback target - sent, top-k keeping at least
   k elements at or above the threshold and zero elsewhere.
23. Enc-dec (audio) serving at seamless-m4t-medium's full width and depth
   (``configs/seamless_m4t_medium.py``: 12 encoder and 12 decoder layers,
   d_model 1,024, 16 heads of 64, d_ff 4,096, vocab 256,206; bf16
   parameters, 0.978 B): 23a, ``make_prefill_step`` on 16 prompts of 128
   tokens, each over 1,024 stub audio frames (``stub_inputs``: normal x
   0.02 from a seeded generator, as the JAX entry point draws them), K5
   once for every attention (12 encoder, non-causal at 1,024 x 1,024; 12
   decoder self; 12 cross, non-causal at 128 x 1,024), all on wgmma,
   then 32 greedy steps; a profiled prefill and decode step (busy
   share). 23b: a prefill of 2 x 127 tokens and one decode against
   ``train_logits`` of 2 x 128 (``teacher_forcing``: argmax equal, rows
   within TF_RTOL in bf16 and TF_F32_RTOL in float32 compute), the
   control a decode whose layer 0 reads layer 1's cross K/V (rejected in
   float32); the int8 cache against the 16-bit one by phase 10's rule,
   the cross K/V staying 16-bit and bit for bit.
24. Enc-dec training at seamless-m4t-medium's full width and depth (fp32
   parameters, bf16 compute, ``remat="full"``; 15.6 GB with AdamW's
   moments): 24a, phase 6a's gradient check on 1 x (1,024 frames, 1,024
   tokens) through 4 encoder and 4 decoder layers, in float32 compute
   (K5/K6 on their CUDA-core design) and in bf16, each with its control:
   K6's dK and dV of every decoder layer's cross-attention zeroed, read
   on the encoder's gradients, which reach the encoder only through those
   K/V (the last decoder layer's alone is read beside, not held: it
   carries a third of them); 24b, four
   ``make_train_step`` steps of 2 x (1,024 frames, 2,048 tokens), the
   frames drawn on the card for each step (the entry point gives none):
   every loss finite, K5 2 x 36 times and K6 36 times a step, all on
   wgmma; tokens/s and the forward / backward / AdamW split on CUDA
   events.
25. VLM serving at internvl2-76b's full width with 8 of its 80 layers
   (``configs/internvl2_76b.py``: d_model 8,192, 64 heads with 8 KV
   heads of 128, d_ff 28,672, vocab 128,256; bf16 parameters, 17.9 GB):
   4 x (256 stub patch embeddings + 1,792 tokens), K5 once a layer on
   wgmma at G 8, D 128, 32 greedy steps, a profiled prefill and decode
   step; 25b as 23b on 2 x (256 + 1,791) + one decode, ``pos`` counting
   the patches, the control the decode at ``pos`` = the text's length.
26. K5 and K6 on the largest non-causal launches of phases 23-24 (16
   heads of 64, seeded bf16 inputs): the encoder's 1,024 x 1,024 (K5 at
   batch 16, K6 at 2) and the cross-attention's 2,048 x 1,024 (batch 2),
   each against the fp32 plain version within ``kernels/flash_limits.py``
   with its last key tile dropped as a control, timed beside the plain
   version, SDPA (a yardstick) and its bound. Then the masked replays
   (``MASKED``): K5 and K6 with a per-row key length (``kv_valid_len``)
   on seamless-m4t-medium's cross shape as a padded audio batch (2 x
   2,048 queries over 1,024 frames, frame lengths (1,024, 611)), causal
   at starcoder2-7b's 36 heads and 4 KV heads of 128 (2 x 4,096, lengths
   (4,096, 2,500)), both bf16 on wgmma, and the cross shape in float32
   on the CUDA-core design: each against its plain version with the same
   lengths within the flash limits (float32 also within FP32_ATTN_TOL and
   FP32_GRAD_TOL), the keys past a row's length with exactly zero dK and
   dV, each kernel with the lengths ignored as the control (at least
   CONTROL_FACTOR x the row limit), timed beside the same launch without
   lengths (the ratio printed beside the share of K5's key tiles the
   lengths keep), the plain version, SDPA with the mask and the bound of
   the kept pairs; their errors fold into K5's and K6's entries.
27. Slot sharding (run after phase 13b, before phase 3): ``StreamEngine``
   with ``AionConfig(slot_sharding=True)`` over a 4-entry slot mesh (the
   first four cards where there are four, else ``cuda:0`` named four
   times, which checks the sharded placement, masking and per-shard
   launches on one card and nothing of scaling). Each stream starts at
   ``SHARDED_START`` (300 s stock, 420 s Linear Road), where its windows
   hash onto every shard. 27a: phase 1's deployment, seed, 3,072-slot
   pool (the arena split into one tile a shard) and budgets over
   ``--sharded-windows`` windows, pipelined: K2 once a shard on its
   tile, K1 on the unsharded stacked fallback. 27b: the same,
   synchronous, with ``splitk_chunk_rows=64`` on a 1,024-slot pool over
   ``--sharded-splitk-windows`` windows: K3 once a shard. 27c: phase
   12's Linear Road deployment over ``--sharded-lrb-windows`` windows:
   K1 once a shard through the pooled table. 27d and 27e: phase 1's
   deployment with no block pool over ``--sharded-stacked-windows``
   windows each: the stacked fold, K1 once a shard on the rows its slots
   own (27d), and with ``splitk_chunk_rows=64`` the row-balanced K1 once
   a shard (27e). Each: every window against the oracle, sharded rounds
   counted, every shard's launches of its kernel by design
   (``launches_by_shard``) and live rows (rows with a valid event:
   none may fold padding alone), every arena tile on its mesh entry,
   and each kernel's largest sharded call (``ShardRecorder``) replayed
   through the sharded wrapper and against the plain unsharded fold on
   the same inputs (count, min and max equal, sum within SHARD_SUM_RTOL
   and SHARD_SUM_ATOL; pool slot 0 NaN and inert); printed beside phase
   1's events/s, the rows and launches by shard, and the close-out's
   device busy share.
28. The LM half of multi-device training and serving (after 26): a (2, 2) mesh
   (``data``, ``model``) of four ranks spawned on ``cuda:0`` and joined by
   gloo (NCCL refuses two ranks on one device), every collective an
   all-reduce across the host; the kernels are built
   before (phase 0), so no rank runs nvcc. 28a: starcoder2-7b at full
   width with 4 layers (``LM_DENSE_RUN``: 2 x 4,096 tokens a step, bf16
   compute, fp32 parameters, remat full): data-parallel over ``data``,
   FSDP (the ``fsdp`` dims over ``data``), tensor-parallel over
   ``model`` (18 query and 2 KV heads a rank); rank 0 first runs the
   one-process steps on the same weights and saves the first step's
   gradients; as the control, the mesh's gradients of the first batch
   with the ``o`` projection's ``model`` reduce dropped must read at
   least CONTROL_FACTOR x GRAD_RTOL; then ``LM_DENSE_RUN["steps"]`` steps
   (the main path: K5 and K6 counted on every rank, 2 x layers and
   layers a step, all on wgmma), the first step's loss within LOSS_TOL
   of the one-process step's and each of its gradients within GRAD_RTOL
   of its norm (every rank reading its shards against its slices), the
   later losses beside the one-process steps', and each rank's first K5
   and K6 launch replayed against the plain version within
   ``kernels/flash_limits.py``.
   28b: qwen3-moe-30b at full width with 1 layer, the experts over
   ``model`` (64 a rank): each rank's MoE layer outputs against the
   one-process ``moe_forward`` of its data shard's tokens with the
   layer's full weights (JAX's expert parallelism: the capacity from
   the local token count) within MOE_EP_RTOL, the expert outputs'
   ``model`` reduce dropped as the control, then ``LM_MOE_RUN["steps"]``
   steps whose losses must be finite and equal on every rank.
   28c and 28d, serving under the same mesh on the same ranks
   (``LM_SERVE``, bf16 weights and compute): 28c starcoder2-7b at full
   width with 2 layers, a prefill of 2 x 4,096 under the prefill rules
   (the batch over ``data``, K5 once a layer on each rank's 18 query and
   2 KV heads), the cache handed over to the decode rules' layout (all 4
   KV heads over each rank's 2,080 of 4,160 slots), then 16 decode
   steps (context-parallel: q gathered over ``model``, the partial
   softmax merged across it, each rank writing the token only where its
   slice holds the slot); 28d qwen3-moe-30b with 1 layer (64 experts a
   rank), 2 x 2,048, 2,064 slots, 16 steps. Rank 0 first runs the
   one-process prefill and greedy decode on the same weights and saves
   its logits and tokens; the mesh decodes those tokens, and every
   rank's prefill and step logits (its rows and vocab shard) must lie
   within TF_RTOL of the row's norm; the next tokens' agreement is read.
   A float32-compute rerun at 2 layers (prefill and 2 steps) must lie
   within TF_F32_RTOL, and with the merge's ``model`` reduce dropped
   (each rank attending only its slice) read at least CONTROL_FACTOR x
   that. 28c also runs each step under the other kind's rules: the
   prefill's cache decoded 4 steps head-parallel under the prefill rules
   (each rank's q heads against its 2 stored heads, every slot, ``o``
   reduced over ``model``), and the prompt prefilled under the decode
   rules straight into the sequence-sharded cache (each rank's 18 q
   heads against the 2 of the 4 stored heads they map to, its 2,080
   slots filled, held against the one-process cache's slots of K) and
   decoded there 4 steps, held as the main path (2 steps each in
   float32), with two more controls in float32: the head-parallel
   decode's ``o`` reduce dropped, read on the steps, and each rank's
   prefill keeping its neighbour's slot range, read on the slots of K
   (attention does not see the order of its keys). The main
   path (bf16 prefills and steps) is counted: K5 once a layer and
   prefill on every rank (28c's two prefills), on wgmma.
   28e and 28f, the SSM and hybrid families under the same mesh at full
   width with 2 layers (``LM_TRAIN``, ``LM_SERVE``): 28e mamba2-780m
   (24 of 48 SSD heads a rank, vocab-parallel tied embeddings), 28f
   hymba-1.5b (25 of 50 SSD heads a rank beside DP-only attention on all
   25 heads, window 1,024, and an MLP split over ``model``). Each trains
   ``LM_TRAIN[part]["steps"]`` steps of 2 x 4,096 tokens held as 28a holds
   its first step (loss within LOSS_TOL, each gradient within GRAD_RTOL
   of its norm), then serves as 28c does: a prefill of 2 x 4,096, 28e
   also streamed in 2 chunks, 16 decode steps, each rank's SSM state
   against its slice of the one-process state within TF_RTOL (float32
   within TF_F32_RTOL); the float32 check's controls drop the SSD ``o``
   projection's ``model`` reduce and the gated norm's sum over
   ``model``, each read on the prefill. The main path (the training
   steps, the prefills and the steps) is counted: K7 twice a layer and
   step in training and once a layer a prefill or chunk, on tensor; in
   28f K5 and K6 as in 28a and K5 once a layer a prefill, on wgmma.
   28g, seamless-m4t-medium (the audio family) at full width with 4
   encoder and 4 decoder layers (8 of 16 heads a rank in each attention,
   d_ff 2,048 and vocab 128,128 a rank): 1 training step of 2 x (1,024
   stub frames, 2,048 tokens) (fp32 parameters, bf16 compute, remat
   full), held as 28e is but for the loss, within
   SSM_LOSS_TOL (24a's bf16 limit); the control drops the cross K/V's
   ``copy_to`` on the first batch and is read on the encoder's
   gradients; then served as 28c is: a prefill of 16 x 128 tokens over
   1,024 frames, the cross cache handed over from each rank's 8 heads to
   all 16, 16 decode steps on 160 slots (80 a rank), float32 at 2 + 2
   layers, cross-attention's ``o`` reduce dropped as the control (read
   on the float32 steps). The main path: K5 twice and K6 once an
   attention block (4 encoder, 4 self, 4 cross) and step, K5 once a
   block a prefill, on wgmma. 28h, internvl2-76b (the VLM) at full
   width with 2 of its 80 layers, bf16 weights (each rank keeps its
   shard as each layer is drawn): served as 28c is, a prefill of 2 x
   (256 stub patches + 1,792 tokens) and 16 decode steps on 2,064 slots
   (1,032 a rank), the decode at the text's position (25b's control)
   read on the float32 steps; K5 once a layer a prefill, on wgmma. Its
   training under a mesh is held in tier-1 only (at full width one
   layer's fp32 weights and gradients gathered on four ranks would pass
   the card's memory).
   Printed for every part: tokens/s on the
   host clock, each rank's peak memory, each collective's calls, bytes
   and host seconds, with the card's name and power limit; four ranks on
   one card share its SMs, so nothing here speaks of scaling.
29. The dry-run (``repro_torch.launch.dryrun``, run after 28): one rank
   of three production cells (``DRYRUN_CELLS``: seamless-m4t-medium
   ``train_4k``, hymba-1.5b ``prefill_32k`` and internvl2-76b
   ``decode_32k``, the first on the 2 x 16 x 16 mesh, the others on
   16 x 16) in a process of its own, started together, as rank 0 of a
   fake world of 512 or 256 ranks (the ``fake`` backend: every
   collective returns at once, counted). Each process traces its cell on
   meta (the traces overlap); once every trace has ended, it realizes
   the cell on the card, holding a lock file so that the realized cells
   run one at a time: the rank's weights drawn from a fixed seed, its
   step run once through the hand kernels at the rank's shapes (values
   mean nothing: a gather holds the rank's own slice). Then the step
   runs again, uncounted and untimed, keeping the first K5 and K6 launch
   of each signature (causal, window, shapes) and the first K7 launch,
   and each is held against its plain version on the float32 values of
   the same inputs (``dryrun_replays``: K5 and K6 within
   ``kernels/flash_limits.py``'s limits, K7 within one bf16 ulp and its
   state within K7_STATE_RTOL; a launch whose plain scores pass
   REPLAY_SCORE_BYTES, hymba-1.5b's 32k prefill, on its first and last
   batch row's first and last head; controls that must fail: K5 and K6
   with keys and values swapped, K7 over the second half of its tokens
   without the first half's state). Held: the realized state (and
   cache) bytes equal the traced ones exactly, every collective's count
   equal, the launches exactly those the step implies (the train cell's
   4 micro-batches: K5 twice and K6 once an attention block each; the
   prefill's K5 once an attention block and K7 once a layer; the decode
   none), each on its bf16 design, every kernel the step launches held
   against its plain version, and K5, K6 and K7 each launched. Printed:
   the realized peak beside the traced one (the meta trace's counts the
   plain versions' intermediates), the step's seconds on CUDA events,
   the collectives' bytes.

K4's and K7's outputs are held within one bf16 ulp of the plain
version's (``attn_close``); K5's and K6's bf16 outputs on their wgmma
design (bf16 at head dims 64 and 128) within the limits that
``tests/test_torch_flash_rounding.py`` anchors on the Pallas kernels'
readings (``flash_close``); the prefill's log-sum-exp within LSE_TOL.
The kernels' launch counters (and K5's and K6's counts by design) are
set to 0 just before each of phases 1, 2, 12, 13, 14, 15a, 15b, 16,
27a-27e, 4, 6b, 7, 7b, 9a, 9c, 10, 17a, 18, each example of 19, 20b, 21b, 23a, 24b
and 25a (and 28a-28h on each rank, and each cell of 29 in its
process) and read just after; every bf16
launch of K5 and K6 in phases 4, 28a, 28c-28h,
6b, 10, 17a, 18, 19, 21b, 23a, 24b and 25a must have gone through the
wgmma design, and every K7 launch of 20b, 21b, 28e and 28f through
the tensor design. A segment kernel's
``launches`` is its count in the run whose launch it replays (K1 the
Linear Road run, K2 the main run, K3 the split-K run;
``launches_by_run`` gives every run's count, and every kernel's counts
in phases 17a, 18, 19, 7b, 20b, 21b, 23a, 24b and 25a), and
``launches_by_shard`` each shard's launches in phase 27 by design); K4's
and K5's are their counts in phase 4, K6's in phase 6b, K7's in phase
9a; K5's and K6's ``non_causal`` hold phase 26's replays, and K5's,
K6's and K7's ``launches_by_rank`` each rank's count in phases 28a-28h
(28e's, 28f's and 28g's training and serving together), and
``launches_by_run`` each phase-29 cell's counts. The
last line of the output is ``{"ok": true, "device": {...}}``; the line
before it holds the kernels' numbers as one JSON object, and the line
before that the card's name and power limit as ``nvidia-smi`` gives
them.
"""
from __future__ import annotations

import argparse
import contextlib
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
               on_engine=None, aion_kw: dict = None, drill=None,
               slot_devices=None, start: float = 0.0) -> dict:
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
    ``slot_devices`` (with ``aion_kw={"slot_sharding": True}``) is the
    engine's slot mesh (phase 27); the record then keeps the mesh and
    where each arena tile lies. The stream starts at processing time
    ``start`` (its events reach back before it, as the lateness model
    draws them).
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
               "deferred_events", "readmitted_events",
               "sharded_batch_executions")
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
            device=device, slot_devices=slot_devices)
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
    now = start
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
    placement = shard_placement(eng)
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
        "placement": placement,
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
    ``RECOVERY_AION`` under a ``CrashDrill`` crashing near the stream's
    half: half a checkpoint period past the last checkpoint at or before
    it, so that the restore replays the batches after that checkpoint;
    the record's ``drill`` holds its readings."""
    from repro_torch.configs.workloads import STOCK_MARKET
    step_s = run.get("step_seconds", 1.0)
    steps = int(round(windows * STOCK_MARKET.window_duration / step_s))
    every = max(int(round(CHECKPOINT_EVERY / step_s)), 1)
    drill = CrashDrill(crash_step=(steps // 2) // every * every
                       + every // 2,
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
    check(d["replayed_events"] > 0,
          f"{tag}: the crash fell on a checkpoint: nothing was replayed")
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
    """Each wrapper's launch counts to 0 (``kernels.zero_launches``)."""
    importlib.import_module("repro_torch.kernels").zero_launches(fns)


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
#: phase 6: TRAIN_ARCH at full width with 8 of its layers, four steps of
#: 2 x 4,096 tokens (6b; six until phase 29) after a gradient check on
#: 1 x 1,024 (6a)
TRAIN_RUN = dict(layers=8, batch=2, seq=4096, steps=4, grad_seq=1024)
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
#: phases 20a and 21a hold the loss within SSM_LOSS_TOL: on an H100 the
#: bf16 rounding of K7 (and in 21a of K5/K6) against the plain versions
#: moved the loss by 1.56e-4 of 17.50 (mamba2-780m, 4 layers, 1 x 4,096)
#: and 1.34e-4 of 10.88 (hymba-1.5b), past LOSS_TOL; about 3 x those
SSM_LOSS_TOL = 5e-4
#: phases 20a and 21a hold the SSD scan's gradient on the last layer's
#: own inputs (``scan_grad_check``): both sides compute in float32 from the
#: same inputs and round the gradients of bf16 inputs once to bf16, so
#: each within 1e-3 of its norm (a quarter of a bf16 ulp); on an H100
#: they read 8.0e-5 (mamba2-780m) and 5.0e-5 (hymba-1.5b)
SCAN_GRAD_RTOL = 1e-3
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


def grads_close(got, want, loss_tol: float = LOSS_TOL) -> dict:
    """(loss, grads) of the kernels' path against the plain versions':
    the loss within ``loss_tol`` (LOSS_TOL), each gradient within
    GRAD_RTOL of its norm. Returns the readings."""
    (lk, _), (lp, _) = got, want
    loss_err = abs(lk - lp)
    check(math.isfinite(lk) and loss_err <= loss_tol,
          f"loss {lk} against {lp}: beyond {loss_tol}")
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


class RoutingPin:
    """The MoE layers' routing choices (each call of ``models.moe.top_k``:
    a layer's top-k experts for every token, an expert's kept tokens),
    recorded in call order over one run and replayed in another: the
    replaying run takes the recorded indices and gathers its own values
    there (the routing weights and gates, differentiable as before). Two
    runs of one model then route alike and differ only by what else
    differs between them: the rounding of K5 and K6 against their plain
    versions, which alone can turn a near tie in the router. A model
    without MoE layers records nothing."""

    def __init__(self):
        self.calls = []

    def _patch(self, fn):
        moe = importlib.import_module("repro_torch.models.moe")
        real = moe.top_k
        moe.top_k = fn
        return moe, real

    @contextlib.contextmanager
    def record(self):
        self.calls.clear()

        def top_k(x, k):
            vals, idx = real(x, k)
            self.calls.append(idx)
            return vals, idx

        moe, real = self._patch(top_k)
        try:
            yield self
        finally:
            moe.top_k = real

    @contextlib.contextmanager
    def replay(self):
        pending = iter(self.calls)
        used = []

        def top_k(x, k):
            idx = next(pending, None)
            check(idx is not None and tuple(idx.shape) == (*x.shape[:-1], k),
                  "routing replay: the run's calls differ from the record")
            used.append(idx)
            return x.gather(-1, idx), idx

        moe, real = self._patch(top_k)
        try:
            yield self
        finally:
            moe.top_k = real
        check(len(used) == len(self.calls), f"routing replay: {len(used)} "
              f"of {len(self.calls)} recorded calls used")

    def turned(self, other: "RoutingPin") -> tuple:
        """(router rows whose set of experts differs between the two
        records, router rows in all): tokens routed otherwise, summed
        over the layers. The router's calls are those over [B, S, E]."""
        import torch
        diff = total = 0
        for a, b in zip(self.calls, other.calls):
            if a.dim() == 3:
                diff += int((a.sort(-1).values != b.sort(-1).values)
                            .any(-1).sum())
                total += a.shape[0] * a.shape[1]
        return diff, total


@contextlib.contextmanager
def fixed_order():
    """PyTorch's deterministic algorithms for the duration (warnings only
    where an operation has none): ``index_add_`` on the card, the MoE
    layer's scatter-add, then sums in a fixed order where it otherwise
    adds its bf16 contributions by atomics in any order. Two runs that
    compare K5/K6 with their plain versions take it, so that they differ
    by the kernels alone and not by the order of those sums. New tensors
    stay unfilled, as outside it."""
    import torch
    import torch.utils.deterministic as det
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


@contextlib.contextmanager
def plain_versions():
    """While entered, the model's kernels take their plain versions,
    differentiated by autograd: K5/K6 through ``ops.flash_attention_vjp``'s
    ``ref`` backend, K7 through ``ssd_scan_plain`` tiled as its design
    tiles (``kernel_chunk``; the model's chunk on the CPU)."""
    from repro_torch.kernels import ops
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    real_vjp = ops.flash_attention_vjp

    def plain_k7(i, fn, xdt, a, B, C, chunk=256, init_state=None,
                 design=None):
        q = ss.kernel_chunk(xdt.dtype, xdt.shape[-1], B.shape[-1]) \
            if xdt.is_cuda else chunk
        return ss.ssd_scan_plain(xdt, a, B, C, chunk=q,
                                 init_state=init_state)

    ops.flash_attention_vjp = functools.partial(real_vjp, backend="ref")
    try:
        with K7Tap(plain_k7):
            yield
    finally:
        ops.flash_attention_vjp = real_vjp


@contextlib.contextmanager
def dropped_state_adjoint(at: int):
    """While entered, the first ``ssd_scan_bwd`` to run (the last
    layer's: its backward runs first) loses the state's adjoint at one
    chunk boundary: call ``at`` of its reverse walk (chunk nc - 1 - at)
    passes zero to the chunk before instead of its state's gradient."""
    import torch
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    real, calls = ss._chunk_vjp, []

    def drop(*args):
        out = real(*args)
        if len(calls) == at:
            out = (*out[:4], torch.zeros_like(out[4]))
        calls.append(1)
        return out

    ss._chunk_vjp = drop
    try:
        yield calls
    finally:
        ss._chunk_vjp = real


def state_drop_at(cfg, seq: int) -> tuple:
    """(the reverse walk's call, the boundary's chunks) of the state
    adjoint that ``grad_check`` drops: the boundary in the middle of
    ``seq`` tokens in the model's chunks."""
    nc = -(-seq // cfg.ssm.chunk_size)
    mid = max(nc // 2, 1)
    return nc - 1 - mid, (mid - 1, mid)


def scan_grad_check(model, params, batch) -> dict:
    """The SSD scan's gradient on the last layer's own scan inputs (K7's
    call of the model's forward on ``batch``, kept by ``kept_launch``),
    for seeded random cotangents on y and on the final state: each of
    dxdt, da, dB, dC through K7 and ``ssd_scan_bwd`` within SCAN_GRAD_RTOL
    of its norm of the same through ``ssd_scan_plain`` (tiled as K7 tiles)
    differentiated by autograd; as a control that must read at least
    CONTROL_FACTOR times that limit, the state's adjoint dropped at the
    middle chunk boundary (``dropped_state_adjoint``)."""
    import torch
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    cfg, dev = model.cfg, model.device
    with torch.no_grad():
        args = kept_launch(lambda: model.loss(params, batch),
                           keep=cfg.num_layers - 1)
    xdt, a, B, C = (args[k] for k in ("xdt", "a", "B", "C"))
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    chunk = args["chunk"]
    q = ss.kernel_chunk(xdt.dtype, p, n) if xdt.is_cuda else chunk
    g = torch.Generator(dev).manual_seed(SEED + 20)
    dy = torch.randn(xdt.shape, generator=g, device=dev).to(xdt.dtype)
    dst = torch.randn((b, h, p, n), generator=g, device=dev)

    def vjp(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (xdt, a, B, C)]
        y, st = fn(*leaves)
        return 0.0, dict(zip(("xdt", "a", "B", "C"), torch.autograd.grad(
            (y, st), leaves, (dy, dst))))

    def kernel_fn(*t):
        return ss.ssd_scan_cuda(*t, chunk=chunk)

    kernel = vjp(kernel_fn)
    plain = vjp(lambda *t: ss.ssd_scan_plain(*t, chunk=q))
    worst, name = grads_rel(kernel, plain)
    check(worst <= SCAN_GRAD_RTOL, f"the scan's gradient d{name} is off by "
          f"{worst:.3g} of its norm, beyond {SCAN_GRAD_RTOL}")
    at, (c0, c1) = state_drop_at(cfg, s)
    with dropped_state_adjoint(at):
        bad = vjp(kernel_fn)
    bad_worst, bad_name = grads_rel(bad, plain)
    log(f"  the last layer's scan (xdt {tuple(xdt.shape)} "
        f"{str(xdt.dtype)[6:]}, chunk {chunk} against the plain version's "
        f"{q}): the worst gradient d{name} off by {worst:.3g} of its norm "
        f"(limit {SCAN_GRAD_RTOL})")
    ratio = control_reads(f"the state adjoint between chunks {c0} and "
                          f"{c1} dropped (d{bad_name})", bad_worst,
                          SCAN_GRAD_RTOL)
    return {"grad_rel_err": worst, "worst": name, "control_ratio": ratio,
            "shape": tuple(xdt.shape)}


def grad_check(model, params, run: dict) -> dict:
    """6a: one loss and backward on 1 x grad_seq tokens (with the family's
    stub embeddings, ``stub_inputs``) through the kernels (K5/K6 where the
    model has attention, K7 forward and ``ssd_scan_bwd`` where it has SSD
    layers), the same through their plain versions (``plain_versions``),
    held together by ``grads_close``; then, as controls that must each
    read at least CONTROL_FACTOR times GRAD_RTOL, the kernels' path with
    K6's dq of its first launch's first query tile zeroed (the last
    layer's, whose backward runs first; with ``run["control"] ==
    "cross_dkv"`` instead the dK and dV of every decoder layer's
    cross-attention zeroed, read on the encoder's gradients, and those of
    the last decoder layer alone, read and not held: ``cut_cross``) and
    with the state's adjoint of the last layer dropped at the boundary in
    the middle of the sequence (``dropped_state_adjoint``). An MoE model's
    plain and control runs take the kernels' run's routing
    (``RoutingPin``); the loss of the plain versions routing freely, and
    the tokens it routes otherwise, are read beside. Every run sums in a
    fixed order (``fixed_order``)."""
    import torch
    from repro_torch.data.generators import token_batches
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = model.device
    cfg = model.cfg
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(token_batches(
        cfg.vocab_size, 1, run["grad_seq"], seed=SEED + 6)).items()}
    batch.update(stub_inputs(cfg, 1, SEED + 6, dev))

    def grads():
        loss, _ = model.loss(params, batch)
        g = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, g))

    def zero_first_tile(*args, **kw):
        dq, dk, dv = real_bwd(*args, **kw)
        if not zeroed:
            dq[:, :rows] = 0
            zeroed.append(True)
        return dq, dk, dv

    def cut_cross(every_layer: bool):
        """K6 with the dK and dV of the last decoder layer's
        cross-attention zeroed (``every_layer``: of every decoder
        layer's). The backward meets each decoder layer's
        cross-attention (non-causal), then its self-attention (causal),
        the last layer first, and the encoder's layers after them."""
        def bwd(*args, **kw):
            dq, dk, dv = real_bwd(*args, **kw)
            n = len(zeroed)
            zeroed.append(True)
            if n < 2 * cfg.num_layers:
                check(kw["causal"] == bool(n % 2), f"K6 launch {n} of the "
                      "backward is not the decoder's in the order above")
                if not kw["causal"] and (every_layer or n == 0):
                    dk.zero_()
                    dv.zero_()
            return dq, dk, dv
        return bwd

    t0 = time.perf_counter()
    pin, free, zeroed = RoutingPin(), RoutingPin(), []
    rows = run.get("dq_rows", 64)
    cross = run.get("control") == "cross_dkv"
    real_bwd = fa.flash_attention_bwd_cuda
    controls = {}
    with fixed_order():
        with pin.record():
            kernel = grads()
        with plain_versions():
            with pin.replay():
                plain = grads()
            if pin.calls:
                with free.record(), torch.no_grad():
                    free_loss = float(model.loss(params, batch)[0])
        if cfg.has_attention and not cross:
            controls["control_ratio"] = (
                f"K6's dq of the last layer's first {rows} query rows "
                "zeroed", zero_first_tile)
        if cross:
            controls["last_cross_read"] = (
                "K6's dK and dV of the last decoder layer's cross-attention "
                "zeroed", cut_cross(False))
            controls["control_ratio"] = (
                "K6's dK and dV of every decoder layer's cross-attention "
                "zeroed", cut_cross(True))
        for key, (what, fn) in controls.items():
            zeroed.clear()
            fa.flash_attention_bwd_cuda = fn
            try:
                with pin.replay():
                    controls[key] = (what, grads())
            finally:
                fa.flash_attention_bwd_cuda = real_bwd
        if cfg.ssm.enabled:
            at, (c0, c1) = state_drop_at(cfg, run["grad_seq"])
            with dropped_state_adjoint(at), pin.replay():
                dropped = grads()
    rec = grads_close(kernel, plain, run.get("loss_tol", LOSS_TOL))
    if cfg.ssm.enabled:
        worst, name = grads_rel(dropped, plain)
        rec["state_drop_read"] = worst
        log(f"  read, not held: the last layer's state adjoint between "
            f"chunks {c0} and {c1} dropped moves {name} by {worst:.3g} of "
            f"its norm ({worst / GRAD_RTOL:.1f} x GRAD_RTOL)")
        rec["scan"] = scan_grad_check(model, params, batch)
    if pin.calls:
        # the forward's calls come first in both records (the remat
        # recompute's follow in the kernels' run)
        rec["free_loss_err"] = abs(free_loss - kernel[0])
        rec["turned"] = pin.turned(free)
        log(f"  routing pinned to the kernels' run; routing freely, the "
            f"plain versions' loss is off by {rec['free_loss_err']:.3g} and "
            f"route {rec['turned'][0]} of {rec['turned'][1]} (layer, token) "
            "rows otherwise")
    for key, (what, bad) in controls.items():
        ref = plain
        if cross:
            # read on the encoder's gradients: they reach the encoder
            # through those dK and dV alone
            what += ", read on the encoder's gradients"
            bad, ref = ((x[0], {n: g for n, g in x[1].items()
                                if n.startswith(("encoder.", "enc_norm."))})
                        for x in (bad, plain))
        worst, name = grads_rel(bad, ref)
        if key == "last_cross_read":
            rec[key] = worst / GRAD_RTOL
            log(f"  read, not held: {what} ({name}) moves it by {worst:.3g} "
                f"of its norm ({rec[key]:.1f} x GRAD_RTOL): the other "
                "decoder layers' cross K/V carry the rest of the encoder's "
                "gradient")
        else:
            rec[key] = control_reads(f"{what} ({name})", worst, GRAD_RTOL)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def train_run(model, params, run: dict, after=None) -> dict:
    """6b: ``make_train_step`` for run["steps"] steps on ``token_batches``
    through ``PrefetchPipeline`` (with the family's stub embeddings drawn
    on the device for each step, ``stub_inputs``: the entry point gives
    none); the loss must be finite at every step.
    Each step's forward (``model.loss``), backward (to the optimizer) and
    optimizer (``adamw_update``) are timed on the device's clock (CUDA
    events; the host's on the CPU), and so is every ``ssd_scan_bwd`` of
    the step (``ssd_bwd_s``: the SSD scan's gradient, summed). K6's first
    launch is kept for phase 8. ``after(one_step)``, where given, runs
    after the steps with a function that makes one more step, and its
    result is kept as ``after``."""
    import torch
    from repro_torch.data.generators import token_batches
    from repro_torch.data.pipeline import PrefetchPipeline
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train import train_step as ts_mod
    from repro_torch.train.optimizer import adamw_init
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
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

    marks, kept, ssd_marks = [], {}, []
    real_loss, real_update, real_bwd = (model.loss, ts_mod.adamw_update,
                                        fa.flash_attention_bwd_cuda)
    real_ssd_bwd = ss.ssd_scan_bwd

    def timed_ssd_bwd(*a, **kw):
        ssd_marks.append(stamp())
        out = real_ssd_bwd(*a, **kw)
        ssd_marks.append(stamp())
        return out

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
            # the model passes no key lengths (kv_valid_len None)
            kept.update(args=tuple(t.detach().clone()
                                   for t in (q, k, v, o, do, lse)),
                        kw={n: x for n, x in kw.items() if x is not None})
        return real_bwd(q, k, v, o, do, lse, **kw)

    state = ts_mod.TrainState(params=params, opt=adamw_init(params))
    step_fn = make_train_step(model, OptConfig(
        warmup_steps=1, total_steps=run["steps"]))
    tokens = PrefetchPipeline(token_batches(
        model.cfg.vocab_size, run["batch"], run["seq"], seed=SEED + 7),
        depth=2, device=dev)
    stubs = iter(range(SEED + 8, SEED + 8 + 10 ** 6))

    def data_next():
        return {**next(tokens), **stub_inputs(model.cfg, run["batch"],
                                              next(stubs), dev)}

    model.loss, ts_mod.adamw_update = timed_loss, timed_update
    fa.flash_attention_bwd_cuda = keep_first
    ss.ssd_scan_bwd = timed_ssd_bwd
    losses, auxes, wall, parts, ssd_bwd = [], [], [], [], []
    extra = None
    try:
        for _ in range(run["steps"]):
            marks.clear()
            ssd_marks.clear()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, data_next())
            losses.append(float(metrics["loss"]))
            auxes.append(float(metrics["aux"]))
            if cuda:
                torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            f0, f1, u0, u1 = marks
            parts.append((span(f0, f1), span(f1, u0), span(u0, u1)))
            ssd_bwd.append(sum(span(ssd_marks[i], ssd_marks[i + 1])
                               for i in range(0, len(ssd_marks), 2)))
            check(math.isfinite(losses[-1]),
                  f"step {len(losses)}: loss {losses[-1]} is not finite")
        if after is not None:
            extra = after(lambda: step_fn(state, data_next()))
    finally:
        model.loss = real_loss
        ts_mod.adamw_update = real_update
        fa.flash_attention_bwd_cuda = real_bwd
        ss.ssd_scan_bwd = real_ssd_bwd
        tokens.close()
    tokens = run["batch"] * run["seq"]
    timed = wall[1:] or wall
    return {"losses": losses, "aux": auxes, "step_s": wall,
            "tokens_per_s": tokens * len(timed) / sum(timed),
            "forward_s": [p[0] for p in parts],
            "backward_s": [p[1] for p in parts],
            "optimizer_s": [p[2] for p in parts], "ssd_bwd_s": ssd_bwd,
            "grad_norm": float(metrics["grad_norm"]), "largest_k6": kept,
            "after": extra}


def run_entry(device, tmp_root: Path, arch: str = TRAIN_ARCH) -> dict:
    """Phase 7: ``launch.train`` at its default config (reduced ``arch``,
    TRAIN_ARCH's by default; phase 7b SSM_ARCH's, as the CLI always
    trains) to ENTRY_RUN["first"] steps with
    checkpoints, then asked for ENTRY_RUN["second"]: it must resume from
    LATEST with the first run's final parameters bit for bit, and neither
    run may restart (``RestartManager`` restarts on any exception, which
    would hide a kernel fault)."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as LT
    cfg = reduced(get_config(arch))
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
#: prompt length with its batch of 32 cut to 4, then 16 decode steps; 9b:
#: prefill + one decode against a longer prefill, and a streaming prefill
#: in chunks of ``chunk`` against the whole one; 9c: long_500k's prompt cut
#: to a quarter, streamed, then 8 decode steps (32 and 16 until phase 29)
SSM_RUN = dict(batch=4, seq=32768, decode=16, check_batch=2,
               check_seq=4096, stream_seq=16384, chunk=4096,
               control_seq=4096, control_chunk=256, long_seq=131072,
               long_decode=8)
#: phase 10: HYBRID_ARCH at full width and depth: 4 prompts of 4,096
#: tokens (a multiple of its 1,024 window, so that the ring is aligned:
#: ROADMAP Queue 3), 16 decode steps (32 until phase 29) with the 16-bit
#: and the int8 cache,
#: and prefill + one decode of 2 x 4,096 against a prefill of 4,097
HYBRID_RUN = dict(batch=4, seq=4096, decode=16, check_batch=2)
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


def stub_inputs(cfg, b: int, seed: int, device) -> dict:
    """The family's stub frontend embeddings for b rows (the audio and
    enc-dec frames, the VLM's patches; none for the other families):
    [b, frontend_tokens, d_model] normal x 0.02 in bf16 from a generator
    seeded with ``seed`` on ``device``, as the JAX entry point draws
    them."""
    import torch
    from repro_torch.models.transformer import STUB_INPUTS
    key = STUB_INPUTS.get(cfg.family)
    if key is None:
        return {}
    g = torch.Generator(device).manual_seed(seed)
    return {key: (torch.randn((b, cfg.frontend_tokens, cfg.d_model),
                              generator=g, device=device) * 0.02)
            .to(torch.bfloat16)}


def serve_inputs(cfg, b: int, s: int, seed: int, device) -> tuple:
    """(the prompt batch of b x s tokens from ``_prompt`` with the
    family's stub embeddings from ``stub_inputs``, the positions ahead of
    the tokens: the VLM's patches, 0 otherwise)."""
    batch = {"tokens": _prompt(cfg, b, s, seed, device),
             **stub_inputs(cfg, b, seed + 1, device)}
    return batch, cfg.frontend_tokens if "patch_embeds" in batch else 0


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


def decode_against(gen, logits, tag: str, ref: str, prefix: str) -> dict:
    """Run ``tag``'s decode steps against run ``ref``'s (``gen``: each
    run's tokens, the prefill's first; ``logits``: each step's [B, V]):
    the share of argmaxes that agree, the largest logit difference, and
    the logits outside the JAX int8 test's rule (INT8_ATOL + INT8_RTOL x
    |logit|); printed after ``prefix``."""
    import torch
    want = torch.stack(logits[ref])
    diff = (torch.stack(logits[tag]) - want).abs()
    r = dict(against=ref,
             agree=float((torch.cat(gen[tag][1:], dim=1)
                          == torch.cat(gen[ref][1:], dim=1)).float().mean()),
             max_logit_diff=float(diff.max()),
             outside_jax_rule=int((diff > INT8_ATOL + INT8_RTOL
                                   * want.abs()).sum()))
    b, n = want.shape[1], want.shape[0]
    log(f"  {prefix}{tag} against {ref} over {b} x {n} decode logits: "
        f"argmaxes agree on {r['agree']:.4f}, max logit difference "
        f"{r['max_logit_diff']:.4g}, {r['outside_jax_rule']} logits outside "
        f"{INT8_ATOL} + {INT8_RTOL} x |logit|")
    return r


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
        r[tag].update(decode_against(gen, logits, tag, ref, ""))
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


def device_profile(fn, host: bool = True):
    """``fn`` once under ``torch.profiler``: its wall seconds and
    [(device us, calls, kernel)] by the kernels' self time, largest
    first (empty where the profiler saw no device time). ``host=False``
    traces the device alone, which costs far less over a step of tens of
    thousands of launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)               # the CPU rehearsal
    sync()
    # the CPU rehearsal traces the host: the profiler takes no empty list
    host = host or not torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
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


def profile_prefill(model, params, b: int, s: int, seed: int):
    """One prefill of b x s tokens (behind or beside the family's stub
    embeddings, ``serve_inputs``) under ``torch.profiler``; prints the
    device time by kernel (the ten largest) and the share of the wall
    time the device was busy by the sum of the kernels' times, and
    returns that share (None where the profiler saw no device time)."""
    batch, prefix = serve_inputs(model.cfg, b, s, seed, model.device)
    return log_profile(f"prefill {b} x {s}", *device_profile(
        lambda: model.prefill(params, batch, max_len=prefix + s + 1)),
        top=12)


def log_profile(what: str, wall: float, rows, top: int):
    """Prints ``device_profile``'s reading of ``what``: the share of the
    wall time the device was busy by the sum of the kernels' times, and
    the ``top`` largest kernels. Returns that share, or None where the
    profiler saw no device time."""
    if not rows:
        log("  profile: the profiler recorded no device time")
        return None
    busy = sum(r[0] for r in rows) / 1e6
    log(f"  profile: {what} in {wall * 1e3:.2f} ms (profiled), device busy "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}%) by the kernels' "
        "summed self time")
    for us, count, key in rows[:top]:
        log(f"    {us / 1e3:10.2f} ms  x{count:<5d} {key[:90]}")
    return busy / wall


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



# ------------------------------------------------------------ phases 17-19
MOE_ARCH = "qwen3-moe-30b-a3b"
#: phase 17: MOE_ARCH at full width and depth with bf16 parameters (the
#: router float32, as ``moe_init`` draws it whatever the type): 4 prompts
#: of 2,048 tokens (8,192 routed: each expert keeps 640, so experts
#: overflow and tokens are dropped), 16 greedy decode steps (32 until
#: phase 26's masked replays and 28c's swapped layouts took their time);
#: 17b on the
#: same prompts; 17c teacher forcing on 2 x 32 tokens, where the capacity
#: clamps to T and no token can be dropped
MOE_SERVE_RUN = dict(batch=4, seq=2048, decode=16, tf_batch=2, tf_seq=32)
#: phase 18: MOE_ARCH at full width with 2 of its 48 layers (fp32
#: parameters, bf16 compute, ``remat="full"``): phase 6a's gradient check
#: on 1 x 1,024, then four AdamW steps of 2 x 4,096 (six until phase 29)
MOE_TRAIN_RUN = dict(layers=2, batch=2, seq=4096, steps=4, grad_seq=1024)
#: 17b: the prefill's last logits and the first decode step's, K5 against
#: its plain version in the same bf16 model routed alike, each row within
#: MOE_LOGITS_RTOL of its norm (over the vocabulary). K5's bf16 output is
#: held within FWD_ROW_RTOL (8e-3) of its fp32 oracle per row; 48 layers
#: carry that rounding into the logits, where in two runs of this script
#: on an H100 it read 0.0135 and 0.0125 (prefill), 0.0138 and 0.0140
#: (decode), and the limit is about 3x that, as phase 9b's limits are.
#: Routing freely, the plain version routed 34% of the (layer, token) rows
#: otherwise and the rows read 0.078-0.095: a turned near tie among 128
#: experts moves a token's FFN output wholesale, so that reading is
#: printed, not held. 17c: the decode after a prefill of 31 tokens
#: against the teacher-forced logits of the 32nd (its attention the plain
#: decode product against K5; both routing freely, the scatter-add's bf16
#: atomics in no fixed order), the argmaxes equal and each row within
#: MOE_TF_RTOL of its norm: it read 0.0485 and 0.0573 in the same two
#: runs; the limit is about 3x that.
MOE_LOGITS_RTOL = 0.04
MOE_TF_RTOL = 0.15
#: phase 19: each example, the arguments it gets, and the kernels it must
#: launch (any other kernel but K1 must not launch: the engine examples
#: reach K1 only through the stacked fallback)
EXAMPLES = {
    "torch_quickstart.py": ((), ("K2",)),
    "torch_late_event_stream.py": ((), ("K2",)),
    "torch_serve_lm.py": ((), ("K4",)),
    "torch_train_lm.py": (("--steps", "40"), ("K5", "K6")),
}
#: an example's process: its kernels' counters set to 0, the script run as
#: ``__main__`` with its arguments, and the counters printed on a last
#: line after LAUNCH_TAG
LAUNCH_TAG = "chip_smoke launches: "
EXAMPLE_BOOT = """\
import json, runpy, sys
import chip_smoke
fns = chip_smoke.all_wrappers()
chip_smoke.zero_counts(fns.values())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print(chip_smoke.LAUNCH_TAG + json.dumps(dict(
    launches={k: f.launches for k, f in fns.items()},
    by_design=chip_smoke.by_design(fns))))
"""


def all_wrappers() -> dict:
    """The seven kernels' counting wrappers by key
    (``kernels.counting_wrappers``)."""
    return importlib.import_module("repro_torch.kernels").counting_wrappers()


def rows_rel(got, want, vocab: int) -> float:
    """The worst row's distance between two logits tensors [..., V] over
    the vocabulary, in units of the row's norm."""
    import torch
    a = got[..., :vocab].float().reshape(-1, vocab)
    b = want[..., :vocab].float().reshape(-1, vocab)
    check(bool(torch.isfinite(a).all()), "logits not finite")
    return float((torch.linalg.vector_norm(a - b, dim=-1)
                  / torch.linalg.vector_norm(b, dim=-1)).max())


def tf_close(got, want, vocab: int, limit: float) -> dict:
    """A decode step's logits [B, 1, V] against the teacher-forced ones:
    the argmaxes equal and each row within ``limit`` of its norm."""
    import torch
    same = bool(torch.equal(got[..., :vocab].argmax(-1),
                            want[..., :vocab].argmax(-1)))
    rel = rows_rel(got, want, vocab)
    check(same and rel <= limit, f"the decode misses teacher forcing: "
                                 f"argmax equal {same}, worst row {rel:.4g}"
                                 f" of its norm (limit {limit})")
    return dict(rel=rel, argmax_equal=same, max_abs_err=float(
        (got[..., :vocab] - want[..., :vocab]).float().abs().max()))


def model_serve(model, params, run: dict, seed: int, tag: str) -> dict:
    """17a (23a, 25a): ``make_prefill_step`` on run's batch x seq tokens
    (with the family's stub embeddings, ``serve_inputs``), then its decode
    steps through ``make_decode_step``, each timed on the host clock
    around a synchronised run. The prefill's tokens/s count the text's
    tokens; ``prefill_positions_per_s`` counts the VLM's patches too."""
    import torch
    from repro_torch.serve import make_decode_step, make_prefill_step
    cfg, dev = model.cfg, model.device
    b, s, n = run["batch"], run["seq"], run["decode"]
    batch, prefix = serve_inputs(cfg, b, s, seed, dev)
    end = prefix + s + n
    prefill = make_prefill_step(model, max_len=end)
    _sync(dev)
    t0 = time.perf_counter()
    tok, cache = prefill(params, batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, cache = decode_loop(make_decode_step(model), params, tok, cache, n)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    ids = torch.cat([tok, *out], dim=1)
    check(tuple(ids.shape) == (b, n + 1) and bool((ids >= 0).all())
          and bool((ids < cfg.vocab_size).all()),
          f"{tag}: generated ids outside the vocabulary")
    check(int(cache["pos"]) == end, f"{tag}: the cache's position is off")
    cl = cache["layers"]
    check(all(bool(torch.isfinite(cl[k][:, :, :end]).all())
              for k in ("k", "v")), f"{tag}: non-finite K/V in the cache")
    if "cross_k" in cl:
        check(tuple(cl["cross_k"].shape)[:3] == (
            cfg.num_layers, b, cfg.frontend_tokens)
              and all(bool(torch.isfinite(cl[k]).all())
                      for k in ("cross_k", "cross_v")),
              f"{tag}: the cross K/V are not every layer's over every "
              "frame, or not finite")
    return dict(prefill_s=prefill_s, prefill_tokens_per_s=b * s / prefill_s,
                prefill_positions_per_s=b * (prefix + s) / prefill_s,
                decode_s=decode_s, decode_tokens_per_s=b * n / decode_s,
                sample=ids[0, :16].tolist())


def profile_decode(model, params, b: int, s: int, seed: int):
    """One decode step after a prefill of b x s tokens (``serve_inputs``),
    under ``torch.profiler``: the device's busy share (returned) and the
    largest device operations."""
    import torch
    batch, prefix = serve_inputs(model.cfg, b, s, seed, model.device)
    logits, cache = model.prefill(params, batch, max_len=prefix + s + 1)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    return log_profile(f"one decode step at batch {b}", *device_profile(
        lambda: model.decode_step(params, nxt, cache)), top=8)


def moe_plain_check(model, params, run: dict, seed: int) -> dict:
    """17b: the prefill's last logits and the first decode step's (fed
    the prefill's greedy token) with K5 in place, against the same model,
    weights and tokens with the attention through K5's plain version,
    routed as the kernel's run routed (``RoutingPin``), all three runs
    summing in a fixed order (``fixed_order``): each row within
    MOE_LOGITS_RTOL of its norm. The plain version routing freely is read
    beside (its rows, argmaxes and the tokens it routes otherwise), not
    held: one rounding that turns a near tie in a router moves a token's
    FFN output wholesale."""
    import torch
    from repro_torch.kernels import ops
    cfg, dev = model.cfg, model.device
    b, s = run["batch"], run["seq"]
    toks = _prompt(cfg, b, s, seed, dev)

    def prefill_decode(nxt=None):
        logits, cache = model.prefill(params, {"tokens": toks},
                                      max_len=s + 1)
        if nxt is None:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        step, _ = model.decode_step(params, nxt, cache)
        return logits, step, nxt

    pin, free = RoutingPin(), RoutingPin()
    real = ops.flash_attention_vjp
    with fixed_order():
        with pin.record():
            kernel = prefill_decode()
        ops.flash_attention_vjp = functools.partial(real, backend="ref")
        try:
            with pin.replay():
                plain = prefill_decode(kernel[2])
            with free.record():
                loose = prefill_decode(kernel[2])
        finally:
            ops.flash_attention_vjp = real
    v = cfg.vocab_size
    rec = {"turned": pin.turned(free)}
    for i, what in ((0, "prefill"), (1, "decode")):
        a = kernel[i][..., :v].float()
        r = rec[what] = {}
        for how, other in (("pinned", plain), ("free", loose)):
            p = other[i][..., :v].float()
            r[how] = dict(
                rel=rows_rel(a, p, v), max_abs_err=float((a - p).abs().max()),
                argmax_agree=float((a.argmax(-1) == p.argmax(-1)).float()
                                   .mean()))
        log(f"  17b: {what} logits, K5 against its plain version routed "
            f"alike: worst row {r['pinned']['rel']:.4g} of its norm (limit "
            f"{MOE_LOGITS_RTOL}), max |diff| {r['pinned']['max_abs_err']:.4g}"
            f" of |logits| up to {float(a.abs().max()):.3g}, argmax agreeing"
            f" on {r['pinned']['argmax_agree']:.3f}; routing freely "
            f"{r['free']['rel']:.4g}, {r['free']['max_abs_err']:.4g}, "
            f"{r['free']['argmax_agree']:.3f}")
        check(r["pinned"]["rel"] <= MOE_LOGITS_RTOL,
              f"17b: {what} logits off by {r['pinned']['rel']:.4g} of their "
              "norm")
    log(f"  17b: routing freely, the plain version routes "
        f"{rec['turned'][0]} of {rec['turned'][1]} (layer, token) rows "
        "otherwise than K5's run")
    return rec


def moe_teacher_forcing(model, params, run: dict, seed: int) -> dict:
    """17c: prefill of tf_batch x (tf_seq - 1) tokens and one decode step
    against ``train_logits`` of all tf_seq at the last position. The
    capacity clamps to T in both (no token can be dropped), so the
    argmaxes must be equal. Both sum in a fixed order (``fixed_order``):
    in no fixed order the scatter's bf16 sums moved the logits by more
    than one row's two largest logits lie apart, and turned that row's
    argmax in one run on an H100."""
    import torch
    from repro_torch.models.moe import _capacity
    cfg, dev = model.cfg, model.device
    b, s = run["tf_batch"], run["tf_seq"]
    for t in (b * (s - 1), b * s):
        check(_capacity(t, cfg) == t, f"17c: capacity {_capacity(t, cfg)} "
                                      f"of {t} tokens drops some")
    toks = _prompt(cfg, b, s, seed, dev)
    with fixed_order(), torch.no_grad():
        full, _ = model.train_logits(params, {"tokens": toks})
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                 max_len=s)
        step, cache = model.decode_step(params, toks[:, -1:], cache)
    rec = tf_close(step, full[:, -1:], cfg.vocab_size, MOE_TF_RTOL)
    log(f"  17c: prefill {b} x {s - 1} + one decode against train_logits of "
        f"{b} x {s}: argmax equal, worst row {rec['rel']:.4g} of its norm "
        f"(limit {MOE_TF_RTOL}), max |diff| {rec['max_abs_err']:.4g}")
    check(int(cache["pos"]) == s, "17c: the cache's position is off")
    return rec


def moe_phases(dev, every: dict) -> dict:
    """Phases 17-18 on the card: MOE_ARCH served at full width and depth,
    then trained at full width with MOE_TRAIN_RUN's depth. ``every``
    holds the seven kernels' wrappers. Returns the runs' records."""
    import torch
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH)
    runs = {}
    # phase 17: serving at full width and depth
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 17: device memory allocated before the build "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    model, params = build_serve(dev, dataclasses.replace(
        cfg, param_dtype="bfloat16"), SEED + 17)
    n_params = sum(p.numel() for p in params.values())
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"phase 17: {model.cfg.name} at full width and depth "
        f"({cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads and {cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, "
        f"{cfg.moe.num_experts} experts of d_ff {cfg.d_ff}, top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}; bf16 parameters, the "
        f"router float32): {n_params / 1e9:.3f} B parameters, "
        f"{param_bytes / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t_phase:.1f} s")
    zero_counts(every.values())
    serve = model_serve(model, params, MOE_SERVE_RUN, SEED + 18, "17a")
    torch.cuda.synchronize()
    serve["launches"] = {k: fn.launches for k, fn in every.items()}
    serve["by_design"] = by_design(every)
    serve["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    run = MOE_SERVE_RUN
    log(f"phase 17a: prefill {run['batch']} x {run['seq']} in "
        f"{serve['prefill_s']:.3f} s ({serve['prefill_tokens_per_s']:.1f} "
        f"tokens/s), {run['decode']} decode steps in {serve['decode_s']:.3f}"
        f" s ({serve['decode_tokens_per_s']:.1f} tokens/s); launches "
        f"{serve['launches']} (K5 by design {serve['by_design']['K5']}); "
        f"max_memory_allocated {serve['max_memory_allocated'] / 1e9:.2f} GB"
        f"; sample ids {serve['sample']}")
    for k, n in serve["launches"].items():
        want = cfg.num_layers if k == "K5" else 0
        check(n == want, f"17a: {k} launched {n} times, the path implies "
                         f"{want}")
    check(serve["by_design"]["K5"] == {"wgmma": cfg.num_layers,
                                       "cuda_core": 0},
          f"17a: K5 by design {serve['by_design']['K5']}: a bf16 launch "
          "missed the wgmma design")
    profile_prefill(model, params, run["batch"], run["seq"], SEED + 18)
    profile_decode(model, params, run["batch"], run["seq"], SEED + 18)
    t0 = time.perf_counter()
    serve["plain_check"] = moe_plain_check(model, params, run, SEED + 18)
    serve["teacher_forcing"] = moe_teacher_forcing(model, params, run,
                                                   SEED + 19)
    serve["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"phase 17b-c: {time.perf_counter() - t0:.1f} s; "
        f"max_memory_allocated since the build "
        f"{serve['max_memory_allocated'] / 1e9:.2f} GB")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    serve["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 17: {serve['wall_s']:.1f} s")
    runs["moe_serve"] = serve

    # phase 18: training at full width
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = MOE_TRAIN_RUN
    model, params = build_serve(dev, dataclasses.replace(
        cfg, num_layers=run["layers"]), SEED + 20)
    n_params = sum(p.numel() for p in params.values())
    log(f"phase 18: {model.cfg.name} at full width with "
        f"{run['layers']} of {cfg.num_layers} layers (fp32 parameters, "
        f"bf16 compute, remat {model.cfg.remat!r}): {n_params / 1e9:.3f} B "
        f"parameters, built in {time.perf_counter() - t_phase:.1f} s")
    grad = grad_check(model, params, run)
    log(f"phase 18: gradient check on 1 x {run['grad_seq']} tokens, K5/K6 "
        f"against their plain versions: loss {grad['loss']:.6f} (off by "
        f"{grad['loss_err']:.3g}, limit {LOSS_TOL}), the worst gradient "
        f"{grad['worst_param']} off by {grad['grad_rel_err']:.3g} of its "
        f"norm (limit {GRAD_RTOL}), {grad['seconds']:.1f} s")
    zero_counts(every.values())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = train_run(model, params, run)
    torch.cuda.synchronize()
    train["launches"] = {k: fn.launches for k, fn in every.items()}
    train["by_design"] = by_design(every)
    train["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    train["wall_s"] = time.perf_counter() - t0
    train.pop("largest_k6")
    train["grad_check"] = grad
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 18: {run['steps']} steps of {run['batch']} x {run['seq']} "
        f"tokens in {train['wall_s']:.1f} s: losses "
        f"{[round(x, 4) for x in train['losses']]}, aux "
        f"{[round(x, 5) for x in train['aux']]}, "
        f"{train['tokens_per_s']:.1f} tokens/s over steps 2-{run['steps']}"
        f", launches {train['launches']} (by design {train['by_design']}), "
        f"max_memory_allocated {train['max_memory_allocated'] / 1e9:.2f} GB")
    log("  step seconds (wall / forward / backward / optimizer): " + "; ".join(
        f"{w:.3f} / {f:.3f} / {b:.3f} / {o:.3f}" for w, f, b, o in zip(
            train["step_s"], train["forward_s"], train["backward_s"],
            train["optimizer_s"])))
    check(all(a > 0 for a in train["aux"]), f"18: aux {train['aux']}")
    per_step = {"K5": 2 * run["layers"], "K6": run["layers"]}
    for k, n in train["launches"].items():
        want = per_step.get(k, 0) * run["steps"]
        check(n == want, f"18: {k} launched {n} times, the path implies "
                         f"{want}")
    for k in ("K5", "K6"):
        check(train["by_design"][k] == {"wgmma": train["launches"][k],
                                        "cuda_core": 0},
              f"18: {k} by design {train['by_design'][k]}: a bf16 launch "
              "missed the wgmma design")
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    runs["moe_train"] = train
    return runs


def start_example(name: str, args) -> tuple:
    """One example started in its own process (``PYTHONPATH=src``)
    through EXAMPLE_BOOT: (the process, its start time)."""
    import os
    return subprocess.Popen(
        [sys.executable, "-c", EXAMPLE_BOOT,
         str(ROOT / "examples" / name), *args],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def finish_example(name: str, started: tuple) -> dict:
    """``start_example``'s process waited for; it must exit 0. Returns
    its output, seconds from its start and launch counts."""
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"19: {name} exited {proc.returncode}: "
                                f"{stderr[-2000:]}")
    out, _, tail = stdout.rpartition(LAUNCH_TAG)
    check(bool(out), f"19: {name} printed no launch counts")
    return dict(json.loads(tail), out=out, seconds=seconds)



def example_lines(name: str, out: str) -> str:
    """Each example's closing lines, checked; returns the line read."""
    import re
    if name == "torch_quickstart.py":
        m = re.search(r"^executions: live=(\d+) late=(\d+) purged=(\d+)$",
                      out, re.M)
        check(bool(m) and int(m.group(2)) > 0 and "\nwindow [" in out,
              f"19: {name}: no executions line with late > 0")
    elif name == "torch_late_event_stream.py":
        m = re.search(r"^  no-pre-stgng\s+fetch_stall=.*$", out, re.M)
        check(bool(m) and "aion-full" in out and "bound 0.01" in out,
              f"19: {name}: its demos did not all print")
    elif name == "torch_serve_lm.py":
        m = re.search(r"^completed 8/8 requests.*$", out, re.M)
        check(bool(m) and "\ntiering: " in out,
              f"19: {name}: not every request completed")
    else:
        m = re.search(r"^loss: ([\d.]+) -> ([\d.]+) .*$", out, re.M)
        check(bool(m) and float(m.group(2)) < float(m.group(1)),
              f"19: {name}: the loss did not fall")
    return m.group(0)


def examples_phase() -> dict:
    """Phase 19: the four examples on the card, each in its own process,
    the four at once (their startups overlap; each prints its own
    rates, which the others' share of the card and the host moves), each
    with the kernels EXAMPLES names launched (K5 and K6 on wgmma, K4 on
    the CUDA-core design its float32 pages take) and no other but K1."""
    runs = {}
    started = {name: start_example(name, args)
               for name, (args, _) in EXAMPLES.items()}
    try:
        done = {name: finish_example(name, st)
                for name, st in started.items()}
    finally:
        for proc, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name, (args, need) in EXAMPLES.items():
        r = done[name]
        line = example_lines(name, r.pop("out"))
        n = r["launches"]
        log(f"phase 19: {name} {' '.join(args)} in {r['seconds']:.1f} s: "
            f"{line.strip()} | launches {n} (by design {r['by_design']})")
        for k, count in n.items():
            check(count > 0 if k in need else (count == 0 or k == "K1"),
                  f"19: {name} launched {k} {count} times")
        for k in set(need) & {"K5", "K6"}:
            check(r["by_design"][k]["wgmma"] == n[k],
                  f"19: {name}: {k} by design {r['by_design'][k]}")
        if "K4" in need:
            check(r["by_design"]["K4"]["cuda_core"] == n["K4"],
                  f"19: {name}: K4 by design {r['by_design']['K4']}")
        runs[name] = dict(r, line=line.strip())
    return runs


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


# ------------------------------------------------------------------ phase 27
#: the slot mesh of phase 27: four entries
SHARDS = 4
#: phase 27's sum tolerance against the plain unsharded fold (count, min
#: and max must be equal)
SHARD_SUM_RTOL, SHARD_SUM_ATOL = 1e-5, 1e-6
#: the sharded folds of ``repro_torch.kernels.ops`` that the recorder
#: wraps, and the kernel each launches once a shard
SHARDED_FOLDS = {
    "segment_aggregate_block_table_sharded": None,     # K2, or K3
    "segment_aggregate_batched_sharded": "K1",
    "segment_aggregate_batched_splitk_sharded": "K1 balanced",
}


def shard_placement(eng):
    """The engine's slot mesh and where each arena tile lies (None
    without a mesh)."""
    mesh = eng.slot_mesh
    if mesh is None:
        return None
    pool = eng.pool
    return {"mesh": [str(d) for d in mesh.devices],
            "tiles": None if pool is None else [
                [str(k.device), str(v.device)]
                for k, v in zip(pool.key_tiles, pool.value_tiles)],
            "shards": None if pool is None else pool.num_shards}


def slot_mesh_devices(count: int) -> list:
    """Phase 27's mesh: the first SHARDS cards where there are that many,
    else the one card named SHARDS times."""
    if count >= SHARDS:
        return [f"cuda:{i}" for i in range(SHARDS)]
    return ["cuda:0"] * SHARDS


class ShardRecorder:
    """Wraps the slot-sharded folds of ``repro_torch.kernels.ops`` while
    it is entered: keeps each kernel's largest sharded call (most rows),
    as ``LaunchRecorder`` keeps an unsharded one, and the rows each shard
    received (padded, and live: with a valid event), summed on the
    device."""

    def __init__(self):
        self.largest = {}
        self.rows = {}
        self._live = {}
        self._saved = {}

    def __enter__(self):
        ops = importlib.import_module("repro_torch.kernels.ops")
        for name, key in SHARDED_FOLDS.items():
            fn = getattr(ops, name)
            self._saved[name] = fn
            setattr(ops, name, self._wrap(key, fn))
        return self

    def __exit__(self, *exc):
        ops = importlib.import_module("repro_torch.kernels.ops")
        for name, fn in self._saved.items():
            setattr(ops, name, fn)
        return False

    def live_rows(self) -> dict:
        return {k: [int(x) for x in v.tolist()]
                for k, v in self._live.items()}

    def _wrap(self, key, fn):
        def recorded(*args, **kw):
            self._keep(key, args, kw)
            return fn(*args, **kw)
        return recorded

    def _keep(self, key, args, kw) -> None:
        import torch
        ops = importlib.import_module("repro_torch.core.operators")
        mesh = kw["mesh"]
        table = args[2] if key is None else None
        if key is None:
            key = "K3" if kw.get("chunk_rows", 0) > 0 else "K2"
        rows = (table if table is not None else args[0]).shape[0]
        valid = kw["valid"]
        per = rows // mesh.size
        self.rows[key] = [n + per for n in self.rows.get(
            key, [0] * mesh.size)]
        live = valid.reshape(mesh.size, per, -1).any(2).sum(1)
        self._live[key] = self._live[key] + live if key in self._live \
            else live
        if rows <= self.largest.get(key, {}).get("rows", 0):
            return
        rec = {"rows": rows, "mesh": mesh, "num_segments": args[3]
               if table is not None else args[2],
               "num_slots": kw["num_slots"], "stats": tuple(kw["stats"]),
               "segment_ids": args[1].clone(), "valid": valid.clone(),
               "slot_ids": kw["slot_ids"].clone()}
        if table is None:
            rec["values"] = args[0].clone()
        else:
            arena = args[0]
            tiles = [arena] if isinstance(arena, torch.Tensor) else arena
            cols = kw.get("num_cols") or tiles[0].shape[2]
            rec.update(arena_shape=(sum(t.shape[0] for t in tiles),
                                    *tiles[0].shape[1:]),
                       num_cols=kw.get("num_cols"), table=table.clone(),
                       chunk_rows=kw.get("chunk_rows", 0),
                       values=ops._take_rows(
                           arena if isinstance(arena, torch.Tensor)
                           else tuple(arena), table)[:, :, :cols].clone())
        self.largest[key] = rec


def shard_replay(key: str, rec: dict, g) -> float:
    """A recorded sharded call replayed on the card through the sharded
    wrapper (the kernel once a shard) and unsharded through the plain
    version on the same inputs: count, min and max equal, sum within
    SHARD_SUM_RTOL x |ref| + SHARD_SUM_ATOL. K2/K3 get the recorded
    arena with one more slot a shard, random in its unread columns, the
    recorded columns in the slots the live rows name (each one slot up in
    its shard's range), and NaN in every tile's first slot, which the
    rows with no valid event (the padding) name: they must stay inert.
    Returns the largest absolute error."""
    import torch
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    mesh, valid = rec["mesh"], rec["valid"]
    dev = valid.device
    kw = dict(valid=valid, slot_ids=rec["slot_ids"],
              num_slots=rec["num_slots"], stats=rec["stats"])
    if key in ("K1", "K1 balanced"):
        fold = sa.segment_aggregate_batched_sharded if key == "K1" \
            else sa.segment_aggregate_batched_splitk_sharded
        args = (rec["values"], rec["segment_ids"], rec["num_segments"])
        out = fold(*args, mesh=mesh, **kw)
        ref = sa.segment_aggregate_batched_plain(*args, **kw)
    else:
        p, cap, w = rec["arena_shape"]
        per = p // mesh.size
        table = rec["table"].long()
        live = valid.any(1)
        shard = table // per
        table = torch.where(live, shard * (per + 1) + table % per + 1,
                            shard * (per + 1)).to(torch.int32)
        arena = torch.rand((p + mesh.size, cap, w), generator=g,
                           device=dev) * 490.0 + 10.0
        cols = rec["values"].shape[2]
        arena[table[live].long(), :, :cols] = rec["values"][live]
        arena[::per + 1] = float("nan")
        tiles = arena if len(set(mesh.devices)) == 1 else tuple(
            t.to(d) for t, d in zip(arena.chunk(mesh.size), mesh.devices))
        args = (rec["segment_ids"], table, rec["num_segments"])
        out = sa.segment_aggregate_block_table_sharded(
            tiles, *args, mesh=mesh, num_cols=rec["num_cols"],
            chunk_rows=rec["chunk_rows"], **kw)
        ref = sa.segment_aggregate_block_table_plain(
            arena, *args, num_cols=rec["num_cols"], **kw)
        check(not any(bool(torch.isnan(v).any()) for v in out.values()),
              f"{key}: a padding row read a tile's NaN-poisoned first slot")
    check(set(out) == set(ref), f"{key}: stats {sorted(out)}")
    worst = 0.0
    for k, b in ref.items():
        a = out[k].to(b.device)
        check(a.shape == b.shape, f"{key} {k}: shape {tuple(a.shape)} != "
                                  f"{tuple(b.shape)}")
        if k != "sum":
            check(torch.equal(a, b), f"{key} {k}: the sharded fold is not "
                                     "equal to the plain unsharded one")
            continue
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a)),
              f"{key} sum: finite entries differ")
        diff = (a[fin] - b[fin]).abs()
        check(bool((diff <= SHARD_SUM_RTOL * b[fin].abs()
                    + SHARD_SUM_ATOL).all()),
              f"{key} sum: max error {float(diff.max())} beyond rtol "
              f"{SHARD_SUM_RTOL} + atol {SHARD_SUM_ATOL}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


#: where phase 27's streams start, in processing time. A pooled window
#: lands on the shard ``shard_of_window`` hashes it to, and a stream from
#: 0 reaches too few windows to give every shard one (stock's first six
#: hash to shards 1, 3, 2, 2, 2, 0). From 300 s, stock's live windows
#: 10-12 hash to shards 0, 1 and 3 and its late window 7 to shard 2; from
#: 420 s, Linear Road's live windows 7 and 8 hash to 2 and 1 and its late
#: windows 5 and 6 to 3 and 0. Events still reach back to 0, so the
#: unpooled rounds fold more windows than the mesh has entries.
SHARDED_START = {"stock": 300.0, "lrb": 420.0}

#: phase 27's sub-phases: tag, run tag, seed, run_stream's arguments
#: (``aion_kw`` beside ``slot_sharding``), and the kernels that must
#: launch, and fold live rows, on every shard
SHARDED_RUNS = (
    ("27a", "sharded_pooled", SEED + 2,
     dict(pool_slots=3072, splitk=0, pipelined=True), ("K2",)),
    ("27b", "sharded_splitk", SEED + 3,
     dict(pool_slots=1024, splitk=64), ("K3",)),
    ("27c", "sharded_lrb", SEED + 12,
     dict(operator="lrb", pool_slots=4096, splitk=0), ("K1",)),
    ("27d", "sharded_stacked", SEED + 2,
     dict(pool_slots=3072, splitk=0, aion_kw={"block_pool": False}),
     ("K1",)),
    ("27e", "sharded_balanced", SEED + 3,
     dict(pool_slots=1024, splitk=64, aion_kw={"block_pool": False}),
     ("K1 balanced",)),
)


def sharded_phases(dev, spill_root: Path, windows: dict, main_rate: float,
                   wrappers: dict, devices: list, runs=SHARDED_RUNS,
                   **run) -> dict:
    """Phase 27: phase 1's deployment (27a, 27b, 27d, 27e) and phase
    12's (27c) with ``slot_sharding=True`` on the mesh ``devices``
    (SHARDS entries), each stream from its ``SHARDED_START``: every
    window against the oracle (``run_stream``), sharded rounds counted,
    every shard's launches of the kernels the sub-phase shards and the
    live rows each folded, every arena tile on its mesh entry, and the
    largest sharded call of each kernel replayed against the plain
    unsharded fold (``shard_replay``). ``runs`` replaces
    ``SHARDED_RUNS`` and ``run`` goes to ``run_stream`` (a CPU
    rehearsal's smaller pools, chunks, rate and width); on the CPU no
    kernel launches, so the launch counts are read but not held."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 27)
    out = {}
    for phase, tag, seed, kw, need in runs:
        zero_counts(wrappers.values())
        t0 = time.perf_counter()
        aion_kw = {"slot_sharding": True, **kw.get("aion_kw", {})}
        pooled = aion_kw.get("block_pool", True)
        with ShardRecorder() as recorder:
            rec = run_stream(
                dev, seed=seed, spill_root=spill_root,
                windows=windows[phase], profile=True,
                start=SHARDED_START[kw.get("operator", "stock")],
                slot_devices=devices,
                **{**kw, "aion_kw": aion_kw}, **run)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
        rec["by_design"] = by_design(wrappers)
        rec["by_shard"] = {k: {d: dict(n) for d, n in
                               fn.launches_by_shard.items()}
                           for k, fn in wrappers.items()}
        rec["shard_rows"] = recorder.rows
        rec["shard_live_rows"] = recorder.live_rows()
        rec["profile"] = fold_profile(rec) if rec["profile"] else None
        place = rec["placement"]
        log(f"phase {phase}: {tag} run in {rec['wall_s']:.1f} s, "
            f"{rec['events_per_s']:.1f} events/s (phase 1, unsharded, this "
            f"run: {main_rate:.1f}), sharded rounds "
            f"{rec['counts']['sharded_batch_executions']} of "
            f"{rec['counts']['batch_executions']}; launches "
            f"{rec['launches']} (by design {rec['by_design']})")
        log(f"  {tag}: launches by shard and design "
            + json.dumps(rec["by_shard"]) + "; rows by shard (padded) "
            + json.dumps(rec["shard_rows"]) + ", live "
            + json.dumps(rec["shard_live_rows"]))
        log(f"  {tag}: mesh {place['mesh'] if place else None}, arena tiles "
            f"{place['tiles'] if place else None}")
        _print_run(tag, rec)
        pr = rec["profile"]
        log(f"  {tag}: the close-out's re-execution of every window: "
            + ("the profiler recorded no device time" if pr is None else
               f"{pr['wall_s']:.3f} s wall, device busy {pr['busy_s']:.4f} "
               f"s ({100 * pr['busy_share']:.1f}%)"))
        c = rec["counts"]
        check(place is not None
              and place["mesh"] == [str(torch.device(d)) for d in devices],
              f"{tag}: no slot mesh of {devices}: {place}")
        if pooled:
            check(place["shards"] == SHARDS and all(
                k == v == d for (k, v), d in zip(place["tiles"],
                                                 place["mesh"])),
                  f"{tag}: the arena is not {SHARDS} tiles, each on its "
                  f"mesh entry: {place}")
            check(c["pooled_rows"] > 0, f"{tag}: no pooled rows")
        else:
            check(place["tiles"] is None and c["pooled_rows"] == 0,
                  f"{tag}: a block pool in an unpooled run: {place}")
        check(c["sharded_batch_executions"] > 0, f"{tag}: no sharded round")
        for key in need:
            per = rec["by_shard"][key.split()[0]]
            live = rec["shard_live_rows"].get(key, [])
            check(key in recorder.largest,
                  f"{tag}: {key} never ran sharded")
            check(len(live) == SHARDS and min(live) > 0,
                  f"{tag}: {key} folded live rows {live} by shard: a shard "
                  "folded only padding")
            check(dev.type != "cuda" or (
                sorted(per) == list(range(SHARDS)) and all(
                    sum(n.values()) > 0 for n in per.values())),
                f"{tag}: {key} did not launch on every shard: {per}")
        rec["replays"] = {}
        for key, largest in recorder.largest.items():
            err = shard_replay(key, largest, g)
            rec["replays"][key] = {"rows": largest["rows"],
                                   "max_abs_err": err}
            log(f"  {tag}: {key}'s largest sharded call ({largest['rows']} "
                f"rows, {largest['num_slots']} slots) replayed against the "
                f"plain unsharded fold: count/min/max equal, sum max error "
                f"{err:.3g} (rtol {SHARD_SUM_RTOL}, atol {SHARD_SUM_ATOL})")
        del recorder
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[tag] = rec
    return out


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


# ------------------------------------------------------------ phases 20-22
#: phases 20 and 21: SSM_ARCH and HYBRID_ARCH trained at full width and
#: depth (fp32 parameters, bf16 compute, ``remat="full"``): the gradient
#: check (a) on 1 x grad_seq tokens through grad_layers of the layers,
#: then (b) two steps of 2 x 4,096 tokens (cut from six to pay for 28e and
#: 28f) and one more step profiled
SSM_TRAIN_RUN = dict(batch=2, seq=4096, steps=2, grad_seq=4096,
                     grad_layers=4, loss_tol=SSM_LOSS_TOL)
#: 21a's zeroed-dq control drops K6's first dq block of the wgmma design
#: (DQ_TILES: 128 query rows): 6a's 64 rows read below CONTROL_FACTOR at
#: hymba-1.5b's 4,096 tokens on an H100
HYBRID_TRAIN_RUN = dict(SSM_TRAIN_RUN, dq_rows=128)
#: phase 22: SSM_ARCH at full width with 4 layers on 1 x 4,096 tokens:
#: each remat mode against "none", then two compressed steps of each kind
SWITCH_RUN = dict(layers=4, seq=4096, steps=2, topk_frac=0.01)
#: each remat mode's gradients against "none"'s, in units of their norm
REMAT_RTOL = 1e-3
REMAT_MODES = {"none": ("none", 0), "full": ("full", 0),
               "dots": ("dots", 0), "remat_group=2": ("full", 2)}
#: an int8 element sent against its target, in quantization steps: half
#: a step, and the float32 rounding of q x scale (up to half an ulp of
#: 127 steps, below 2**-17 of a step)
INT8_STEPS = 0.5 + 2.0 ** -16
#: their CPU rehearsal (reduced widths: chunk 32)
SMALL_SSM_TRAIN = dict(batch=2, seq=96, steps=3, grad_seq=96,
                       grad_layers=2, loss_tol=SSM_LOSS_TOL)
SMALL_SWITCH = dict(layers=4, seq=96, steps=2, topk_frac=0.01)
#: K7's kernels by name (the tensor design's three, the CUDA-core one)
K7_KERNEL_NAMES = ("chunk_state_kernel", "state_pass_kernel",
                   "output_kernel", "ssd_scan_kernel")


def ssm_profile(one_step) -> dict:
    """One more training step under ``torch.profiler``: the wall, the
    device busy share by the kernels' summed self time, K7's device time
    and the ten largest kernels; the device alone is traced."""
    t0 = time.perf_counter()
    wall, rows = device_profile(one_step, host=False)
    log(f"  profiled one step in {time.perf_counter() - t0:.1f} s, the "
        "trace's reading included")
    busy = sum(r[0] for r in rows) / 1e6
    k7 = sum(r[0] for r in rows if any(k in r[2] for k in K7_KERNEL_NAMES))
    return {"wall_s": wall, "busy_s": busy,
            "busy_share": busy / wall if rows else None,
            "k7_ms": k7 / 1e3, "top": rows[:10]}


def ssm_train(device, cfg, run: dict, seed: int, every: dict,
              phase: int) -> dict:
    """Phase 20 (21): ``cfg`` trained at full width. (a) ``grad_check``
    at grad_layers layers; (b) at full depth, ``train_run``'s steps with
    every kernel's launches counted (K7 on the tensor design twice a
    layer and step under ``remat="full"``, K5 twice and K6 once on wgmma
    where the model has attention), then one step profiled; the
    backward's share of a step is ``ssd_scan_bwd``'s device time over
    the step's wall, in steps 2 onwards."""
    import torch
    t_phase = time.perf_counter()
    model, params = build_serve(device, dataclasses.replace(
        cfg, num_layers=run["grad_layers"]), seed)
    grad = grad_check(model, params, run)
    log(f"phase {phase}a: gradient check on 1 x {run['grad_seq']} tokens "
        f"through {run['grad_layers']} layers, the kernels against their "
        f"plain versions: loss {grad['loss']:.6f} (off by "
        f"{grad['loss_err']:.3g}, limit {run['loss_tol']}), the worst "
        f"gradient {grad['worst_param']} off by {grad['grad_rel_err']:.3g} "
        f"of its norm (limit {GRAD_RTOL}), {grad['seconds']:.1f} s")
    del model, params
    gc.collect()
    _empty(device)
    t0 = time.perf_counter()
    model, params = build_serve(device, cfg, seed + 1)
    n_params = sum(p.numel() for p in params.values())
    log(f"phase {phase}: {cfg.name} at full width and depth "
        f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSD heads of "
        f"{cfg.ssm.head_dim}, state "
        f"{cfg.ssm.state_size}"
        + (f", {cfg.num_heads} heads with {cfg.num_kv_heads} KV heads of "
           f"{cfg.resolved_head_dim}, window {cfg.attn_window}"
           if cfg.has_attention else "")
        + f"; fp32 parameters, bf16 compute, remat {cfg.remat!r}): "
        f"{n_params / 1e9:.3f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    zero_counts(every.values())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    seen = {}

    def after(one_step):
        seen["launches"] = {k: fn.launches for k, fn in every.items()}
        seen["by_design"] = by_design(every)
        seen["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
            if device.type == "cuda" else 0
        return ssm_profile(one_step)

    t0 = time.perf_counter()
    train = train_run(model, params, run, after=after)
    train.update(seen)
    train["wall_s"] = time.perf_counter() - t0
    train.pop("largest_k6")
    train["grad_check"] = grad
    del model, params
    gc.collect()
    _empty(device)
    timed = slice(1, None) if len(train["step_s"]) > 1 else slice(None)
    train["ssd_bwd_share"] = sum(train["ssd_bwd_s"][timed]) \
        / sum(train["step_s"][timed])
    log(f"phase {phase}b: {run['steps']} steps of {run['batch']} x "
        f"{run['seq']} tokens: losses "
        f"{[round(x, 4) for x in train['losses']]}, "
        f"{train['tokens_per_s']:.1f} tokens/s over steps 2-{run['steps']}"
        f", launches {train['launches']} (by design {train['by_design']}), "
        f"max_memory_allocated {train['max_memory_allocated'] / 1e9:.2f} GB")
    log("  step seconds (wall / forward / backward / optimizer / "
        "ssd_scan_bwd): " + "; ".join(
            f"{w:.3f} / {f:.3f} / {b:.3f} / {o:.3f} / {d:.3f}"
            for w, f, b, o, d in zip(
                train["step_s"], train["forward_s"], train["backward_s"],
                train["optimizer_s"], train["ssd_bwd_s"])))
    log(f"  ssd_scan_bwd's share of a step (steps 2-{run['steps']}, device "
        f"time over the step's wall): {100 * train['ssd_bwd_share']:.1f}%")
    pr = train["after"]
    if pr["busy_share"] is None:
        log("  profile: the profiler recorded no device time")
    else:
        log(f"  profile of one more step: {pr['wall_s']:.3f} s wall, device "
            f"busy {pr['busy_s']:.3f} s ({100 * pr['busy_share']:.1f}%), K7 "
            f"{pr['k7_ms']:.2f} ms")
        for us, count, key in pr["top"]:
            log(f"    {us / 1e3:10.2f} ms  x{count:<6d} {key[:90]}")
    layers = cfg.num_layers
    per_step = {"K7": 2 * layers}
    if cfg.has_attention:
        per_step.update(K5=2 * layers, K6=layers)
    if device.type == "cuda":             # on the CPU nothing launches
        for k, n in train["launches"].items():
            want = per_step.get(k, 0) * run["steps"]
            check(n == want, f"{phase}b: {k} launched {n} times, the path "
                             f"implies {want}")
        for k in per_step:
            design = "tensor" if k == "K7" else "wgmma"
            check(train["by_design"][k].get(design) == train["launches"][k],
                  f"{phase}b: {k} by design {train['by_design'][k]}: a "
                  f"launch missed the {design} design")
    train["phase_s"] = time.perf_counter() - t_phase
    log(f"phase {phase}: {train['phase_s']:.1f} s")
    return train


def _empty(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.empty_cache()


def remat_modes(device, cfg, run: dict, seed: int) -> dict:
    """22a: the loss and every gradient on 1 x seq tokens under each of
    REMAT_MODES, the same weights, against ``"none"``'s: each gradient
    within REMAT_RTOL of its norm, and whether they are bit for bit
    equal. Each mode's peak of allocated device memory above what was
    allocated before it (the parameters, and ``"none"``'s gradients for
    the later modes) is read: ``dots`` should lie between ``none`` and
    ``full``."""
    import torch
    from repro_torch.data.generators import token_batches
    from repro_torch.models import build_model
    cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    _, params = build_serve(device, cfg, seed)
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(
        token_batches(cfg.vocab_size, 1, run["seq"], seed=seed)).items()}
    out, ref = {}, None
    for mode, (remat, group) in REMAT_MODES.items():
        gc.collect()
        _empty(device)
        base = torch.cuda.memory_allocated() if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            remat_group=group, device=device)
        t0 = time.perf_counter()
        loss, _ = model.loss(params, batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        _sync(device)
        peak = torch.cuda.max_memory_allocated() - base \
            if device.type == "cuda" else 0
        r = {"loss": float(loss.detach()), "seconds":
             time.perf_counter() - t0, "peak": peak}
        check(math.isfinite(r["loss"]), f"22a: {mode}: loss {r['loss']}")
        if ref is None:
            ref = (r["loss"], grads)
        else:
            worst, name = grads_rel((r["loss"], grads), ref)
            r.update(grad_rel_err=worst, worst_param=name,
                     loss_err=abs(r["loss"] - ref[0]),
                     bit_equal=r["loss"] == ref[0] and all(
                         torch.equal(grads[k], ref[1][k]) for k in grads))
            check(worst <= REMAT_RTOL, f"22a: {mode}: the gradient of {name} "
                  f"is off by {worst:.3g} of its norm from remat 'none''s, "
                  f"beyond {REMAT_RTOL}")
        del loss, grads, model
        out[mode] = r
        log(f"phase 22a: {mode}: loss {r['loss']:.6f}, peak allocated "
            f"above the parameters {r['peak'] / 1e9:.3f} GB, "
            f"{r['seconds']:.2f} s"
            + ("" if mode == "none" else
               f"; against 'none': the worst gradient {r['worst_param']} "
               f"off by {r['grad_rel_err']:.3g} of its norm (limit "
               f"{REMAT_RTOL}), bit for bit equal {r['bit_equal']}"))
    del ref, params
    held = out["none"]["peak"] >= out["dots"]["peak"] >= out["full"]["peak"]
    log(f"phase 22a: the prediction, dots' peak between none's and full's: "
        f"{'held' if held else 'missed'}")
    out["dots_between"] = held
    return out


def compressed_steps(device, cfg, run: dict, seed: int) -> dict:
    """22b: ``make_train_step`` with ``compress_grads`` (error feedback
    on) as its ``grad_transform``, run["steps"] steps of 1 x seq tokens
    for each of ``int8`` and ``topk`` (run["topk_frac"]) on fresh weights.
    Every step, for each JAX leaf (the layers of a stacked name
    together, ``compression.leaves``): the loss finite; every sent int8
    element within half a quantization step (the leaf's largest |target|
    / 127) of its target (gradient + error feedback); the new error
    feedback equal to target - sent; the top-k output keeping at least k
    of the leaf's elements, each equal to its target and at or above the
    leaf's k-th largest |target|, and zero elsewhere."""
    import torch
    from repro_torch.data.generators import token_batches
    from repro_torch.data.pipeline import PrefetchPipeline
    from repro_torch.train import (
        CompressorConfig, OptConfig, compress_grads, init_error_feedback,
        make_train_step,
    )
    from repro_torch.train.compression import leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainState
    cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    out = {}
    for kind in ("int8", "topk"):
        ccfg = CompressorConfig(kind=kind, topk_frac=run["topk_frac"])
        model, params = build_serve(device, cfg, seed)
        ef = [init_error_feedback(params)]
        seen = {"int8_steps": 0.0, "kept": 0, "k": 0, "tensors": 0}

        def transform(grads):
            targets = {k: g.float() + ef[0][k] for k, g in grads.items()}
            sent, new_ef = compress_grads(ccfg, grads, ef[0])
            # one scale and one threshold for each JAX leaf: every layer
            # of a stacked name together
            for leaf, names in leaves(targets).items():
                ts = [targets[k] for k in names]
                for k, t in zip(names, ts):
                    check(torch.equal(new_ef[k], t - sent[k]), f"22b: "
                          f"{kind}: {k}: the new error feedback is not "
                          "target - sent")
                if kind == "int8":
                    step = max(float(t.abs().max()) for t in ts) / 127.0 \
                        + 1e-12
                    err = max(float((sent[k] - t).abs().max())
                              for k, t in zip(names, ts)) / step
                    check(err <= INT8_STEPS, f"22b: int8: {leaf}: an "
                          f"element {err:.6f} steps from its target")
                    seen["int8_steps"] = max(seen["int8_steps"], err)
                else:
                    n_k = max(int(sum(t.numel() for t in ts)
                                  * ccfg.topk_frac), 1)
                    thresh = torch.topk(torch.cat(
                        [t.abs().reshape(-1) for t in ts]), n_k).values[-1]
                    n_kept = 0
                    for k, t in zip(names, ts):
                        kept = (sent[k] == t) & (t.abs() >= thresh)
                        check(not bool(sent[k][~kept].any()), f"22b: topk: "
                              f"{k}: a value sent below the threshold")
                        n_kept += int(kept.sum())
                    check(n_kept >= n_k, f"22b: topk: {leaf}: {n_kept} "
                                         f"kept of k = {n_k}")
                    seen["kept"] += n_kept
                    seen["k"] += n_k
                seen["tensors"] += 1
            ef[0] = new_ef
            return sent

        step_fn = make_train_step(model, OptConfig(warmup_steps=1),
                                  grad_transform=transform)
        state = TrainState(params=params, opt=adamw_init(params))
        data = PrefetchPipeline(token_batches(cfg.vocab_size, 1, run["seq"],
                                              seed=seed), depth=1,
                                device=device)
        losses = []
        try:
            for _ in range(run["steps"]):
                state, metrics = step_fn(state, next(data))
                losses.append(float(metrics["loss"]))
                check(math.isfinite(losses[-1]),
                      f"22b: {kind}: loss {losses[-1]}")
        finally:
            data.close()
        ef_norm = math.sqrt(sum(float(e.square().sum())
                                for e in ef[0].values()))
        out[kind] = dict(seen, losses=losses, ef_norm=ef_norm)
        del model, params, state, ef
        gc.collect()
        _empty(device)
        log(f"phase 22b: {kind}: {run['steps']} steps, losses "
            f"{[round(x, 4) for x in losses]}, error feedback's norm after "
            f"them {ef_norm:.4g}; "
            + (f"every sent element within {seen['int8_steps']:.6f} of a "
               f"quantization step of its target (limit {INT8_STEPS:.6f})"
               if kind == "int8" else
               f"{seen['kept']} elements kept of k = {seen['k']} over "
               f"{seen['tensors']} JAX leaves, all at or above their "
               "threshold"))
    return out


def ssm_train_phases(device, every: dict, small: bool = False) -> dict:
    """Phases 20-22 (``small``: their CPU rehearsal, reduced configs and
    SMALL_SSM_TRAIN's sizes). ``every`` holds the kernels' counting
    wrappers. Returns the runs' records."""
    from repro_torch.configs import get_config, reduced
    runs = {}
    for phase, arch, run, seed in (
            (20, SSM_ARCH, SSM_TRAIN_RUN, SEED + 21),
            (21, HYBRID_ARCH, HYBRID_TRAIN_RUN, SEED + 23)):
        cfg = get_config(arch)
        if small:
            cfg, run = reduced(cfg), SMALL_SSM_TRAIN
        runs[f"{arch}_train"] = ssm_train(device, cfg, run, seed, every,
                                          phase)
    t0 = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    run = SWITCH_RUN
    if small:
        cfg, run = reduced(cfg), SMALL_SWITCH
    runs["remat_modes"] = remat_modes(device, cfg, run, SEED + 25)
    runs["compression"] = compressed_steps(device, cfg, run, SEED + 26)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return runs


# ------------------------------------------------------------ phases 23-26
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH = "internvl2-76b"
#: phase 23: ENCDEC_ARCH at full width and depth (12 encoder and 12
#: decoder layers) with bf16 parameters: 16 prompts of 128 tokens, each
#: over 1,024 stub audio frames, and 32 greedy decode steps (128 until
#: phase 26's masked replays and 28c's swapped layouts took their time);
#: 23b's teacher forcing on check_batch x check_seq, and the int8 cache
#: against the 16-bit one over int8_decode steps
ENCDEC_SERVE_RUN = dict(batch=16, seq=128, decode=32, check_batch=2,
                        check_seq=128, int8_decode=8)
#: phase 24: ENCDEC_ARCH trained at full width and depth (fp32
#: parameters, bf16 compute, ``remat="full"``): 24a the gradient check on
#: 1 x (1,024 frames, grad_seq tokens) through grad_layers encoder and
#: decoder layers, its control K6's dK/dV of the decoder's
#: cross-attention zeroed (read on the encoder's gradients); 24b four steps
#: of 2 x (1,024 frames, 2,048 tokens) (six until phase 29). 24a holds its bf16 loss within
#: SSM_LOSS_TOL, 20a's limit: on an H100 K5's and K6's bf16 rounding moved
#: it by 1.774e-4 of 12.95, past LOSS_TOL, where the same check in float32
#: compute (K5/K6 on their CUDA-core design) read 0 (PERF.md, PR 23); the
#: float32 check holds LOSS_TOL
ENCDEC_TRAIN_RUN = dict(batch=2, seq=2048, steps=4, grad_seq=1024,
                        grad_layers=4, control="cross_dkv",
                        loss_tol=SSM_LOSS_TOL)
#: phase 25: VLM_ARCH at full width with 8 of its 80 layers (bf16
#: parameters: 8 x 1.711 GB of layers and 4.20 GB of embeddings, 17.9
#: GB; cut from 24 layers to pay for 28g and 28h): 4 x (256 patches +
#: 1,792 tokens), 32 greedy decode steps; 25b's teacher forcing on
#: check_batch x (256 + check_seq)
VLM_SERVE_RUN = dict(layers=8, batch=4, seq=1792, decode=32,
                     check_batch=2, check_seq=1792)
#: their CPU rehearsals (the reduced configs)
SMALL_ENCDEC_SERVE = dict(batch=2, seq=24, decode=3, check_batch=2,
                          check_seq=24, int8_decode=2)
SMALL_ENCDEC_TRAIN = dict(batch=2, seq=32, steps=2, grad_seq=32,
                          grad_layers=2, control="cross_dkv",
                          loss_tol=SSM_LOSS_TOL)
SMALL_VLM_SERVE = dict(layers=2, batch=2, seq=24, decode=3, check_batch=2,
                       check_seq=24)
#: 23b and 25b: a prefill of check_seq - 1 tokens and one decode step
#: against ``train_logits`` of check_seq at the last position, as 17c: in
#: the model's bf16 the argmaxes equal and each row within TF_RTOL of its
#: norm (17c's limit, set from 48 MoE layers' readings; these are
#: dense); in float32 compute (the same bf16 parameters; K5 on its
#: CUDA-core design, the decode's products in float32) each row within
#: TF_F32_RTOL, where only the order of float32 sums differs, and where
#: each phase's control must be rejected
TF_RTOL = MOE_TF_RTOL
TF_F32_RTOL = 1e-3
#: phase 26: K5 and K6 on the largest non-causal launches of phases 23
#: and 24 (16 heads of 64): the encoder's 1,024 x 1,024 (K5 at phase 23's
#: batch of 16, K6 at phase 24's 2) and the cross-attention's 2,048 x
#: 1,024 at phase 24's batch of 2; the rehearsal's shapes on the CPU
NONCAUSAL = {"encoder": dict(k5_batch=16, k6_batch=2, sq=1024, sk=1024),
             "cross": dict(k5_batch=2, k6_batch=2, sq=2048, sk=1024)}
SMALL_NONCAUSAL = {"encoder": dict(k5_batch=2, k6_batch=1, sq=256, sk=256),
                   "cross": dict(k5_batch=1, k6_batch=1, sq=192, sk=256)}
#: phase 26's masked replays: K5 and K6 with a per-row key length
#: (``kv_valid_len``) at each arch's heads: ENCDEC_ARCH's cross shape as a
#: padded audio batch (2 x 2,048 queries over 1,024 frames, frame lengths
#: (1,024, 611)), causal at TRAIN_ARCH's (2 x 4,096, lengths (4,096,
#: 2,500)), both bf16 on wgmma, and the cross shape in float32 on the
#: CUDA-core design; the rehearsal's shapes on the CPU
MASKED = {"cross": dict(arch=ENCDEC_ARCH, batch=2, sq=2048, sk=1024,
                        causal=False, lens=(1024, 611), dtype="bfloat16"),
          "causal": dict(arch=TRAIN_ARCH, batch=2, sq=4096, sk=4096,
                         causal=True, lens=(4096, 2500), dtype="bfloat16"),
          "fp32": dict(arch=ENCDEC_ARCH, batch=2, sq=2048, sk=1024,
                       causal=False, lens=(1024, 611), dtype="float32")}
SMALL_MASKED = {
    "cross": dict(MASKED["cross"], sq=192, sk=256, lens=(256, 77)),
    "causal": dict(MASKED["causal"], sq=256, sk=256, lens=(256, 100)),
    "fp32": dict(MASKED["fp32"], sq=192, sk=256, lens=(256, 77))}


def teacher_forcing(model, params, run: dict, seed: int, tag: str,
                    control, what: str) -> dict:
    """23b / 25b: a prefill of check_batch x (check_seq - 1) tokens (with
    the family's stub embeddings) and one decode step of the last token
    against ``train_logits`` of all check_seq at the last position
    (``tf_close``), in the model's bf16 within TF_RTOL and in float32
    compute within TF_F32_RTOL; ``pos`` after the decode counts the VLM's
    patches. Then, in float32, ``control(cache)`` applied to the prefill's
    cache before the decode must be rejected. Returns the readings."""
    import torch
    b, s = run["check_batch"], run["check_seq"]
    v = model.cfg.vocab_size
    rec = {}
    for m, limit in ((model, TF_RTOL), (float32_twin(model), TF_F32_RTOL)):
        dt = m.cfg.compute_dtype
        batch, prefix = serve_inputs(m.cfg, b, s, seed, m.device)
        head = dict(batch, tokens=batch["tokens"][:, :-1])

        def decode(planted=None):
            _, cache = m.prefill(params, head, max_len=prefix + s)
            if planted is not None:
                planted(cache)
            return m.decode_step(params, batch["tokens"][:, -1:], cache)

        with torch.no_grad():
            want = m.train_logits(params, batch)[0][:, -1:].clone()
        got, cache = decode()
        check(int(cache["pos"]) == prefix + s,
              f"{tag}: pos {int(cache['pos'])} after the decode, not "
              f"{prefix + s}")
        del cache
        rec[dt] = tf_close(got, want, v, limit)
        log(f"  {tag}: prefill {b} x {s - 1} + one decode against "
            f"train_logits of {b} x {s} ({dt}): argmax equal, worst row "
            f"{rec[dt]['rel']:.4g} of its norm (limit {limit}), max |diff| "
            f"{rec[dt]['max_abs_err']:.4g}")
        if dt == "float32":
            must_fail(what, lambda: tf_close(decode(control)[0], want, v,
                                             limit))
        del got, want
    return rec


def int8_against_16bit(model, params, run: dict, seed: int) -> dict:
    """23b: the int8 cache against the 16-bit one, by phase 10's rule: the
    same prompts (check_batch x check_seq over the frames) prefilled into
    each, then int8_decode steps each fed the 16-bit bf16 run's token, in
    bf16 and in float32 compute (the same parameters). The int8 runs'
    logits within INT8_ATOL + INT8_RTOL x |logit| of their compute type's
    16-bit run's, and in float32 their argmaxes equal on INT8_AGREE of
    the positions; the cross K/V stay in the compute type, bit for bit
    the 16-bit cache's."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill_step
    cfg, dev = model.cfg, model.device
    b, s, n = run["check_batch"], run["check_seq"], run["int8_decode"]
    v = cfg.vocab_size
    batch, prefix = serve_inputs(cfg, b, s, seed, dev)
    gen, logits, cross = {}, {}, {}
    for tag, m in (("bf16", model),
                   ("int8", build_model(cfg, kv_cache_bits=8, device=dev)),
                   ("fp32", float32_twin(model)),
                   ("fp32_int8", float32_twin(model, kv_cache_bits=8))):
        tok, cache = make_prefill_step(m, max_len=prefix + s + n)(params,
                                                                  batch)
        cl = cache["layers"]
        check(cl["k"].dtype == (torch.int8 if "int8" in tag
                                else cl["cross_k"].dtype)
              and cl["cross_k"].dtype == getattr(torch, m.cfg.compute_dtype),
              f"23b: the {tag} cache's types")
        cross[tag] = (cl["cross_k"], cl["cross_v"])
        gen[tag], logits[tag] = [tok], []
        for i in range(n):
            out, cache = m.decode_step(
                params, tok if tag == "bf16" else gen["bf16"][i], cache)
            tok = torch.argmax(out, dim=-1).to(torch.int32)
            gen[tag].append(tok)
            logits[tag].append(out[:, 0, :v].float())
        del cache, cl
    rec = {}
    for tag, ref in (("int8", "bf16"), ("fp32_int8", "fp32")):
        check(all(torch.equal(a, r) for a, r in zip(cross[tag], cross[ref])),
              f"23b: the {tag} cache's cross K/V differ from the {ref} "
              "cache's")
        rec[tag] = decode_against(gen, logits, tag, ref, "23b: ")
        check(rec[tag]["outside_jax_rule"] == 0,
              f"23b: {tag} logits outside the JAX int8 test's rule")
    check(rec["fp32_int8"]["agree"] >= INT8_AGREE,
          f"23b: the float32 int8 run's argmaxes agree on "
          f"{rec['fp32_int8']['agree']:.4f} (limit {INT8_AGREE})")
    return rec


def serve_counts(tag: str, serve: dict, every: dict, k5: int) -> None:
    """A serving run's launches: K5 ``k5`` times, every one on wgmma, and
    no other kernel (the decode's attention is plain torch, as in JAX)."""
    for k, n in serve["launches"].items():
        want = k5 if k == "K5" else 0
        check(n == want, f"{tag}: {k} launched {n} times, the path implies "
                         f"{want}")
    check(serve["by_design"]["K5"] == {"wgmma": k5, "cuda_core": 0},
          f"{tag}: K5 by design {serve['by_design']['K5']}: a bf16 launch "
          "missed the wgmma design")


def frontend_serve(device, cfg, run: dict, seed: int, every: dict,
                   phase: int, control, what: str) -> dict:
    """Phase 23 (25): ``cfg`` served with bf16 parameters. (a) after one
    untimed prefill of the same prompts, ``model_serve`` with every
    kernel's launches counted (K5 once a
    layer's attention: the encoder's, the decoder's self- and
    cross-attention), then one prefill and one decode step profiled; (b)
    ``teacher_forcing`` with its control, and for an enc-dec model the
    int8 cache (``int8_against_16bit``). Returns the run's record."""
    import torch
    t_phase = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, params = build_serve(device, dataclasses.replace(
        cfg, param_dtype="bfloat16"), seed)
    c = model.cfg
    n_params = sum(p.numel() for p in params.values())
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    stub = importlib.import_module(
        "repro_torch.models.transformer").STUB_INPUTS[c.family]
    log(f"phase {phase}: {c.name} ({c.family}: "
        + (f"{c.encoder_layers} encoder and " if c.encoder_layers else "")
        + f"{c.num_layers} decoder layers, d_model {c.d_model}, "
        f"{c.num_heads} heads and {c.num_kv_heads} KV heads of "
        f"{c.resolved_head_dim}, d_ff {c.d_ff}, vocab {c.vocab_size}, "
        f"{c.frontend_tokens} stub {stub.split('_')[0]} embeddings; bf16 "
        f"parameters): {n_params / 1e9:.3f} B parameters, "
        f"{param_bytes / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t_phase:.1f} s")
    # one untimed, uncounted prefill first: the timed one then reads the
    # steady state, not the first use of these shapes in the process
    batch, prefix = serve_inputs(c, run["batch"], run["seq"], seed + 1,
                                 device)
    model.prefill(params, batch, max_len=prefix + run["seq"] + 1)
    del batch
    _sync(device)
    zero_counts(every.values())
    serve = model_serve(model, params, run, seed + 1, f"{phase}a")
    _sync(device)
    serve["launches"] = {k: fn.launches for k, fn in every.items()}
    serve["by_design"] = by_design(every)
    serve["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if device.type == "cuda" else 0
    log(f"phase {phase}a: prefill {run['batch']} x {run['seq']} in "
        f"{serve['prefill_s']:.3f} s ({serve['prefill_tokens_per_s']:.1f} "
        f"tokens/s; {serve['prefill_positions_per_s']:.1f} positions/s), "
        f"{run['decode']} decode steps in {serve['decode_s']:.3f} s "
        f"({serve['decode_tokens_per_s']:.1f} tokens/s); launches "
        f"{serve['launches']} (K5 by design {serve['by_design']['K5']}); "
        f"max_memory_allocated {serve['max_memory_allocated'] / 1e9:.2f} GB"
        f"; sample ids {serve['sample']}")
    if device.type == "cuda":             # on the CPU nothing launches
        serve_counts(f"{phase}a", serve, every, attentions(c))
    serve["busy_share"] = {
        "prefill": profile_prefill(model, params, run["batch"], run["seq"],
                                   seed + 1),
        "decode": profile_decode(model, params, run["batch"], run["seq"],
                                 seed + 1)}
    t0 = time.perf_counter()
    serve["teacher_forcing"] = teacher_forcing(model, params, run, seed + 2,
                                               f"{phase}b", control, what)
    if c.encoder_layers:
        serve["int8"] = int8_against_16bit(model, params, run, seed + 3)
    if device.type == "cuda":
        serve["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"phase {phase}b: {time.perf_counter() - t0:.1f} s; "
        f"max_memory_allocated since the build "
        f"{serve['max_memory_allocated'] / 1e9:.2f} GB")
    del model, params
    gc.collect()
    _empty(device)
    serve["wall_s"] = time.perf_counter() - t_phase
    log(f"phase {phase}: {serve['wall_s']:.1f} s")
    return serve


def swap_cross_kv(cache) -> None:
    """23b's control: layer 0's cross K/V replaced by layer 1's."""
    for name in ("cross_k", "cross_v"):
        cache["layers"][name][0].copy_(cache["layers"][name][1])


def encdec_train(device, cfg, run: dict, seed: int, every: dict) -> dict:
    """Phase 24: ``cfg`` trained at full width and depth. (a)
    ``grad_check`` at grad_layers encoder and decoder layers, in float32
    compute first (the same weights, K5/K6 on their CUDA-core design: the
    loss's reading without bf16 rounding, held within LOSS_TOL) and then
    in bf16 (within run["loss_tol"]); (b) at full
    depth, ``train_run``'s steps with every kernel's launches counted:
    under ``remat="full"`` K5 twice and K6 once a step for every
    attention (the encoder's, the decoder's self- and cross-attention),
    all on wgmma."""
    import torch
    t_phase = time.perf_counter()
    n = run["grad_layers"]
    model, params = build_serve(device, dataclasses.replace(
        cfg, num_layers=n, encoder_layers=n), seed)
    checks = {}
    for tag, m, tol in (("float32", float32_twin(model), LOSS_TOL),
                        ("bf16", model, run["loss_tol"])):
        g = checks[tag] = grad_check(m, params, dict(run, loss_tol=tol))
        log(f"phase 24a: gradient check ({tag} compute) on 1 x "
            f"({cfg.frontend_tokens} frames, {run['grad_seq']} tokens) "
            f"through {n} encoder and {n} decoder layers, K5/K6 against "
            f"their plain versions: loss {g['loss']:.6f} (off by "
            f"{g['loss_err']:.3g}, limit {tol}), "
            f"the worst gradient {g['worst_param']} off by "
            f"{g['grad_rel_err']:.3g} of its norm (limit {GRAD_RTOL}), "
            f"{g['seconds']:.1f} s")
    del model, params
    gc.collect()
    _empty(device)
    t0 = time.perf_counter()
    model, params = build_serve(device, cfg, seed + 1)
    n_params = sum(p.numel() for p in params.values())
    log(f"phase 24: {cfg.name} at full width and depth ({cfg.encoder_layers}"
        f" encoder and {cfg.num_layers} decoder layers; fp32 parameters, "
        f"bf16 compute, remat {cfg.remat!r}): {n_params / 1e9:.3f} B "
        f"parameters, built in {time.perf_counter() - t0:.1f} s")
    zero_counts(every.values())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = train_run(model, params, run)
    _sync(device)
    train["launches"] = {k: fn.launches for k, fn in every.items()}
    train["by_design"] = by_design(every)
    train["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
        if device.type == "cuda" else 0
    train["wall_s"] = time.perf_counter() - t0
    train.pop("largest_k6")
    train["grad_check"] = checks
    del model, params
    gc.collect()
    _empty(device)
    log(f"phase 24b: {run['steps']} steps of {run['batch']} x "
        f"({cfg.frontend_tokens} frames, {run['seq']} tokens): losses "
        f"{[round(x, 4) for x in train['losses']]}, "
        f"{train['tokens_per_s']:.1f} tokens/s over steps 2-{run['steps']}"
        f", launches {train['launches']} (by design {train['by_design']}), "
        f"max_memory_allocated {train['max_memory_allocated'] / 1e9:.2f} GB")
    log("  step seconds (wall / forward / backward / optimizer): " + "; ".join(
        f"{w:.3f} / {f:.3f} / {b:.3f} / {o:.3f}" for w, f, b, o in zip(
            train["step_s"], train["forward_s"], train["backward_s"],
            train["optimizer_s"])))
    per_step = {"K5": 2 * attentions(cfg), "K6": attentions(cfg)}
    if device.type == "cuda":             # on the CPU nothing launches
        for k, got in train["launches"].items():
            want = per_step.get(k, 0) * run["steps"]
            check(got == want, f"24b: {k} launched {got} times, the path "
                               f"implies {want}")
        for k in per_step:
            check(train["by_design"][k].get("wgmma") == train["launches"][k],
                  f"24b: {k} by design {train['by_design'][k]}: a bf16 "
                  "launch missed the wgmma design")
    train["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 24: {train['phase_s']:.1f} s")
    return train


def noncausal_replays(device, shapes: dict) -> dict:
    """Phase 26: K5 (``k5_record``) and K6 (``k6_record``) on seeded bf16
    inputs at ``shapes``' non-causal launches (16 heads of 64), each held
    against the fp32 plain version within ``kernels/flash_limits.py``'s
    limits, its last key tile dropped as a control, and timed beside its
    plain version, SDPA (a yardstick) and its bound. K6's o and lse are
    K5's on the same q, k, v; its dO is seeded."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    g = torch.Generator(device).manual_seed(SEED + 26)
    h, d = 16, 64

    def rand(b, s):
        return torch.randn((b, s, h, d), generator=g, device=device,
                           dtype=torch.bfloat16)

    out = {"K5": {}, "K6": {}}
    for name, sh in shapes.items():
        b, sq, sk = sh["k5_batch"], sh["sq"], sh["sk"]
        out["K5"][name] = k5_record(rand(b, sq), rand(b, sk), rand(b, sk),
                                    False, 0, iters=10)
        b = sh["k6_batch"]
        q, k, v, do = rand(b, sq), rand(b, sk), rand(b, sk), rand(b, sq)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=False,
                                         return_lse=True)
        out["K6"][name] = k6_record(q, k, v, o, do, lse, False, 0, iters=5)
        del q, k, v, do, o, lse
    FL = flash_limits()
    for key, recs in out.items():
        for name, r in recs.items():
            row = FL.FWD_ROW_RTOL if key == "K5" else FL.BWD_ROW_RTOL
            log(f"phase 26: {key} {name}: worst row {r['row_err']:.3g} of "
                f"its norm (limit {row}), {r['ulps']:.1f} ulps (limit "
                f"{FL.ULP_LIMIT}), control {r['control_ratio']:.1f} x | "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                f"ms ({r['bound_by']}) | {r['shape']}")
    return out


def _key_tiles(sq: int, sk: int, causal: bool, lens) -> tuple:
    """(key tiles of K5's wgmma schedule that the lengths leave, those
    without them), summed over the rows: the share a masked launch
    should take of the unmasked one's time."""
    import numpy as np
    tiles = importlib.import_module("repro_torch.kernels.flash_tiles")
    sched = tiles.tile_schedule(sq, sk, causal, 0, *tiles.FWD_TILES)
    cols = tiles.FWD_TILES[1]
    full = int((sched[:, 2] - sched[:, 1]).sum()) * len(lens)
    kept = sum(int((np.minimum(sched[:, 2], -(-min(max(n, 0), sk) // cols))
                    - sched[:, 1]).clip(min=0).sum()) for n in lens)
    return kept, full


def masked_record(q, k, v, lens, causal: bool, iters: int) -> dict:
    """Phase 26 for one masked input: K5 and K6 with ``kv_valid_len``
    ``lens`` against their plain versions on the float32 values of the
    same inputs with the same lengths: bf16 (wgmma) by ``flash_close``
    within FWD_ROW_RTOL / BWD_ROW_RTOL, float32 (the CUDA-core design)
    within FP32_ATTN_TOL / FP32_GRAD_TOL and the same row limits; every
    row here keeps a key, and the keys past a row's length get exactly 0
    in dk and dv. As a control, each kernel with the lengths ignored
    must read at least CONTROL_FACTOR times its row limit. Each timed
    beside the same launch without lengths, the plain version, SDPA with
    the mask (a yardstick) and the bound of the pairs the lengths
    keep."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fb = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
    FL = flash_limits()
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    n = torch.tensor(lens, dtype=torch.int32, device=q.device)
    kw = dict(causal=causal, window=0)
    wide = tuple(x.float() for x in (q, k, v))
    out = {}
    # K5
    o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                     kv_valid_len=n, **kw)
    ro, rlse = fa.flash_attention_plain(*wide, return_lse=True,
                                        kv_valid_len=n, **kw)
    if bf16:
        r = flash_close(o, ro, FL.FWD_ROW_RTOL, ATTN_ULP_FLOOR)
    else:
        r = {"max_abs_err": fp32_close(o, ro, FP32_ATTN_TOL),
             "row_err": FL.row_error(o, ro)}
        check(r["row_err"] <= FL.FWD_ROW_RTOL, f"float32 K5 masked: worst "
              f"row {r['row_err']:.3g} beyond {FL.FWD_ROW_RTOL}")
    r["lse_err"] = lse_close(lse, rlse)
    r["control_ratio"] = control_reads(
        f"K5 with the key lengths {tuple(lens)} ignored",
        FL.row_error(fa.flash_attention_cuda(q, k, v, **kw), ro),
        FL.FWD_ROW_RTOL)
    kept, full = _key_tiles(sq, sk, causal, lens)
    pairs = sum(_attended_pairs(sq, min(max(m, 0), sk), causal, 0)
                for m in lens) * h
    elt = q.element_size()
    t_b = elt * (2 * q.numel() + 2 * k.numel()) / HBM_BYTES_PER_S * 1e3 \
        + 4 * b * h * sq / HBM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S
    t_o = 4 * pairs * d / rate * 1e3
    kpos = torch.arange(sk, device=q.device)
    mask = (kpos[None, :] < n[:, None].long())[:, None, None, :]
    if causal:
        mask = mask & torch.ones((sq, sk), dtype=torch.bool,
                                 device=q.device).tril()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    r.update(ms=_sync_time_ms(lambda: fa.flash_attention_cuda(
                 q, k, v, kv_valid_len=n, **kw), iters),
             unmasked_ms=_sync_time_ms(lambda: fa.flash_attention_cuda(
                 q, k, v, **kw), iters),
             plain_ms=_sync_time_ms(lambda: fa.flash_attention_plain(
                 q, k, v, kv_valid_len=n, **kw), max(iters // 5, 1)),
             library_ms=_sdpa_ms(qt, kt, vt, iters, attn_mask=mask),
             bound_ms=max(t_b, t_o),
             bound_by="bytes" if t_b >= t_o else "operations",
             tile_share=kept / full)
    del qt, kt, vt
    out["K5"] = r
    # K6 on K5's o and lse, a seeded dO
    g = torch.Generator(q.device).manual_seed(SEED + 29)
    do = torch.randn(q.shape, generator=g, device=q.device, dtype=q.dtype)
    got = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, kv_valid_len=n,
                                      **kw)
    want = fb.flash_attention_bwd_plain(*wide, o.float(), do.float(), lse,
                                        kv_valid_len=n, **kw)
    check(all(bool(torch.isfinite(x).all()) for x in got),
          "K6 masked: a gradient is not finite")
    for i, m in enumerate(lens):
        m = min(max(m, 0), sk)
        check(not any(bool(x[i, m:].any()) for x in got[1:]),
              f"K6 masked: a key of row {i} past its length {m} has a "
              "gradient")
    if bf16:
        reads = [flash_close(a, w, FL.BWD_ROW_RTOL,
                             max(float(w.abs().max()), 1e-30)
                             * GRAD_ULP_FLOOR) for a, w in zip(got, want)]
        r = {key: max(x[key] for x in reads)
             for key in ("max_abs_err", "row_err", "ulps")}
    else:
        r = {"max_abs_err": max(fp32_close(a, w, FP32_GRAD_TOL)
                                for a, w in zip(got, want)),
             "row_err": max(FL.row_error(a, w) for a, w in zip(got, want))}
        check(r["row_err"] <= FL.BWD_ROW_RTOL, f"float32 K6 masked: worst "
              f"row {r['row_err']:.3g} beyond {FL.BWD_ROW_RTOL}")
    ignored = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    r["control_ratio"] = control_reads(
        f"K6 with the key lengths {tuple(lens)} ignored",
        max(FL.row_error(a, w) for a, w in zip(ignored, want)),
        FL.BWD_ROW_RTOL)
    del got, want, ignored
    t_b = elt * (4 * q.numel() + 4 * k.numel()) / HBM_BYTES_PER_S * 1e3 \
        + 4 * lse.numel() / HBM_BYTES_PER_S * 1e3
    t_o = 10 * pairs * d / rate * 1e3
    r.update(ms=_sync_time_ms(lambda: fb.flash_attention_bwd_cuda(
                 q, k, v, o, do, lse, kv_valid_len=n, **kw), iters),
             unmasked_ms=_sync_time_ms(lambda: fb.flash_attention_bwd_cuda(
                 q, k, v, o, do, lse, **kw), iters),
             plain_ms=_sync_time_ms(lambda: fb.flash_attention_bwd_plain(
                 q, k, v, o, do, lse, kv_valid_len=n, **kw), 1),
             library_ms=_sdpa_bwd_ms(q, k, v, do, iters, attn_mask=mask),
             bound_ms=max(t_b, t_o),
             bound_by="bytes" if t_b >= t_o else "operations")
    out["K6"] = r
    shape = (f"q [{b}, {sq}, {h}, {d}], k/v [{b}, {sk}, {hkv}, {d}] "
             f"{str(q.dtype).split('.')[-1]}, causal={causal}, "
             f"kv_valid_len {tuple(lens)}, {pairs} attended pairs")
    for r in out.values():
        r["shape"] = shape
    return out


def masked_replays(device, shapes: dict, card: str) -> dict:
    """Phase 26's masked replays (``masked_record``) on seeded inputs at
    ``shapes`` (MASKED), each arch's heads from its config; each logged
    with its error, its control and its time against the unmasked
    launch's and the key-tile share that predicts it, beside ``card``."""
    import torch
    from repro_torch.configs import get_config
    FL = flash_limits()
    g = torch.Generator(device).manual_seed(SEED + 28)
    out = {}
    for name, sh in shapes.items():
        cfg = get_config(sh["arch"])
        dt = getattr(torch, sh["dtype"])
        h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        b = sh["batch"]
        q = torch.randn((b, sh["sq"], h, d), generator=g, device=device,
                        dtype=dt)
        k, v = (torch.randn((b, sh["sk"], hkv, d), generator=g,
                            device=device, dtype=dt) for _ in range(2))
        out[name] = masked_record(q, k, v, sh["lens"], sh["causal"],
                                  iters=5)
        del q, k, v
        for key, r in out[name].items():
            row = FL.FWD_ROW_RTOL if key == "K5" else FL.BWD_ROW_RTOL
            share = out[name]["K5"]["tile_share"]
            log(f"phase 26: {key} masked {name}: worst row "
                f"{r['row_err']:.3g} of its norm (limit {row}), "
                f"max_abs_err {r['max_abs_err']:.3g}, control "
                f"{r['control_ratio']:.1f} x | kernel {r['ms']:.4f} ms "
                f"against {r['unmasked_ms']:.4f} ms unmasked "
                f"({r['ms'] / r['unmasked_ms']:.3f}; the lengths keep "
                f"{share:.3f} of K5's key tiles), plain {r['plain_ms']:.4f}"
                f" ms, SDPA {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | {r['shape']} "
                f"({card})")
    return out


def frontend_phases(device, every: dict, small: bool = False,
                    card: str = "cpu") -> dict:
    """Phases 23-26 (``small``: their CPU rehearsal, the reduced configs
    and the SMALL_* sizes): ENCDEC_ARCH served (23) and trained (24) at
    full width and depth, VLM_ARCH served at full width with 8 of its
    layers (25), then K5's and K6's non-causal and masked replays (26).
    ``every`` holds the kernels' counting wrappers. Returns the runs'
    records and the replays."""
    from repro_torch.configs import get_config, reduced
    enc, vlm = get_config(ENCDEC_ARCH), get_config(VLM_ARCH)
    serve, train, vlm_run = ENCDEC_SERVE_RUN, ENCDEC_TRAIN_RUN, VLM_SERVE_RUN
    shapes, masked = NONCAUSAL, MASKED
    if small:
        enc, vlm = reduced(enc), reduced(vlm)
        serve, train, vlm_run = (SMALL_ENCDEC_SERVE, SMALL_ENCDEC_TRAIN,
                                 SMALL_VLM_SERVE)
        shapes, masked = SMALL_NONCAUSAL, SMALL_MASKED
    runs = {
        "encdec_serve": frontend_serve(
            device, enc, serve, SEED + 27, every, 23, swap_cross_kv,
            "layer 0 reading layer 1's cross K/V"),
        "encdec_train": encdec_train(device, enc, train, SEED + 30, every)}
    s = vlm_run["check_seq"]
    runs["vlm_serve"] = frontend_serve(
        device, dataclasses.replace(vlm, num_layers=vlm_run["layers"]),
        vlm_run, SEED + 32, every, 25,
        lambda cache: cache["pos"].fill_(s - 1),
        f"the decode at pos {s - 1}, the text's length: the patches not "
        "counted")
    t0 = time.perf_counter()
    replays = noncausal_replays(device, shapes)
    gc.collect()
    _empty(device)
    masked_out = masked_replays(device, masked, card)
    log(f"phase 26: {time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "replays": replays, "masked": masked_out}


# ------------------------------------------------------------------ phase 28
#: phase 28: the LM half of multi-device training on one card, a (2, 2)
#: mesh of four ranks on cuda:0 joined by gloo (NCCL refuses two ranks on
#: one device). 28a: TRAIN_ARCH at full width with 4 layers, bf16 compute;
#: 28b: MOE_ARCH at full width with 1 layer, experts over ``model``
LM_MESH = (2, 2)
#: (28a takes 1 step, cut from 3 to 2 to pay for 28c and 28d and to 1
#: to pay for 28g and 28h: at 2 layers its control read 8.1x, below
#: CONTROL_FACTOR; 28b 1 layer and 1 step, cut from 2 and 2 to pay for
#: 28g and 28h)
LM_DENSE_RUN = dict(layers=4, batch=2, seq=4096, steps=1)
LM_MOE_RUN = dict(layers=1, batch=2, seq=4096, steps=1)
#: the CPU rehearsal's runs: the reduced configs
SMALL_LM_DENSE = dict(layers=2, batch=2, seq=128, steps=2)
SMALL_LM_MOE = dict(layers=2, batch=2, seq=128, steps=2)
#: 28b: each rank's expert-parallel MoE layer output against the
#: one-process ``moe_forward`` of its data shard's tokens, in norm (bf16:
#: each side adds its experts' shares in its own order)
MOE_EP_RTOL = 2e-2
#: torch threads a rank (four ranks share the host's cores)
LM_THREADS = 2
LM_TIMEOUT_S = 600.0
#: phase 28's parts, each by the key of its ranks' records
LM_PARTS = {"28a": "dense", "28b": "moe", "28c": "serve_dense",
            "28d": "serve_moe", "28e": "ssm", "28f": "hybrid",
            "28g": "audio", "28h": "serve_vlm"}
#: 28e-28g: the SSM, hybrid and audio families under the same mesh, each
#: at full width with ``layers`` of its layers (28g: as many encoder
#: layers; 28e and 28f cut from 4 layers and 2 steps to 2 layers and 1
#: step to pay for 28g and 28h, 28g from 2 steps to 1 to pay for phase
#: 26's masked replays and 28c's swapped layouts): ``steps`` training
#: steps of batch x seq tokens (bf16
#: compute, fp32 parameters, remat full; 28g over 1,024 stub frames a
#: row, 24b's shape), the first held as 28a holds its first step with
#: the loss within ``loss_tol`` (28g: 24a's bf16 limit), then served as
#: 28c is (``LM_SERVE``). 28e mamba2-780m: 24 of 48 SSD heads a rank;
#: 28f hymba-1.5b: 25 of 50, its attention DP-only on all 25 heads beside
#: them, the MLP split; 28g seamless-m4t-medium: 8 of 16 heads a rank in
#: the encoder, the decoder and the cross-attention, whose ``control``
#: drops the cross K/V's ``copy_to`` on the first batch (each rank's
#: encoder gradients then hold only its heads' share), read on the
#: encoder's gradients
LM_TRAIN = {"ssm": dict(layers=2, batch=2, seq=4096, steps=1,
                        seed=SEED + 32, loss_tol=LOSS_TOL),
            "hybrid": dict(layers=2, batch=2, seq=4096, steps=1,
                           seed=SEED + 33, loss_tol=LOSS_TOL),
            "audio": dict(layers=4, batch=2, seq=2048, steps=1,
                          seed=SEED + 34, loss_tol=SSM_LOSS_TOL,
                          control="cross_copy_to")}
SMALL_LM_TRAIN = {part: dict(run, layers=2, seq=128)
                  for part, run in LM_TRAIN.items()}
#: the cache leaves that hold KV heads (the hand-over drops a repeat):
#: the self and the cross K/V
KV_LEAVES = ("k", "v", "k_scale", "v_scale", "cross_k", "cross_v")
#: 28c-28h: serving under the (2, 2) mesh, bf16 weights and compute. The
#: prefill of ``batch`` x ``seq`` under the prefill rules (the batch over
#: ``data``, each rank's heads through K5 and K7), with ``chunks`` a
#: streamed prefill of the same prompt, the cache handed over to the
#: decode rules' layout (28c/28d: every KV head over this rank's half of
#: ``cap`` slots; the SSM state keeps its split by SSD heads, and the
#: hybrid's window ring its whole), then ``steps`` decode steps on rank
#: 0's one-process greedy tokens; the check reruns the prefill and
#: ``check_steps`` steps in float32 compute at ``check_layers`` layers,
#: with ``controls`` dropped: the merge's ``model`` reduce (read on the
#: steps), the SSD ``o`` projection's reduce, the gated norm's sum over
#: ``model`` (each read on the prefill), cross-attention's ``o`` reduce
#: (``cross_o``) or the patches in ``pos`` (``text_pos``: 25b's control,
#: the decode at the text's position), each read on the steps. 28c:
#: TRAIN_ARCH with 2 layers; 28d: MOE_ARCH with 1 (64 experts a rank);
#: 28e and 28f: SSM_ARCH and HYBRID_ARCH with 2 (the hybrid's prompt a
#: multiple of its window; 28c, 28e and 28f cut from 4 layers and 28d
#: from 2 to pay for 28g and 28h; each float32 check at 2 layers); 28g: ENCDEC_ARCH with 4 encoder and 4
#: decoder layers, 16 x 128 tokens over 1,024 frames, the cross cache
#: handed over from each rank's 8 heads to all 16 (float32 at 2 + 2);
#: 28h: VLM_ARCH with 2 of its 80 layers, 2 x (256 patches + 1,792
#: tokens), 2,064 slots counting the patches, 1,032 a rank. With
#: ``swap_steps`` (28c) each kind's rules also take the other's step: the
#: prefill's own cache decoded head-parallel under the prefill rules, and
#: the prompt prefilled under the decode rules straight into the
#: sequence-sharded cache, then decoded there, ``swap_steps`` steps each
#: (``check_steps`` in float32), this rank's slots of K held against the
#: one-process cache's, with two more controls: the head-parallel
#: decode's ``o`` reduce dropped (``heads_o``, read on the steps) and each
#: rank's prefill keeping its neighbour's slot range (``neighbour_slots``,
#: read on the slots of K: attention does not see the order of its keys,
#: and on the steps this fault read 4.4 x the limit)
LM_SERVE = {
    "dense": dict(arch=TRAIN_ARCH, layers=2, batch=2, seq=4096, cap=4160,
                  steps=16, check_layers=2, check_steps=2, swap_steps=4,
                  controls=("merge", "heads_o", "neighbour_slots")),
    "moe": dict(arch=MOE_ARCH, layers=1, batch=2, seq=2048, cap=2064,
                steps=16, check_layers=2, check_steps=2,
                controls=("merge",)),
    "ssm": dict(arch=SSM_ARCH, layers=2, batch=2, seq=4096, cap=4112,
                steps=16, check_layers=2, check_steps=2, chunks=2,
                controls=("ssd_o", "ssd_norm")),
    "hybrid": dict(arch=HYBRID_ARCH, layers=2, batch=2, seq=4096, cap=4112,
                   steps=16, check_layers=2, check_steps=2,
                   controls=("ssd_o", "ssd_norm")),
    "audio": dict(arch=ENCDEC_ARCH, layers=4, batch=16, seq=128, cap=160,
                  steps=16, check_layers=2, check_steps=2,
                  controls=("cross_o",)),
    "vlm": dict(arch=VLM_ARCH, layers=2, batch=2, seq=1792, cap=2064,
                steps=16, check_layers=2, check_steps=2,
                controls=("text_pos",))}
SMALL_LM_SERVE = {
    "dense": dict(LM_SERVE["dense"], layers=2, seq=128, cap=136, steps=3),
    "moe": dict(LM_SERVE["moe"], seq=128, cap=136, steps=3),
    "ssm": dict(LM_SERVE["ssm"], layers=2, seq=128, cap=136, steps=3),
    "hybrid": dict(LM_SERVE["hybrid"], layers=2, seq=128, cap=136,
                   steps=3),
    "audio": dict(LM_SERVE["audio"], layers=2, batch=4, seq=24, cap=32,
                  steps=3),
    "vlm": dict(LM_SERVE["vlm"], seq=24, cap=48, steps=3)}


def _cut(cfg, layers: int):
    """``cfg`` with ``layers`` decoder layers (and as many encoder
    layers where it has an encoder)."""
    kw = dict(num_layers=layers)
    if cfg.encoder_layers:
        kw["encoder_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def _lm_cfg(arch: str, run: dict, small: bool):
    from repro_torch.configs import get_config, reduced
    cfg = get_config(arch)
    if small:
        cfg = reduced(cfg)
    return _cut(cfg, run["layers"])


def _lm_barrier(mesh) -> None:
    import torch
    from repro_torch.distributed import collectives as col
    col.all_reduce(torch.zeros((), device=mesh.device), mesh, mesh.axes,
                   kind="barrier")


def _lm_batches(cfg, run: dict, n: int, seed: int, dev) -> list:
    """``n`` global batches, the same on every rank, each with the
    family's stub embeddings (``stub_inputs``)."""
    import torch
    from repro_torch.data.generators import token_batches
    gen = token_batches(cfg.vocab_size, run["batch"], run["seq"], seed=seed)
    return [{**{k: torch.from_numpy(v).to(dev) for k, v in next(gen).items()},
             **stub_inputs(cfg, run["batch"], seed + 1 + i, dev)}
            for i in range(n)]


def _lm_grads(model, params, batch):
    """(loss, gradients) of ``batch``; under a mesh, this rank's rows of
    it, and the gradients reduced as the train step reduces them."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.train_step import local_batch, reduce_grads
    ctx = shd.mesh_ctx()
    if ctx is not None:
        batch = local_batch(batch, ctx)
    loss, metrics = model.loss(params, batch)
    g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    if ctx is not None:
        g = reduce_grads(g, model, ctx)
    return float(metrics.get("loss", loss).detach()), g


def _lm_save_ref(grads: dict, where: Path) -> None:
    """The one-process gradients, one ``.npy`` a parameter, for every
    rank to read its shards of (no collective carries them)."""
    import numpy as np
    where.mkdir(parents=True, exist_ok=True)
    for n, g in grads.items():
        np.save(where / f"{n}.npy", g.detach().float().cpu().numpy())


def _lm_rel(ctx, model, grads: dict, where: Path) -> tuple:
    """Each gradient's distance from the one-process gradient in units of
    that one's norm: every rank sums the squares of its shard against its
    slice of the saved gradient (a shard held by several ranks counted
    once), one all-reduce adds them. Returns (worst, name)."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.train_step import grad_replicas
    specs, reps = model.specs(), grad_replicas(model, ctx)
    names = list(grads)
    sums = torch.zeros(2 * len(names), dtype=torch.float64,
                       device=ctx.mesh.device)
    for i, n in enumerate(names):
        g = grads[n].detach().float()
        check(bool(torch.isfinite(g).all()), f"{n}: gradient not finite")
        ref = np.load(where / f"{n}.npy", mmap_mode="r")
        sl = shd.shard_slices(ref.shape, ctx.pspec(*specs[n]), ctx.mesh)
        w = torch.from_numpy(np.array(ref[sl])).to(g.device)
        sums[2 * i] = float((g - w).double().square().sum()) / reps[n]
        sums[2 * i + 1] = float(w.double().square().sum()) / reps[n]
    sums = col.all_reduce(sums, ctx.mesh, ctx.mesh.axes, kind="check")
    rel = [(float(sums[2 * i].sqrt() / sums[2 * i + 1].sqrt().clamp(
        min=1e-30)), n) for i, n in enumerate(names)]
    return max(rel)


class _KeepLargest:
    """The first K5 and K6 launches of the path (every launch of a phase
    has one shape), for the replays; with ``each``, the first launch of
    each signature (causal, window, shapes) of either, keyed by it."""

    def __init__(self, each: bool = False):
        self.fa = importlib.import_module(
            "repro_torch.kernels.flash_attention")
        self.kept = {}
        self.each = each

    def key(self, kind: str, q, k, causal: bool, window: int) -> str:
        if not self.each:
            return kind
        return (f"{kind} {'causal' if causal else 'non-causal'} window "
                f"{window} q {list(q.shape)} k/v {list(k.shape)}")

    def __enter__(self):
        fa, kept = self.fa, self.kept
        self.real = (fa._launch, fa.flash_attention_bwd_cuda)
        real_fwd, real_bwd = self.real

        def fwd(q, k, v, causal, window, want_lse, design,
                kv_valid_len=None):
            key = self.key("K5", q, k, causal, window)
            if key not in kept and q.is_cuda:
                kept[key] = dict(args=tuple(t.detach().clone()
                                             for t in (q, k, v)),
                                  kw=dict(causal=causal, window=window,
                                          kv_valid_len=kv_valid_len))
            return real_fwd(q, k, v, causal, window, want_lse, design,
                            kv_valid_len)

        def bwd(q, k, v, o, do, lse, **kw):
            key = self.key("K6", q, k, kw["causal"], kw["window"])
            if key not in kept and q.is_cuda:
                kept[key] = dict(args=tuple(t.detach().clone() for t in
                                             (q, k, v, o, do, lse)), kw=kw)
            return real_bwd(q, k, v, o, do, lse, **kw)

        fa._launch, fa.flash_attention_bwd_cuda = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.fa._launch, self.fa.flash_attention_bwd_cuda = self.real


def _lm_replays(kept: dict) -> dict:
    """Each kept launch against its plain version on the float32 values of
    the same inputs, within ``kernels/flash_limits.py``'s limits."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fb = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
    FL = flash_limits()
    out = {}
    if "K5" in kept:
        q, k, v = kept["K5"]["args"]
        kw = kept["K5"]["kw"]
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        out["K5"] = dict(flash_close(got, want, FL.FWD_ROW_RTOL,
                                     ATTN_ULP_FLOOR),
                         shape=f"q {list(q.shape)}, k/v {list(k.shape)}")
    if "K6" in kept:
        q, k, v, o, do, lse = kept["K6"]["args"]
        kw = kept["K6"]["kw"]
        got = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        want = fb.flash_attention_bwd_plain(
            *(x.float() for x in (q, k, v, o, do)), lse, **kw)
        reads = [flash_close(a, w, FL.BWD_ROW_RTOL,
                             max(float(w.abs().max()), 1e-30)
                             * GRAD_ULP_FLOOR) for a, w in zip(got, want)]
        out["K6"] = dict({key: max(x[key] for x in reads)
                          for key in ("max_abs_err", "row_err", "ulps")},
                         shape=f"q {list(q.shape)}, k/v {list(k.shape)}")
    return out


@contextlib.contextmanager
def _first_grads(fn):
    """``fn(grads)`` on the gradients the train step hands AdamW at its
    first call (reduced, on a mesh), before the update."""
    ts = importlib.import_module("repro_torch.train.train_step")
    real = ts.adamw_update
    seen = []

    def update(cfg, params, grads, *a, **kw):
        if not seen:
            seen.append(True)
            fn(grads)
        return real(cfg, params, grads, *a, **kw)

    ts.adamw_update = update
    try:
        yield
    finally:
        ts.adamw_update = real


def _lm_dense(rank: int, mesh, dev, small: bool, wrappers: dict,
              ref_dir: Path) -> dict:
    """28a on this rank: the one-process steps (rank 0; the first step's
    gradients saved under ``ref_dir``), the dropped-``o``-reduce control
    (the first batch's gradients on the mesh), then the main path
    (run["steps"] steps, counted and timed; the first step's loss and
    gradients held against the one-process step's) and the replays of
    its K5/K6 launches."""
    import torch
    from repro_torch.configs.base import MeshConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as lyr
    from repro_torch.models.model import build_model
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainState
    run = SMALL_LM_DENSE if small else LM_DENSE_RUN
    cfg = _lm_cfg(TRAIN_ARCH, run, small)
    mesh_cfg = MeshConfig(LM_MESH, ("data", "model"))
    batches = _lm_batches(cfg, run, run["steps"], SEED + 28, dev)
    opt = OptConfig(warmup_steps=1, total_steps=run["steps"])
    rec = {"rank": rank}
    if rank == 0:
        # the one-process steps on the same weights, alone on the card
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(dev).manual_seed(SEED + 28))
        step = make_train_step(model, opt)
        state = TrainState(params=params, opt=adamw_init(params))
        ref_losses = []
        with _first_grads(lambda g: _lm_save_ref(g, ref_dir)):
            for b in batches:
                state, m = step(state, b)
                ref_losses.append(float(m["loss"]))
        del model, params, state, step
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        rec.update(ref_losses=ref_losses, ref_s=time.perf_counter() - t0)
    _lm_barrier(mesh)
    prof = shd.sharding_profile(cfg, mesh_cfg, run["batch"], run["seq"])
    ctx = shd.ShardCtx(mesh, shd.make_rules(cfg, mesh_cfg, run["batch"],
                                            run["seq"]), prof)
    with shd.use_ctx(ctx):
        model = build_model(cfg, kv_repeat=prof.kv_repeat, device=dev)
        params = model.init(torch.Generator(dev).manual_seed(SEED + 28))
        rec["local_params"] = sum(p.numel() for p in params.values())
        real = attn_mod.row_parallel
        attn_mod.row_parallel = lambda p, x, cd, n, m, a: lyr.row_parallel(
            p, x, cd, n, None, None)
        try:
            c_loss, c_grads = _lm_grads(model, params, batches[0])
        finally:
            attn_mod.row_parallel = real
        c_worst, c_name = _lm_rel(ctx, model, c_grads, ref_dir)
        del c_grads
        gc.collect()
        step = make_train_step(model, opt)
        state = TrainState(params=params, opt=adamw_init(params))
        zero_counts(wrappers.values())
        col.reset_stats()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, wall, first = [], [], {}
        with _KeepLargest() as keep, _first_grads(
                lambda g: first.update(rel=_lm_rel(ctx, model, g, ref_dir))):
            for b in batches:
                t0 = time.perf_counter()
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
        worst, name = first["rel"]
        if rank == 0:
            rec.update(loss=losses[0],
                       loss_err=abs(losses[0] - rec["ref_losses"][0]),
                       grad_rel_err=worst, worst_param=name,
                       control_loss=c_loss, control_rel_err=c_worst,
                       control_param=c_name)
        rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
        rec["by_design"] = by_design(wrappers)
        rec["collectives"] = {k: dict(v) for k, v in col.STATS.items()}
        rec.update(losses=losses, step_s=wall)
        if dev.type == "cuda":
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        del state, step, params, model
    rec["replays"] = _lm_replays(keep.kept)
    del keep
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _lm_moe(rank: int, mesh, dev, small: bool, wrappers: dict) -> dict:
    """28b on this rank: each MoE layer's expert-parallel output against
    the one-process ``moe_forward`` of this data shard's tokens (the
    layer's full weights gathered), the same with the expert outputs'
    ``model`` reduce dropped as the control, then run["steps"] steps."""
    import torch
    from repro_torch.configs.base import MeshConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build_model
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.elastic import Placement
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainState, local_batch
    run = SMALL_LM_MOE if small else LM_MOE_RUN
    cfg = _lm_cfg(MOE_ARCH, run, small)
    mesh_cfg = MeshConfig(LM_MESH, ("data", "model"))
    batches = _lm_batches(cfg, run, run["steps"] + 1, SEED + 29, dev)
    prof = shd.sharding_profile(cfg, mesh_cfg, run["batch"], run["seq"])
    check(prof.expert_tp, "28b: the experts do not shard over model")
    ctx = shd.ShardCtx(mesh, shd.make_rules(cfg, mesh_cfg, run["batch"],
                                            run["seq"]), prof)
    rec = {"rank": rank, "data": mesh.index("data"),
           "model": mesh.index("model")}
    plain_fwd, plain_combine = moe_mod.moe_forward, moe_mod._combine
    with shd.use_ctx(ctx):
        model = build_model(cfg, kv_repeat=prof.kv_repeat, device=dev)
        params = model.init(torch.Generator(dev).manual_seed(SEED + 29))
        rec["local_params"] = sum(p.numel() for p in params.values())
        rec["local_experts"] = params["layers.0.moe.wg"].shape[0]
        lb = local_batch(batches[0], ctx)
        seen = {}

        def recording(tag):
            def fwd(p, x, c):
                y, aux = plain_fwd(p, x, c)
                seen.setdefault(tag, []).append((x.detach(), y.detach()))
                return y, aux
            return fwd

        with torch.no_grad():
            moe_mod.moe_forward = recording("ep")
            try:
                model.train_logits(params, lb)
                moe_mod._combine = lambda y, m, a: y
                moe_mod.moe_forward = recording("control")
                model.train_logits(params, lb)
            finally:
                moe_mod.moe_forward, moe_mod._combine = plain_fwd, \
                    plain_combine
        specs = model.specs()
        errs, c_errs = [], []
        for layer in range(cfg.num_layers):
            pre = f"layers.{layer}.moe."
            full = {n[len(pre):]: Placement(mesh, ctx.pspec(*specs[n]))
                    .gather(t.detach()) for n, t in params.items()
                    if n.startswith(pre)}
            p = {"router": {"w": full["router.w"]},
                 **{w: full[w] for w in ("wg", "wu", "wd")}}
            x, y = seen["ep"][layer]
            with torch.no_grad(), shd.use_ctx(None):
                want, _ = plain_fwd(p, x, cfg)
            den = float(torch.linalg.vector_norm(want.float()))
            errs.append(float(torch.linalg.vector_norm(
                (y - want).float())) / den)
            cx, cy = seen["control"][layer]
            check(torch.equal(cx, x) or layer > 0, "28b: the control's "
                                                   "first layer saw other "
                                                   "tokens")
            with torch.no_grad(), shd.use_ctx(None):
                cwant, _ = plain_fwd(p, cx, cfg)
            c_errs.append(float(torch.linalg.vector_norm(
                (cy - cwant).float())) / float(torch.linalg.vector_norm(
                    cwant.float())))
            del full, p, want, cwant
        del seen
        rec.update(layer_rel_err=errs, control_rel_err=c_errs)
        step = make_train_step(model, OptConfig(warmup_steps=1,
                                                total_steps=run["steps"]))
        state = TrainState(params=params, opt=adamw_init(params))
        zero_counts(wrappers.values())
        col.reset_stats()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, auxes, wall = [], [], []
        for b in batches[1:]:
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
        rec["collectives"] = {k: dict(v) for k, v in col.STATS.items()}
        rec.update(losses=losses, aux=auxes, step_s=wall)
        if dev.type == "cuda":
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        del state, step, params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _serve_cfg(run: dict, small: bool, layers: int, compute: str):
    from repro_torch.configs import get_config, reduced
    cfg = get_config(run["arch"])
    if small:
        cfg = reduced(cfg)
    return dataclasses.replace(_cut(cfg, layers), param_dtype="bfloat16",
                               compute_dtype=compute)


def _serve_prompt(cfg, run: dict, dev) -> dict:
    """The prompt batch: batch x seq tokens, with the family's stub
    embeddings (``stub_inputs``)."""
    import torch
    g = torch.Generator().manual_seed(SEED + 30)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (run["batch"], run["seq"]),
                                    generator=g).to(dev),
            **stub_inputs(cfg, run["batch"], SEED + 35, dev)}


def _serve_ref(cfg, run: dict, dev, steps: int, where: Path) -> None:
    """Rank 0's one-process serving on the mesh's weights: the prefill and
    ``steps`` greedy decode steps; every logits tensor and the tokens
    (the prefill's next token, then each step's) saved under ``where``,
    with the prefill's SSM state, and with ``run["chunks"]`` the streamed
    prefill's logits and state."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    where.mkdir(parents=True, exist_ok=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(SEED + 31))
    prompt = _serve_prompt(cfg, run, dev)
    if run.get("chunks"):
        logits, cache = model.prefill_streaming(
            params, prompt, chunk=run["seq"] // run["chunks"])
        np.save(where / "stream_logits.npy", logits.float().cpu().numpy())
        np.save(where / "stream_ssm.npy",
                cache["layers"]["ssm"].float().cpu().numpy())
        del logits, cache
    logits, cache = model.prefill(params, prompt, max_len=run["cap"])
    if cfg.ssm.enabled:
        np.save(where / "ssm.npy", cache["layers"]["ssm"].float().cpu()
                .numpy())
    if run.get("swap_steps"):
        np.save(where / "k.npy", cache["layers"]["k"].float().cpu().numpy())
    lgs, toks = [logits], [logits.argmax(-1)]
    for _ in range(steps):
        logits, cache = model.decode_step(params, toks[-1], cache)
        lgs.append(logits)
        toks.append(logits.argmax(-1))
    np.save(where / "logits.npy", torch.stack(lgs).float().cpu().numpy())
    np.save(where / "tokens.npy", torch.stack(toks).cpu().numpy())
    del model, params, cache, lgs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _shard_rows_rel(ctx, got, want, vocab: int) -> float:
    """The worst row's distance between this rank's vocab shard of the
    logits [B_local, 1, V_shard] and the same rows and columns of the
    whole ``want`` [B, 1, V] (numpy), in units of the whole row's norm:
    the sums of squares over each shard's real columns added over
    ``model``."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    mesh, axis = ctx.mesh, ctx.axis(shd.VOCAB)
    pspec = (ctx.profile.batch_axes or None, None, ctx.rules[shd.VOCAB])
    sl = shd.shard_slices(want.shape, pspec, mesh)
    w = torch.from_numpy(np.array(want[sl])).to(got.device)
    lo = sl[2].start
    real = torch.arange(lo, lo + w.shape[-1], device=got.device) < vocab
    g = got.float()
    check(bool(torch.isfinite(g[..., real]).all()), "logits not finite")
    zero = torch.zeros((), device=got.device)
    # the pad columns (-1e30 on both sides) count nothing
    sums = torch.stack([torch.where(real, (g - w).square(), zero).sum(-1),
                        torch.where(real, w.square(), zero).sum(-1)])
    sums = col.all_reduce(sums, mesh, axis, kind="check")
    return float((sums[0].sqrt() / sums[1].sqrt()).max())


def _state_rel(ctx, model, got, where: Path, leaf: str = "ssm") -> float:
    """This rank's piece of a cache leaf (the SSM state [L, B, H, P, N],
    or ``leaf``) against the same slice of the whole saved one, by the
    leaf's ``cache_specs`` under ``ctx``, in units of that slice's
    norm."""
    import numpy as np
    import torch
    from repro_torch.distributed import sharding as shd
    ref = np.load(where, mmap_mode="r")
    spec = model.cache_specs()["layers"][leaf]
    sl = shd.shard_slices(ref.shape, ctx.pspec(*spec), ctx.mesh)
    w = torch.from_numpy(np.array(ref[sl])).to(got.device)
    check(bool(torch.isfinite(got).all()), f"cache {leaf} not finite")
    return float(torch.linalg.vector_norm(got.float() - w)
                 / torch.linalg.vector_norm(w).clamp(min=1e-30))


@contextlib.contextmanager
def _ssd_control(name: str):
    """The SSD block with one of its ``model`` sums dropped: the ``o``
    projection's reduce (``ssd_o``), or the gated norm's mean of squares
    over every rank's heads (``ssd_norm``: each rank normalises its own
    heads alone)."""
    ssm_mod = importlib.import_module("repro_torch.models.ssm")
    lyr = importlib.import_module("repro_torch.models.layers")
    real = (ssm_mod.row_parallel, ssm_mod._mean_square)
    if name == "ssd_o":
        ssm_mod.row_parallel = lambda p, x, cd, n, m, a: lyr.row_parallel(
            p, x, cd, n, None, None)
    else:
        ssm_mod._mean_square = lambda y, m, a: y.square().mean(
            -1, keepdim=True)
    try:
        yield
    finally:
        ssm_mod.row_parallel, ssm_mod._mean_square = real


@contextlib.contextmanager
def _neighbour_slots():
    """``Model._fill_kv`` filling each rank's slice of a sequence-sharded
    cache with its neighbour's slot range over ``KV_SEQ``'s axis."""
    tr = importlib.import_module("repro_torch.models.transformer")
    shd = importlib.import_module("repro_torch.distributed.sharding")
    real = tr.Model._fill_kv

    def fill(self, cl, i, k, v, s):
        ctx = shd.mesh_ctx()
        sa, mesh = ctx.axis(shd.KV_SEQ), ctx.mesh
        nb = (mesh.index(sa) + 1) % mesh.size(sa)
        own = type(mesh).index
        mesh.index = lambda ax: nb if ax == sa else own(mesh, ax)
        try:
            real(self, cl, i, k, v, s)
        finally:
            del mesh.index

    tr.Model._fill_kv = fill
    try:
        yield
    finally:
        tr.Model._fill_kv = real


def _decode_rels(model, params, cache, ctx, toks, ref_logits, vocab: int,
                 n: int) -> list:
    """``n`` decode steps of ``model`` under ``ctx`` from ``cache`` on the
    reference's tokens: each step's logits against the reference's
    (``_shard_rows_rel``)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.train_step import local_batch
    rels = []
    with shd.use_ctx(ctx):
        for i in range(n):
            t = local_batch({"tokens": toks[i]}, ctx)["tokens"]
            lg, cache = model.decode_step(params, t, cache)
            rels.append(_shard_rows_rel(ctx, lg, ref_logits[i + 1], vocab))
    return rels


def _swap_layouts(model, dmodel, params, cache, cfg, run: dict, dev,
                  pctx, dctx, toks, ref_logits, steps: int,
                  controls: tuple, where: Path, out: dict) -> None:
    """28c's swapped layouts (LM_SERVE's comment) into ``out``: the
    prefill's ``cache`` decoded ``steps`` steps head-parallel under the
    prefill rules, then the prompt prefilled under the decode rules into
    the sequence-sharded cache (this rank's slots of K against the
    one-process cache's, ``swap_cache_rel``) and decoded there, each
    against rank 0's one-process run; the controls of ``controls`` among
    ``heads_o`` (read on the steps) and ``neighbour_slots`` (read on the
    slots of K: attention does not see the order of its keys, so the
    steps hardly move)."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.train_step import local_batch
    lyr = importlib.import_module("repro_torch.models.layers")
    attn_mod = importlib.import_module("repro_torch.models.attention")
    vocab = cfg.vocab_size
    kept = None
    if "heads_o" in controls:
        kept = {"pos": cache["pos"].clone(),
                "layers": {k: t.clone() for k, t in cache["layers"].items()}}
    t0 = time.perf_counter()
    out["swap_heads_rels"] = _decode_rels(model, params, cache, pctx, toks,
                                          ref_logits, vocab, steps)
    if kept is not None:
        real = attn_mod.row_parallel
        attn_mod.row_parallel = lambda p, x, cd, n, m, a: \
            lyr.row_parallel(p, x, cd, n, None, None)
        try:
            out["controls"]["heads_o"] = max(_decode_rels(
                model, params, kept, pctx, toks, ref_logits, vocab, steps))
        finally:
            attn_mod.row_parallel = real
    with shd.use_ctx(dctx):
        prompt = local_batch(_serve_prompt(cfg, run, dev), dctx)
        lg, dcache = dmodel.prefill(params, prompt, max_len=run["cap"])
        out["swap_prefill_rel"] = _shard_rows_rel(dctx, lg, ref_logits[0],
                                                  vocab)
        out["swap_cache_slots"] = int(dcache["layers"]["k"].shape[2])
        out["swap_cache_rel"] = _state_rel(dctx, dmodel, dcache["layers"]
                                           ["k"], where / "k.npy", "k")
        del lg
    out["swap_seq_rels"] = _decode_rels(dmodel, params, dcache, dctx, toks,
                                        ref_logits, vocab, steps)
    if "neighbour_slots" in controls:
        with shd.use_ctx(dctx), _neighbour_slots():
            _, bad = dmodel.prefill(params, prompt, max_len=run["cap"])
        out["controls"]["neighbour_slots"] = _state_rel(
            dctx, dmodel, bad["layers"]["k"], where / "k.npy", "k")
        del bad
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["swap_s"] = time.perf_counter() - t0
    del dcache, kept


@contextlib.contextmanager
def _decode_control(name: str):
    """The decode with one piece dropped: the merge's ``model`` reduce
    (``merge``: each rank attends only its slice), cross-attention's
    ``o`` reduce (``cross_o``), or nothing (``text_pos``: the caller
    moves ``pos``)."""
    attn_mod = importlib.import_module("repro_torch.models.attention")
    lyr = importlib.import_module("repro_torch.models.layers")
    real = (attn_mod.merge_partials, attn_mod._cross_decode,
            attn_mod.row_parallel)
    if name == "merge":
        attn_mod.merge_partials = lambda m, l, acc, rmax, rsum: real[0](
            m, l, acc, lambda x: x, lambda x: x)
    elif name == "cross_o":
        def cross(*args, **kwargs):
            attn_mod.row_parallel = lambda p, x, cd, n, m, a: \
                lyr.row_parallel(p, x, cd, n, None, None)
            try:
                return real[1](*args, **kwargs)
            finally:
                attn_mod.row_parallel = real[2]
        attn_mod._cross_decode = cross
    try:
        yield
    finally:
        (attn_mod.merge_partials, attn_mod._cross_decode,
         attn_mod.row_parallel) = real


def _serve_mesh(cfg, run: dict, mesh, dev, steps: int, where: Path,
                controls: tuple = ()) -> dict:
    """The mesh's serving of ``run`` on this rank (module comment of
    LM_SERVE): the prefill's (and the streamed prefill's) and every
    step's logits against rank 0's saved ones (``_shard_rows_rel``), the
    SSM state against its slice of rank 0's, the next tokens
    (``vocab_argmax``) against its greedy ones, host seconds around
    synchronised prefills and steps; ``controls`` rerun the prefill with
    one of the SSD block's sums dropped (``ssd_o``, ``ssd_norm``) or
    decode the steps again with the merge's ``model`` reduce dropped
    (``merge``), cross-attention's ``o`` reduce dropped (``cross_o``) or
    the decode at the text's position, the VLM's patches not counted
    (``text_pos``), each read in ``out["controls"]``."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs.base import MeshConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.serve.serve_step import vocab_argmax
    from repro_torch.train.train_step import local_batch
    mesh_cfg = MeshConfig(LM_MESH, ("data", "model"))
    ctxs = {}
    for kind, n in (("prefill", run["seq"]), ("decode", run["cap"])):
        prof = shd.sharding_profile(cfg, mesh_cfg, run["batch"], n, kind)
        ctxs[kind] = shd.ShardCtx(mesh, shd.make_rules(
            cfg, mesh_cfg, run["batch"], n, kind), prof)
    pctx, dctx = ctxs["prefill"], ctxs["decode"]
    seq_shard = cfg.has_attention and not cfg.attn_window
    check(dctx.profile.kv_seq_shard == seq_shard,
          f"the decode cache is {'' if seq_shard else 'not '}meant to be "
          "sequence-sharded over model")
    ref_logits = np.load(where / "logits.npy", mmap_mode="r")
    ref_toks = torch.from_numpy(np.load(where / "tokens.npy")).to(dev)
    vocab = cfg.vocab_size

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    out = {"kv_repeat": (pctx.profile.kv_repeat, dctx.profile.kv_repeat),
           "profile": {k: getattr(pctx.profile, k) for k in
                       ("attn_tp", "ssd_tp", "mlp_tp")}, "controls": {}}
    with shd.use_ctx(pctx):
        model = build_model(cfg, kv_repeat=pctx.profile.kv_repeat,
                            device=dev)
        params = model.init(torch.Generator(dev).manual_seed(SEED + 31))
        prompt = local_batch(_serve_prompt(cfg, run, dev), pctx)
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, max_len=run["cap"])
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_rel"] = _shard_rows_rel(pctx, logits, ref_logits[0],
                                             vocab)
        if cfg.ssm.enabled:
            out["state_rel"] = _state_rel(pctx, model, cache["layers"]["ssm"],
                                          where / "ssm.npy")
        tok = vocab_argmax(logits)
        full = convert.gather_cache(cache, model)
        del logits
        if run.get("chunks"):
            sync()
            t0 = time.perf_counter()
            logits, streamed = model.prefill_streaming(
                params, prompt, chunk=run["seq"] // run["chunks"])
            sync()
            out["stream_s"] = time.perf_counter() - t0
            out["stream_rel"] = _shard_rows_rel(
                pctx, logits, np.load(where / "stream_logits.npy"), vocab)
            out["stream_state_rel"] = _state_rel(
                pctx, model, streamed["layers"]["ssm"],
                where / "stream_ssm.npy")
            del logits, streamed
        for name in controls:
            if name not in ("ssd_o", "ssd_norm"):
                continue
            with _ssd_control(name):
                lg, _ = model.prefill(params, prompt, max_len=run["cap"])
            out["controls"][name] = _shard_rows_rel(pctx, lg, ref_logits[0],
                                                    vocab)
            del lg
    # the prefill's stored heads without its repeat: every r-th head
    r = pctx.profile.kv_repeat // dctx.profile.kv_repeat
    full["layers"] = {k: t[:, :, :, ::r] if k in KV_LEAVES else t
                      for k, t in full["layers"].items()}
    agree = [int((tok == local_batch({"tokens": ref_toks[0]}, pctx)
                  ["tokens"]).sum())]
    with shd.use_ctx(dctx):
        dmodel = model if r == 1 else build_model(
            cfg, kv_repeat=dctx.profile.kv_repeat, device=dev)
    if run.get("swap_steps"):
        _swap_layouts(model, dmodel, params, cache, cfg, run, dev, pctx,
                      dctx, ref_toks, ref_logits,
                      min(run["swap_steps"], steps), controls, where, out)
    del cache
    with shd.use_ctx(dctx):

        def decode(tag):
            cache = convert.shard_cache(full, dmodel)
            if tag == "text_pos":
                cache["pos"] = torch.full_like(cache["pos"], run["seq"])
            rels, secs = [], []
            for i in range(steps):
                t = local_batch({"tokens": ref_toks[i]}, dctx)["tokens"]
                sync()
                t0 = time.perf_counter()
                lg, cache = dmodel.decode_step(params, t, cache)
                sync()
                secs.append(time.perf_counter() - t0)
                rels.append(_shard_rows_rel(dctx, lg, ref_logits[i + 1],
                                            vocab))
                if tag == "main":
                    want = local_batch({"tokens": ref_toks[i + 1]},
                                       dctx)["tokens"]
                    agree.append(int((vocab_argmax(lg) == want).sum()))
            if "k" in cache["layers"]:
                out["cache_slots"] = int(cache["layers"]["k"].shape[2])
            return rels, secs

        out["main_rels"], out["main_s"] = decode("main")
        for name in controls:
            if name in ("ssd_o", "ssd_norm", "heads_o", "neighbour_slots"):
                continue
            with _decode_control(name):
                out["controls"][name] = max(decode(name)[0])
    out["agree"] = agree
    out["rows"] = int(prompt["tokens"].shape[0])
    del model, dmodel, params, full
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _lm_serve(rank: int, mesh, dev, small: bool, wrappers: dict,
              ref_dir: Path, part: str) -> dict:
    """The serving of 28c (``part`` dense), 28d (moe), 28e (ssm) or 28f
    (hybrid) on this rank: rank 0's one-process references (bf16, then
    float32 at ``check_layers``), then
    the main path on the mesh (bf16: prefill and ``steps`` steps, the
    kernel counters set to 0 just before and read just after, the
    collectives and peak memory read), then the float32 check and its
    control."""
    import torch
    from repro_torch.distributed import collectives as col
    run = (SMALL_LM_SERVE if small else LM_SERVE)[part]
    cfg = _serve_cfg(run, small, run["layers"], "bfloat16")
    cfg32 = _serve_cfg(run, small, run["check_layers"], "float32")
    where = ref_dir / f"serve_{part}"
    where32 = ref_dir / f"serve_{part}_fp32"
    rec = {"rank": rank, "data": mesh.index("data"),
           "model": mesh.index("model")}
    if rank == 0:
        t0 = time.perf_counter()
        _serve_ref(cfg, run, dev, run["steps"], where)
        _serve_ref(cfg32, run, dev, run["check_steps"], where32)
        rec["ref_s"] = time.perf_counter() - t0
    _lm_barrier(mesh)
    zero_counts(wrappers.values())
    col.reset_stats()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec["bf16"] = _serve_mesh(cfg, run, mesh, dev, run["steps"], where)
    rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    rec["by_design"] = by_design(wrappers)
    rec["collectives"] = {k: dict(v) for k, v in col.STATS.items()}
    if dev.type == "cuda":
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["fp32"] = _serve_mesh(cfg32, run, mesh, dev, run["check_steps"],
                              where32, controls=run["controls"])
    return rec


def _lm_train(rank: int, mesh, dev, small: bool, wrappers: dict,
              ref_dir: Path, part: str) -> dict:
    """28e-28g's training on this rank (``LM_TRAIN[part]``): rank 0's
    one-process steps on the same weights (the first step's gradients
    saved), the run's ``control`` on the mesh's first batch (read on the
    encoder's gradients), then ``steps`` steps on the mesh (counted and
    timed; the first step's loss and gradients held against the
    one-process step's)."""
    import torch
    from repro_torch.configs.base import MeshConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainState
    run = (SMALL_LM_TRAIN if small else LM_TRAIN)[part]
    cfg = _lm_cfg(LM_SERVE[part]["arch"], run, small)
    mesh_cfg = MeshConfig(LM_MESH, ("data", "model"))
    seed = run["seed"]
    batches = _lm_batches(cfg, run, run["steps"], seed, dev)
    opt = OptConfig(warmup_steps=1, total_steps=run["steps"])
    where = ref_dir / f"train_{part}"
    rec = {"rank": rank}
    if rank == 0:
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(dev).manual_seed(seed))
        step = make_train_step(model, opt)
        state = TrainState(params=params, opt=adamw_init(params))
        ref_losses = []
        with _first_grads(lambda g: _lm_save_ref(g, where)):
            for b in batches:
                state, m = step(state, b)
                ref_losses.append(float(m["loss"]))
        del model, params, state, step
        gc.collect()
        _empty(dev)
        rec.update(ref_losses=ref_losses, ref_s=time.perf_counter() - t0)
    _lm_barrier(mesh)
    prof = shd.sharding_profile(cfg, mesh_cfg, run["batch"], run["seq"])
    ctx = shd.ShardCtx(mesh, shd.make_rules(cfg, mesh_cfg, run["batch"],
                                            run["seq"]), prof)
    with shd.use_ctx(ctx):
        model = build_model(cfg, kv_repeat=prof.kv_repeat, device=dev)
        params = model.init(torch.Generator(dev).manual_seed(seed))
        rec["local_params"] = sum(p.numel() for p in params.values())
        rec["local_heads"] = {
            "SSD": params["layers.0.ssd.A_log"].shape[0] if cfg.ssm.enabled
            else 0, "attention": params["layers.0.attn.q.w"].shape[1]
            if cfg.has_attention else 0}
        rec["profile"] = {k: getattr(prof, k) for k in
                          ("attn_tp", "ssd_tp", "mlp_tp", "vocab_tp")}
        if run.get("control"):
            with _cross_copy_dropped():
                _, c_grads = _lm_grads(model, params, batches[0])
            enc = {n: g for n, g in c_grads.items()
                   if n.split(".")[0] in ("encoder", "enc_norm")}
            rec["control_rel_err"], rec["control_param"] = _lm_rel(
                ctx, model, enc, where)
            del c_grads, enc
            gc.collect()
        step = make_train_step(model, opt)
        state = TrainState(params=params, opt=adamw_init(params))
        zero_counts(wrappers.values())
        col.reset_stats()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, wall, first = [], [], {}
        with _first_grads(
                lambda g: first.update(rel=_lm_rel(ctx, model, g, where))):
            for b in batches:
                t0 = time.perf_counter()
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
        rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
        rec["by_design"] = by_design(wrappers)
        rec["collectives"] = {k: dict(v) for k, v in col.STATS.items()}
        if dev.type == "cuda":
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        worst, name = first["rel"]
        if rank == 0:
            rec.update(loss=losses[0],
                       loss_err=abs(losses[0] - rec["ref_losses"][0]),
                       grad_rel_err=worst, worst_param=name)
        rec.update(losses=losses, step_s=wall)
        del state, step, params, model
    gc.collect()
    _empty(dev)
    return rec


@contextlib.contextmanager
def _cross_copy_dropped():
    """28g's training control: the cross K/V's ``copy_to`` (the encoder
    output's into each rank's heads) the identity while the model
    projects them."""
    tr = importlib.import_module("repro_torch.models.transformer")
    col = importlib.import_module("repro_torch.distributed.collectives")
    real = tr.Model._cross_kv

    def cross_kv(*args, **kwargs):
        copy = col.copy_to
        col.copy_to = lambda x, mesh, axes: x
        try:
            return real(*args, **kwargs)
        finally:
            col.copy_to = copy
    tr.Model._cross_kv = cross_kv
    try:
        yield
    finally:
        tr.Model._cross_kv = real


def _lm_train_serve(rank: int, mesh, dev, small: bool, wrappers: dict,
                    ref_dir: Path, part: str) -> dict:
    """28e (``part`` ssm), 28f (hybrid) or 28g (audio) on this rank: the
    training, then the serving (``_lm_serve``); the main path's launches
    are theirs together."""
    rec = {"rank": rank, "data": mesh.index("data"),
           "model": mesh.index("model")}
    t0 = time.perf_counter()
    rec["train"] = _lm_train(rank, mesh, dev, small, wrappers, ref_dir,
                             part)
    rec["train"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["serve"] = _lm_serve(rank, mesh, dev, small, wrappers, ref_dir, part)
    rec["serve"]["wall_s"] = time.perf_counter() - t0
    rec["launches"] = {k: rec["train"]["launches"][k]
                       + rec["serve"]["launches"][k] for k in wrappers}
    return rec


def attentions(cfg) -> int:
    """The attention blocks a forward runs: one a decoder layer, and an
    encoder-decoder's encoder layers and cross-attention besides."""
    if not cfg.has_attention:
        return 0
    if cfg.encoder_layers:
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def train_launches(cfg, steps: int) -> dict:
    """The launches a rank's training steps imply under remat full (every
    layer's forward run again in the backward): K5 and K7 twice a layer
    (an attention block) and step, K6 once."""
    per = 2 if cfg.remat != "none" else 1
    out = {}
    if cfg.has_attention:
        out.update(K5=per * attentions(cfg) * steps,
                   K6=attentions(cfg) * steps)
    if cfg.ssm.enabled:
        out["K7"] = per * cfg.num_layers * steps
    return out


def train_report(rs: list, part: str, tag: str, small: bool, card: str,
                 cuda: bool) -> list:
    """28e, 28f or 28g: print and hold each rank's training and
    serving."""
    run = (SMALL_LM_TRAIN if small else LM_TRAIN)[part]
    cfg = _lm_cfg(LM_SERVE[part]["arch"], run, small)
    tol = run["loss_tol"]
    t0 = rs[0]["train"]
    frames = (f" over {cfg.frontend_tokens} stub frames a row"
              if cfg.encoder_layers else "")
    log(f"phase {tag}: {cfg.name} at {'reduced' if small else 'full'} width "
        f"({_cfg_line(cfg)}) with {cfg.num_layers} layers"
        + (f" and {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
           else "")
        + f", layout {t0['profile']}, heads a rank {t0['local_heads']}, "
        f"{run['batch']} x {run['seq']} tokens a step{frames}, bf16 "
        f"compute, remat {cfg.remat!r}; one-process reference in "
        f"{t0['ref_s']:.1f} s, training {t0['wall_s']:.1f} s, serving "
        f"{rs[0]['serve']['wall_s']:.1f} s ({card})")
    log(f"phase {tag}: the first step on the mesh against the one-process "
        f"step: loss {t0['loss']:.6f} (off by {t0['loss_err']:.3g}, limit "
        f"{tol}), the worst gradient {t0['worst_param']} off by "
        f"{t0['grad_rel_err']:.3g} of its norm (limit {GRAD_RTOL})")
    check(t0["loss_err"] <= tol, f"{tag}: loss off by {t0['loss_err']}")
    check(t0["grad_rel_err"] <= GRAD_RTOL,
          f"{tag}: {t0['worst_param']} off by {t0['grad_rel_err']:.3g}")
    if run.get("control"):
        t0["control_ratio"] = control_reads(
            f"{tag}: the cross K/V's copy_to dropped, read on the encoder's "
            f"gradients ({t0['control_param']})", t0["control_rel_err"],
            GRAD_RTOL)
    for a, b in zip(t0["losses"], t0["ref_losses"]):
        check(math.isfinite(a) and abs(a - b) <= 10 * tol * max(
            1.0, abs(b)), f"{tag}: step loss {a} against one process {b}")
    timed = t0["step_s"][1:] or t0["step_s"]
    log(f"phase {tag}: {run['steps']} steps: losses "
        f"{[round(x, 4) for x in t0['losses']]} (one process "
        f"{[round(x, 4) for x in t0['ref_losses']]}), step seconds "
        f"{[round(x, 3) for x in t0['step_s']]}, "
        f"{run['batch'] * run['seq'] * len(timed) / sum(timed):.1f} "
        f"tokens/s ({card})")
    for r in rs:
        t = r["train"]
        check(t["losses"] == t0["losses"], f"{tag}: rank {r['rank']} reads "
              f"losses {t['losses']}, rank 0 {t0['losses']}")
        log(f"  rank {r['rank']}: training: {t['local_params'] / 1e6:.1f} M "
            f"local parameters, max_memory_allocated "
            f"{t.get('max_memory_allocated', 0) / 1e9:.2f} GB, launches "
            f"{t['launches']}, by design "
            f"{ {k: t['by_design'].get(k) for k in ('K5', 'K6', 'K7')} }; "
            "collectives: " + _collective_line(t["collectives"])
            + f" ({card})")
        if cuda:
            check_designs(f"{tag} training", t, train_launches(
                cfg, run["steps"]))
    serve = [dict(r["serve"], rank=r["rank"], data=r["data"],
                  model=r["model"]) for r in rs]
    serve_report(serve, part, tag, small, card, cuda)
    return rs


def lm_world_rank(rank: int, device: str, small: bool, ref_dir: str,
                  parts: tuple = tuple(LM_PARTS)) -> dict:
    """One rank of phase 28's world: the (2, 2) mesh over the four ranks,
    then 28a-28h (those of ``parts``)."""
    import torch
    from repro_torch.configs.base import MeshConfig
    from repro_torch.launch.mesh import make_mesh_from_config
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh_from_config(MeshConfig(LM_MESH, ("data", "model")),
                                 dev)
    wrappers = all_wrappers()
    runs = {"28a": lambda: _lm_dense(rank, mesh, dev, small, wrappers,
                                     Path(ref_dir)),
            "28b": lambda: _lm_moe(rank, mesh, dev, small, wrappers),
            "28c": lambda: _lm_serve(rank, mesh, dev, small, wrappers,
                                     Path(ref_dir), "dense"),
            "28d": lambda: _lm_serve(rank, mesh, dev, small, wrappers,
                                     Path(ref_dir), "moe"),
            "28e": lambda: _lm_train_serve(rank, mesh, dev, small, wrappers,
                                           Path(ref_dir), "ssm"),
            "28f": lambda: _lm_train_serve(rank, mesh, dev, small, wrappers,
                                           Path(ref_dir), "hybrid"),
            "28g": lambda: _lm_train_serve(rank, mesh, dev, small, wrappers,
                                           Path(ref_dir), "audio"),
            "28h": lambda: _lm_serve(rank, mesh, dev, small, wrappers,
                                     Path(ref_dir), "vlm")}
    out = {}
    for tag in parts:
        t0 = time.perf_counter()
        out[LM_PARTS[tag]] = runs[tag]()
        out[LM_PARTS[tag]]["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            log(f"phase {tag}: {out[LM_PARTS[tag]]['wall_s']:.1f} s of rank "
                "time (rank 0)")
    return out


def _collective_line(stats: dict) -> str:
    return "; ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e9:.3f} GB "
                     f"{v['seconds']:.2f} s" for k, v in sorted(stats.items()))


def lm_world_phase(dev, card: str, small: bool = False,
                   parts: tuple = tuple(LM_PARTS)) -> dict:
    """Phase 28: spawn the world (four ranks on ``dev``), then hold what
    each rank read in each of ``parts``. The kernels are built before
    (phase 0), so no rank runs nvcc."""
    from repro_torch.launch.mesh import spawn_world
    t0 = time.perf_counter()
    ref_dir = Path(tempfile.mkdtemp(prefix="lm_ref_", dir=ROOT / "build"))
    try:
        ranks = spawn_world(lm_world_rank, math.prod(LM_MESH),
                            (str(dev), small, str(ref_dir), tuple(parts)),
                            device=str(dev),
                            timeout_s=LM_TIMEOUT_S,
                            threads=1 if dev.type == "cpu" else LM_THREADS)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    log(f"phase 28: a {LM_MESH} mesh of {len(ranks)} ranks on {dev} in "
        f"{wall:.1f} s ({card}): four ranks on one card share its SMs and "
        "its memory, and every collective crosses the host (gloo), so "
        "nothing here speaks of scaling across cards")
    out = {"wall_s": wall}
    if "dense" in ranks[0]:
        run = SMALL_LM_DENSE if small else LM_DENSE_RUN
        d = [r["dense"] for r in ranks]
        r0 = d[0]
        cfg = _lm_cfg(TRAIN_ARCH, run, small)
        log(f"phase 28a: {cfg.name} at {'reduced' if small else 'full'} width "
            f"({cfg.d_model} wide, {cfg.num_heads} heads, {cfg.num_kv_heads} "
            f"KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) with "
            f"{cfg.num_layers} layers, {run['batch']} x {run['seq']} tokens a "
            f"step, bf16 compute; one-process reference in {r0['ref_s']:.1f} s "
            f"({card})")
        log(f"phase 28a: the first step on the mesh against the one-process "
            f"step: loss {r0['loss']:.6f} (off by {r0['loss_err']:.3g}, limit "
            f"{LOSS_TOL}), the worst gradient {r0['worst_param']} off by "
            f"{r0['grad_rel_err']:.3g} of its norm (limit {GRAD_RTOL})")
        check(r0["loss_err"] <= LOSS_TOL, f"28a: loss off by {r0['loss_err']}")
        check(r0["grad_rel_err"] <= GRAD_RTOL,
              f"28a: {r0['worst_param']} off by {r0['grad_rel_err']:.3g}")
        r0["control_ratio"] = control_reads(
            f"the o projection's model reduce dropped ({r0['control_param']})",
            r0["control_rel_err"], GRAD_RTOL)
        tokens = run["batch"] * run["seq"]
        timed = r0["step_s"][1:] or r0["step_s"]
        tps = tokens * len(timed) / sum(timed)
        log(f"phase 28a: {run['steps']} steps: losses "
            f"{[round(x, 4) for x in r0['losses']]} (one process "
            f"{[round(x, 4) for x in r0['ref_losses']]}), step seconds "
            f"{[round(x, 3) for x in r0['step_s']]}, {tps:.1f} tokens/s "
            f"({card})")
        for a, b in zip(r0["losses"], r0["ref_losses"]):
            check(math.isfinite(a) and abs(a - b) <= 10 * LOSS_TOL * max(
                1.0, abs(b)), f"28a: step loss {a} against one process {b}")
        layers = cfg.num_layers
        for r in d:
            check(all(x == r0["losses"][i] for i, x in enumerate(r["losses"])),
                  f"28a: rank {r['rank']} reads losses {r['losses']}")
            mem = r.get("max_memory_allocated", 0) / 1e9
            log(f"  rank {r['rank']}: {r['local_params'] / 1e6:.1f} M local "
                f"parameters, max_memory_allocated {mem:.2f} GB, launches "
                f"{r['launches']}; collectives: "
                + _collective_line(r["collectives"]) + f" ({card})")
            if cuda:
                for k, per_step in (("K5", 2 * layers), ("K6", layers)):
                    want = per_step * run["steps"]
                    check(r["launches"][k] == want,
                          f"28a: rank {r['rank']}: {k} launched "
                          f"{r['launches'][k]} times, the path implies {want}")
                    check(r["by_design"][k] == {"wgmma": want, "cuda_core": 0},
                          f"28a: rank {r['rank']}: {k} by design "
                          f"{r['by_design'][k]}")
                for k in ("K5", "K6"):
                    check(k in r["replays"], f"28a: rank {r['rank']}: no {k} "
                                             "launch kept")
            for k, rp in r["replays"].items():
                log(f"  rank {r['rank']}: {k} replay ({rp['shape']}): worst row "
                    f"{rp['row_err']:.3g}, {rp['ulps']:.1f} ulps, max_abs_err "
                    f"{rp['max_abs_err']:.3g} ({card})")
        out["dense"] = d
    if "moe" in ranks[0]:
        run = SMALL_LM_MOE if small else LM_MOE_RUN
        m = [r["moe"] for r in ranks]
        cfg = _lm_cfg(MOE_ARCH, run, small)
        log(f"phase 28b: {cfg.name} with {cfg.num_layers} layers, "
            f"{m[0]['local_experts']} of {cfg.moe.num_experts} experts a rank, "
            f"{run['batch']} x {run['seq']} tokens a step, in "
            f"{m[0]['wall_s']:.1f} s ({card})")
        for r in m:
            log(f"  rank {r['rank']} (data {r['data']}, model {r['model']}): "
                f"MoE layer outputs off the one-process moe_forward of its "
                f"tokens by {[f'{x:.3g}' for x in r['layer_rel_err']]} of their "
                f"norm (limit {MOE_EP_RTOL}); losses {r['losses']}, step "
                f"seconds {[round(x, 3) for x in r['step_s']]}, max_memory_"
                f"allocated {r.get('max_memory_allocated', 0) / 1e9:.2f} GB, "
                f"launches {r['launches']}; collectives: "
                + _collective_line(r["collectives"]) + f" ({card})")
            for i, e in enumerate(r["layer_rel_err"]):
                check(e <= MOE_EP_RTOL, f"28b: rank {r['rank']} layer {i} off "
                                        f"by {e:.3g}")
            r["control_ratio"] = control_reads(
                f"rank {r['rank']}: the expert outputs' model reduce dropped",
                min(r["control_rel_err"]), MOE_EP_RTOL)
            check(all(math.isfinite(x) for x in r["losses"]),
                  f"28b: rank {r['rank']} loss not finite")
            check(r["losses"] == m[0]["losses"],
                  f"28b: rank {r['rank']} reads losses {r['losses']}, rank 0 "
                  f"{m[0]['losses']}")
            if cuda:
                for k in ("K5", "K6"):
                    check(r["launches"][k] > 0, f"28b: rank {r['rank']}: {k} "
                                                "never launched")
        timed = m[0]["step_s"][1:] or m[0]["step_s"]
        log(f"phase 28b: {run['batch'] * run['seq'] * len(timed) / sum(timed):.1f}"
            f" tokens/s ({card})")
        out["moe"] = m
    for part, tag in (("dense", "28c"), ("moe", "28d"), ("vlm", "28h")):
        if f"serve_{part}" in ranks[0]:
            out[f"serve_{part}"] = serve_report(
                [r[f"serve_{part}"] for r in ranks], part, tag, small, card,
                cuda)
    for part, tag in (("ssm", "28e"), ("hybrid", "28f"), ("audio", "28g")):
        if part in ranks[0]:
            out[part] = train_report([r[part] for r in ranks], part, tag,
                                     small, card, cuda)
    return out


def _cfg_line(cfg) -> str:
    """A config's widths for a log line."""
    parts = [f"{cfg.d_model} wide"]
    if cfg.has_attention:
        parts.append(f"{cfg.num_heads} heads, {cfg.num_kv_heads} KV heads"
                     + (f", window {cfg.attn_window}" if cfg.attn_window
                        else ""))
    if cfg.ssm.enabled:
        nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        parts.append(f"{nh} SSD heads of {cfg.ssm.head_dim}, state "
                     f"{cfg.ssm.state_size}")
    if cfg.d_ff:
        parts.append(f"d_ff {cfg.d_ff}")
    parts.append(f"vocab {cfg.vocab_size}")
    return ", ".join(parts)


def serve_launches(cfg, run: dict) -> dict:
    """The launches a rank's bf16 serving path implies: K5 once an
    attention block in the prefill, and again in the prefill under the
    decode rules with ``swap_steps``; K7 once a layer in the prefill and
    in each chunk of the streamed one (the decode steps launch
    neither)."""
    out = {}
    if cfg.has_attention:
        out["K5"] = attentions(cfg) * (2 if run.get("swap_steps") else 1)
    if cfg.ssm.enabled:
        out["K7"] = cfg.num_layers * (1 + run.get("chunks", 0))
    return out


#: the design each counted kernel of phase 28 must take in bf16
MESH_DESIGNS = {"K5": "wgmma", "K6": "wgmma", "K7": "tensor"}


def check_designs(tag: str, r: dict, want: dict) -> None:
    """Each kernel of ``want`` launched exactly that many times on rank
    ``r``, all on its bf16 design."""
    for k, n in want.items():
        check(r["launches"][k] == n, f"{tag}: rank {r['rank']}: {k} launched "
              f"{r['launches'][k]} times, the path implies {n}")
        design = r["by_design"][k]
        check(design.get(MESH_DESIGNS[k]) == n and sum(design.values()) == n,
              f"{tag}: rank {r['rank']}: {k} by design {design}")


def serve_report(rs: list, part: str, tag: str, small: bool, card: str,
                 cuda: bool) -> list:
    """28c-28h's serving: print and hold what each rank read."""
    run = (SMALL_LM_SERVE if small else LM_SERVE)[part]
    cfg = _serve_cfg(run, small, run["layers"], "bfloat16")
    r0 = rs[0]
    kv = r0["bf16"]["kv_repeat"]
    layout = (f"the cache handed over to the decode rules' layout "
              f"({run['cap']} slots, {r0['bf16']['cache_slots']} a rank, KV "
              f"repeat {kv[1]})" if "cache_slots" in r0["bf16"] else
              "the state handed over to the decode rules' layout")
    stub = importlib.import_module(
        "repro_torch.models.transformer").STUB_INPUTS.get(cfg.family)
    front = (f" over {cfg.frontend_tokens} stub frames a row"
             if stub == "frame_embeds" else
             f" behind {cfg.frontend_tokens} stub patches a row"
             if stub else "")
    log(f"phase {tag}: {cfg.name} at {'reduced' if small else 'full'} "
        f"width ({_cfg_line(cfg)}) with {cfg.num_layers} layers"
        + (f" and {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
           else "")
        + f", bf16 weights and compute, layout {r0['bf16']['profile']}: a "
        f"prefill of {run['batch']} x {run['seq']}{front} under the prefill "
        f"rules (KV repeat {kv[0]})"
        + (f", streamed again in {run['chunks']} chunks" if run.get("chunks")
           else "")
        + f", {layout}, then {run['steps']} decode steps on rank 0's "
        f"greedy tokens; the one-process references in "
        f"{r0['ref_s']:.1f} s, in {r0['wall_s']:.1f} s in all ({card})")
    rows = sum(r["bf16"]["rows"] for r in rs if r["model"] == 0)
    agree = [sum(r["bf16"]["agree"][i] for r in rs if r["model"] == 0)
             for i in range(run["steps"] + 1)]
    for r in rs:
        b, f = r["bf16"], r["fp32"]
        mem = r.get("max_memory_allocated", 0) / 1e9
        extra = ""
        if "state_rel" in b:
            extra += (f"; SSM state off by {b['state_rel']:.4g} of its "
                      f"norm (float32 {f['state_rel']:.3g})")
        if "stream_rel" in b:
            extra += (f"; streamed prefill logits {b['stream_rel']:.4g}, "
                      f"state {b['stream_state_rel']:.4g} (float32 "
                      f"{f['stream_rel']:.3g}, {f['stream_state_rel']:.3g})"
                      f", {b['stream_s']:.3f} s")
        log(f"  rank {r['rank']} (data {r['data']}, model {r['model']}): "
            f"bf16 prefill logits off by {b['prefill_rel']:.4g} of their "
            f"row's norm, the worst decode step {max(b['main_rels']):.4g} "
            f"(limit {TF_RTOL}); float32 at {run['check_layers']} layers: "
            f"prefill {f['prefill_rel']:.3g}, steps "
            f"{[f'{x:.3g}' for x in f['main_rels']]} (limit "
            f"{TF_F32_RTOL}){extra}; prefill {b['prefill_s']:.3f} s, decode "
            f"steps {sum(b['main_s']):.3f} s, max_memory_allocated "
            f"{mem:.2f} GB, launches {r['launches']}, by design "
            f"{ {k: r['by_design'].get(k) for k in ('K5', 'K7')} }; "
            "collectives: " + _collective_line(r["collectives"])
            + f" ({card})")
        reads = [("prefill logits", b["prefill_rel"], TF_RTOL),
                 ("decode logits", max(b["main_rels"]), TF_RTOL),
                 ("float32 prefill logits", f["prefill_rel"], TF_F32_RTOL),
                 ("float32 decode logits", max(f["main_rels"]), TF_F32_RTOL)]
        for key in ("state_rel", "stream_rel", "stream_state_rel"):
            if key in b:
                reads += [(key, b[key], TF_RTOL),
                          (f"float32 {key}", f[key], TF_F32_RTOL)]
        if "swap_s" in b:
            log(f"  rank {r['rank']}: swapped layouts: the decode under the "
                f"prefill rules (head-parallel, {len(b['swap_heads_rels'])} "
                f"steps "
                f"on the prefill's cache) off by "
                f"{max(b['swap_heads_rels']):.4g}, the prefill under the "
                f"decode rules (straight into {b['swap_cache_slots']} of "
                f"{run['cap']} slots) {b['swap_prefill_rel']:.4g}, its "
                f"slots of K {b['swap_cache_rel']:.4g} and its steps "
                f"{max(b['swap_seq_rels']):.4g} (limit {TF_RTOL}); "
                f"float32 {max(f['swap_heads_rels']):.3g}, "
                f"{f['swap_prefill_rel']:.3g}, {f['swap_cache_rel']:.3g}, "
                f"{max(f['swap_seq_rels']):.3g} (limit {TF_F32_RTOL}); "
                f"{b['swap_s']:.3f} s ({card})")
            for key, what in (("swap_heads_rels", "head-parallel decode"),
                              ("swap_prefill_rel", "prefill under the "
                               "decode rules"),
                              ("swap_cache_rel", "the slots of K it "
                               "filled"),
                              ("swap_seq_rels", "steps on the "
                               "sequence-sharded prefill cache")):
                worst = (lambda x: max(x) if isinstance(x, list) else x)
                reads += [(what, worst(b[key]), TF_RTOL),
                          (f"float32 {what}", worst(f[key]), TF_F32_RTOL)]
        for what, reading, limit in reads:
            check(reading <= limit, f"{tag}: rank {r['rank']} {what} off by "
                                    f"{reading:.4g} (limit {limit})")
        r["control_ratio"] = {
            name: control_reads(
                f"{tag}: rank {r['rank']}: "
                + {"merge": "the merge's model reduce dropped",
                   "ssd_o": "the SSD o projection's model reduce dropped",
                   "ssd_norm": "the gated norm over the rank's heads alone",
                   "cross_o": "cross-attention's o reduce dropped",
                   "heads_o": "the head-parallel decode's o reduce "
                              "dropped",
                   "neighbour_slots": "each rank's prefill under the "
                                      "decode rules keeping its "
                                      "neighbour's slot range",
                   "text_pos": "the decode at the text's position, the "
                               "patches not counted"}
                [name], reading, TF_F32_RTOL)
            for name, reading in f["controls"].items()}
        check(set(f["controls"]) == set(run["controls"]), f"{tag}: rank "
              f"{r['rank']}: controls read {sorted(f['controls'])}")
        if cuda:
            check_designs(tag, r, serve_launches(cfg, run))
    prefill_s = max(r["bf16"]["prefill_s"] for r in rs)
    steps = r0["bf16"]["main_s"][1:] or r0["bf16"]["main_s"]
    log(f"phase {tag}: prefill {run['batch'] * run['seq'] / prefill_s:.1f} "
        f"tokens/s, decode {run['batch'] * len(steps) / sum(steps):.1f} "
        f"tokens/s (steps 2-{run['steps']}, rank 0); next tokens equal to "
        f"the one-process run's on {sum(agree)} of {rows * len(agree)} "
        f"(prefill {agree[0]} of {rows}; read, not held: one rounding "
        f"turns a near tie) ({card}): four ranks on one card and gloo "
        "across the host, so these rates say nothing of scaling")
    return rs


# --------------------------------------------------------------------- main
# ------------------------------------------------------- phase 29: the dry-run
#: the production cells phase 29 realizes, one rank each: (mesh, arch,
#: shape); among them K5, K6 and K7 launch, and each traces on meta in a
#: few tens of seconds at most (a train cell of the SSM or hybrid family
#: traces for minutes)
DRYRUN_CELLS = (("multi", "seamless-m4t-medium", "train_4k"),
                ("single", "hymba-1.5b", "prefill_32k"),
                ("single", "internvl2-76b", "decode_32k"))
#: the CPU rehearsal's cells: the same archs reduced, on (2, 2)
SMALL_DRYRUN_SHAPES = {"train": (64, 8), "prefill": (64, 4),
                       "decode": (64, 4)}
DRYRUN_TIMEOUT_S = 300.0
#: the most bytes of scores ([B, G, Sq, Sk] float32) that a plain version
#: of a phase-29 replay may hold at once: a larger launch is held on
#: slices of it, the first and the last (one batch row and one query head
#: for K5, one batch row and one KV head's group for K6)
REPLAY_SCORE_BYTES = 2 ** 32


def replay_slices(q, k, group: bool) -> list:
    """(batch, q heads, KV heads) index slices of the parts of a K5 or K6
    launch that its replay holds: the whole launch where the plain
    version's scores fit REPLAY_SCORE_BYTES; else the first batch row's
    first KV head and the last row's last, each with its whole group of
    query heads (``group``, as K6's dk and dv sum over it) or one query
    head of it."""
    b, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    whole = slice(None)
    if b * g * sq * sk * 4 <= REPLAY_SCORE_BYTES:
        return [(whole, whole, whole)]
    heads = g if group or g * sq * sk * 4 <= REPLAY_SCORE_BYTES else 1
    check(heads * sq * sk * 4 <= REPLAY_SCORE_BYTES,
          f"a replay of q {list(q.shape)}, k/v {list(k.shape)} holds "
          f"{heads * sq * sk * 4} B of scores, beyond {REPLAY_SCORE_BYTES}")
    out = []
    for row, kv in ((0, 0), (b - 1, hkv - 1)):
        first = kv * g + (g - heads if row else 0)
        out.append((slice(row, row + 1), slice(first, first + heads),
                    slice(kv, kv + 1)))
    return out


def _lengths_of(kw: dict, rows: slice) -> dict:
    lens = kw.get("kv_valid_len")
    return dict(kw, kv_valid_len=None if lens is None else lens[rows])


def dryrun_replays(kept: dict) -> dict:
    """Each launch kept from a phase-29 step (``_KeepLargest(each=True)``
    for K5 and K6, ``dryrun_cell``'s K7 tap) against its plain version on
    the float32 values of the same inputs, on ``replay_slices``: K5 and
    K6 within ``kernels/flash_limits.py``'s limits (``flash_close``), K7's
    y within one bf16 ulp and its final state within K7_STATE_RTOL
    (``_k7_close``). As controls that must fail, K5 and K6 launched with
    their keys and values swapped (at least CONTROL_FACTOR times the row
    limit), K7 over the second half of its tokens without the state of
    the first."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fb = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    FL = flash_limits()
    out = {}
    for key, rec in kept.items():
        kind = key.split()[0]
        if kind == "K7":
            xdt, a, B, C = (rec[n] for n in ("xdt", "a", "B", "C"))
            h0, chunk = rec["init_state"], rec["chunk"]
            s, p, n = xdt.shape[1], xdt.shape[-1], B.shape[-1]
            y, st = ss.ssd_scan_cuda(xdt, a, B, C, chunk=chunk,
                                     init_state=h0)
            ry, rst = ss.ssd_scan_plain(xdt, a, B, C,
                                        chunk=ss.kernel_chunk(xdt.dtype, p,
                                                              n),
                                        init_state=h0)
            err, st_err = _k7_close(y, st, ry, rst)
            half = s // 2
            must_fail(f"{key}: tokens {half}-{s - 1} without the state of "
                      "the tokens before", lambda: attn_close(
                          ss.ssd_scan_cuda(*(t[:, half:].contiguous()
                                             for t in (xdt, a, B, C)),
                                           chunk=chunk)[0], ry[:, half:]))
            out[key] = dict(max_abs_err=err, state_err=st_err,
                            control="rejected")
            del y, st, ry, rst
            continue
        if kind == "K5":
            q, k, v = rec["args"]
            kw = rec["kw"]
            got = (fa.flash_attention_cuda(q, k, v, **kw),)
            bad = (fa.flash_attention_cuda(q, v, k, **kw),)
        else:
            q, k, v, o, do, lse = rec["args"]
            kw = rec["kw"]
            got = fb.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
            bad = fb.flash_attention_bwd_cuda(q, v, k, o, do, lse, **kw)
        sq, h = q.shape[1], q.shape[2]
        reads, bad_rows, parts = [], [], []
        for rows, qh, kh in replay_slices(q, k, group=kind == "K6"):
            kws = _lengths_of(kw, rows)
            if kind == "K5":
                want = (fa.flash_attention_plain(
                    q[rows, :, qh].float(), k[rows, :, kh].float(),
                    v[rows, :, kh].float(), **kws),)
                idx = ((rows, slice(None), qh),)
                limit, floors = FL.FWD_ROW_RTOL, (ATTN_ULP_FLOOR,)
            else:
                want = fb.flash_attention_bwd_plain(
                    *(x[rows, :, hh].float() for x, hh in (
                        (q, qh), (k, kh), (v, kh), (o, qh), (do, qh))),
                    lse.view(q.shape[0], h, sq)[rows, qh].reshape(-1, sq),
                    **kws)
                idx = ((rows, slice(None), qh), (rows, slice(None), kh),
                       (rows, slice(None), kh))
                limit = FL.BWD_ROW_RTOL
                floors = tuple(max(float(w.abs().max()), 1e-30)
                               * GRAD_ULP_FLOOR for w in want)
            for g_, b_, w, i, floor in zip(got, bad, want, idx, floors):
                reads.append(flash_close(g_[i], w, limit, floor))
                bad_rows.append(FL.row_error(b_[i], w))
            parts.append(f"row {rows.start}, q heads {qh.start}-"
                         f"{qh.stop - 1}" if rows.start is not None
                         else "whole")
            del want
        ratio = control_reads(f"{key} with its keys and values swapped",
                              max(bad_rows), limit)
        out[key] = dict({n: max(x[n] for x in reads)
                         for n in ("max_abs_err", "row_err", "ulps")},
                        control_ratio=ratio, held_on=parts)
        del got, bad
    return out


def _wait_for(paths: list, deadline: float) -> None:
    while not all(p.exists() for p in paths):
        check(time.monotonic() < deadline, "phase 29: a sibling cell's "
              "trace did not end in time")
        time.sleep(0.1)


def dryrun_cell(mesh_name: str, arch: str, shape_name: str, device: str,
                small: bool, out: str, lock: str, cells: int) -> None:
    """One cell of phase 29 in a process of its own, as rank 0 of a fake
    world of the mesh's size: traced on meta (the traces of the cells
    overlap); then, once every cell's trace has ended (so that no trace
    shares the host's cores with a timed step), realized on ``device``
    holding the lock file, one cell on the card at a time; then the step
    run again with its K5, K6 and K7 launches kept, and those held
    against their plain versions (``dryrun_replays``). Writes both
    records and the replays to ``out``."""
    import fcntl
    import inspect
    import torch
    from repro_torch.configs import SHAPES_BY_NAME, get_config, reduced
    from repro_torch.configs.base import MeshConfig, ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    mcfg = dryrun.mesh_config_of(mesh_name)
    if small:
        cfg = reduced(cfg)
        shape = ShapeConfig(shape.name, *SMALL_DRYRUN_SHAPES[shape.kind],
                            shape.kind)
        mcfg = MeshConfig(LM_MESH, ("data", "model"))

    def mesh_on(dev):
        if small:
            return dryrun.make_mesh_from_config(mcfg, dev)
        return dryrun.make_mesh(mesh_name, dev)

    kept_k7 = {}

    def keep_k7(i, fn, *args, **kw):
        a = inspect.signature(fn).bind(*args, **kw)
        a.apply_defaults()
        key = f"K7 xdt {list(a.arguments['xdt'].shape)}"
        if key not in kept_k7 and a.arguments["xdt"].is_cuda:
            kept_k7[key] = {n: x.clone() if isinstance(x, torch.Tensor)
                            else x for n, x in a.arguments.items()}
        return fn(*args, **kw)

    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    with dryrun.fake_world(mcfg.num_devices):
        t0 = time.perf_counter()
        try:
            traced = dryrun.lower_cell(cfg, shape, mcfg, mesh_on("meta"))
        finally:
            Path(out + ".traced").touch()
        traced["total_s"] = time.perf_counter() - t0
        _wait_for([Path(out).parent / f"cell{i}.json.traced"
                   for i in range(cells)], deadline)
        with open(lock, "a") as held:
            fcntl.flock(held, fcntl.LOCK_EX)
            t0 = time.perf_counter()
            mesh = mesh_on(torch.device(device))
            realized = dryrun.lower_cell(cfg, shape, mcfg, mesh)
            realized["total_s"] = time.perf_counter() - t0
            # the launches kept on a run of their own, apart from the
            # counted and timed one
            t0 = time.perf_counter()
            cell = dryrun.build_cell(cfg, shape, mcfg, mesh)
            with _KeepLargest(each=True) as keep, K7Tap(keep_k7), \
                    shd.use_ctx(cell.ctx):
                cell.run()
            del cell
            replays = dryrun_replays({**keep.kept, **kept_k7})
            del keep, kept_k7
            realized["replay_s"] = time.perf_counter() - t0
    Path(out).write_text(json.dumps({"traced": traced, "realized": realized,
                                     "replays": replays}))


def dryrun_launches(cfg, rec: dict) -> dict:
    """The launches one rank's step of the cell implies: a train step's
    micro-batches each a step of ``train_launches``; a prefill's K5 once
    an attention block and K7 once a layer; a decode step none."""
    if rec["kind"] == "train":
        return train_launches(cfg, rec["profile"]["num_microbatches"])
    if rec["kind"] == "prefill":
        return serve_launches(cfg, {})
    return {}


def dryrun_phase(dev, card: str, small: bool = False,
                 cells: tuple = DRYRUN_CELLS) -> dict:
    """Phase 29: each cell in a process of its own (``dryrun_cell``, all
    started together), then the realized rank held against the trace:
    the state and cache bytes exactly, every collective's count, and on
    the card the launches the step implies, each on its bf16 design, and
    a launch of each of its kernels at each signature held against the
    plain version with its control (``dryrun_replays``). The peaks, the
    step's seconds and the collective bytes are printed."""
    from repro_torch.configs import get_config, reduced
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="dryrun_", dir=ROOT / "build"))
    lock = work / "card.lock"
    code = ("import sys; sys.path[:0] = [{src!r}, {root!r}]; "
            "import chip_smoke; chip_smoke.dryrun_cell(*sys.argv[1:5], "
            "sys.argv[5] == '1', *sys.argv[6:8], int(sys.argv[8]))")
    code = code.format(src=str(ROOT / "src"), root=str(ROOT))
    procs = []
    try:
        for i, (mesh_name, arch, shape) in enumerate(cells):
            args = [mesh_name, arch, shape, str(dev), "1" if small else "0",
                    str(work / f"cell{i}.json"), str(lock), str(len(cells))]
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, *args], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        outs = []
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            outs.append(p.communicate(timeout=left)[0])
        for (mesh_name, arch, shape), p, text in zip(cells, procs, outs):
            check(p.returncode == 0, f"phase 29: {mesh_name} {arch} {shape} "
                  f"exited {p.returncode}:\n{text[-3000:]}")
        recs = [json.loads((work / f"cell{i}.json").read_text())
                for i in range(len(cells))]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(work, ignore_errors=True)
    cuda = dev.type == "cuda"
    out = {}
    for (mesh_name, arch, shape), pair in zip(cells, recs):
        traced, real = pair["traced"], pair["realized"]
        tag = f"29 {arch} {shape}"
        cfg = get_config(arch)
        if small:
            cfg = reduced(cfg)
        want = dryrun_launches(cfg, traced)
        got = {k: v["launches"] for k, v in real.get("launches", {}).items()
               if v["launches"]}
        mem_t, mem_r = traced["memory"], real["memory"]
        log(f"phase {tag} on the {tuple(traced['mesh']['shape'])} mesh "
            f"({traced['chips']} ranks, "
            f"rank {real['rank']}), profile "
            + json.dumps({k: traced["profile"][k] for k in (
                "attn_tp", "mlp_tp", "vocab_tp", "expert_tp", "ssd_tp",
                "kv_repeat", "kv_seq_shard", "remat_group",
                "num_microbatches") if k in traced["profile"]})
            + f": state {real['state_bytes_per_device']} B realized, "
            f"{traced['state_bytes_per_device']} B traced"
            + (f"; cache {real['cache_bytes_per_device']} B realized, "
               f"{traced['cache_bytes_per_device']} B traced (decode at "
               f"pos {real['decode_pos']})"
               if "cache_bytes_per_device" in traced else ""))
        log(f"  peak {mem_r['peak_bytes'] / 1e9:.3f} GB realized "
            f"({mem_r['peak_of']}), {mem_t['peak_bytes'] / 1e9:.3f} GB traced "
            f"({mem_t['peak_of']}); step "
            f"{real.get('step_s', float('nan')):.4f} s on CUDA events (every "
            f"trace ended), {real['trace_s']:.2f} s on the host clock (the "
            f"trace {traced['trace_s']:.2f} s, {traced['cost']['flops']:.4e} "
            f"flops: {traced['cost']['flops_of']}); launches {got} (the path implies "
            f"{want}); the process's trace and realization "
            f"{traced['total_s']:.1f} + {real['total_s']:.1f} s; {card}")
        log("  collectives realized: " + "; ".join(
            f"{k} {v['count']} calls {v['bytes'] / 1e9:.4f} GB"
            for k, v in real["collectives"].items())
            + " | traced: " + "; ".join(
            f"{k} {v['count']} calls {v['bytes'] / 1e9:.4f} GB"
            for k, v in traced["collectives"].items()))
        check(real["device"] == dev.type and traced["device"] == "meta",
              f"{tag}: realized on {real['device']}, traced on "
              f"{traced['device']}")
        for key in ("state_bytes_per_device", "cache_bytes_per_device"):
            check(real.get(key) == traced.get(key),
                  f"{tag}: {key} {real.get(key)} realized, {traced.get(key)} "
                  "traced")
        counts = ({k: v["count"] for k, v in real["collectives"].items()},
                  {k: v["count"] for k, v in traced["collectives"].items()})
        check(counts[0] == counts[1] and counts[0],
              f"{tag}: collective counts {counts[0]} realized, {counts[1]} "
              "traced")
        if cuda:
            check(set(got) == set(want), f"{tag}: launched {got}, the path "
                  f"implies {want}")
            check_designs(tag, {"rank": real["rank"], "launches": {
                k: v["launches"] for k, v in real["launches"].items()},
                "by_design": {k: v["by_design"]
                              for k, v in real["launches"].items()}}, want)
            held = {key.split()[0] for key in pair["replays"]}
            check(held == set(want), f"{tag}: launches held against their "
                  f"plain versions {sorted(held)}, the path implies "
                  f"{sorted(want)}")
        for key, rp in pair["replays"].items():
            log(f"  {key}: held against the plain version"
                + (f" on {', '.join(rp['held_on'])}" if "held_on" in rp
                   else "") + f": max_abs_err {rp['max_abs_err']:.3g}"
                + (f", worst row {rp['row_err']:.3g}, {rp['ulps']:.1f} "
                   f"ulps, the control {rp['control_ratio']:.1f} x the "
                   "row limit" if "row_err" in rp else
                   f", final state {rp['state_err']:.3g} of its largest, the "
                   f"control {rp['control']}")
                + f" ({card})")
        if cuda:
            log(f"  the keeping run and the replays {real['replay_s']:.1f} s")
        out[f"29_{arch}_{shape}"] = {"traced": traced, "realized": real,
                                     "launches": got, "implied": want,
                                     "replays": pair["replays"]}
    if cuda:
        launched = set().union(*(r["launches"] for r in out.values()))
        check({"K5", "K6", "K7"} <= launched,
              f"phase 29: the cells launched {sorted(launched)}, not K5, K6 "
              "and K7")
    out["wall_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=float, default=1.5,
                    help="windows of processing time streamed in phase 1 "
                    "(2 until phase 29)")
    ap.add_argument("--splitk-windows", type=float, default=2.0,
                    help="windows of processing time streamed in phase 2")
    ap.add_argument("--lrb-windows", type=float, default=1.5,
                    help="windows of processing time streamed in phase 12 "
                    "(2 until phase 29)")
    ap.add_argument("--pipeline-windows", type=float, default=1.5,
                    help="windows of processing time streamed in phase 13 "
                    "(phase 1's until phase 29)")
    ap.add_argument("--failure-windows", type=float, default=1.5,
                    help="windows of processing time streamed by each "
                    "failure control of phase 13b (2 until phase 29)")
    ap.add_argument("--tenant-seconds", type=float, default=45.0,
                    help="seconds of processing time streamed in phase 14")
    ap.add_argument("--chaos-windows", type=float, default=1.5,
                    help="windows of processing time streamed by each run of "
                    "phase 15 (2 until phase 29)")
    ap.add_argument("--recovery-windows", type=float, default=1.25,
                    help="windows of processing time streamed in phase 16 "
                    "(1.25 since phase 29: three checkpoints; 1.5 and four "
                    "since phase 28g/28h)")
    ap.add_argument("--sharded-windows", type=float, default=3.0,
                    help="windows of processing time streamed in phase 27a")
    ap.add_argument("--sharded-splitk-windows", type=float, default=2.0,
                    help="windows of processing time streamed in phase 27b")
    ap.add_argument("--sharded-lrb-windows", type=float, default=1.5,
                    help="windows of processing time streamed in phase 27c")
    ap.add_argument("--sharded-stacked-windows", type=float, default=0.5,
                    help="windows of processing time streamed in each of "
                    "phases 27d and 27e")
    ap.add_argument("--out", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    args = ap.parse_args(argv)
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
        # phase 27: phase 1's and phase 12's deployments slot-sharded
        t0 = time.perf_counter()
        devices = slot_mesh_devices(count)
        log(f"phase 27: slot mesh {devices} ("
            + ("one card per shard" if count >= SHARDS else
               f"{count} card(s): cuda:0 named {SHARDS} times: the sharded "
               "placement, masking and per-shard launches on one card, "
               "nothing of scaling") + ")")
        runs.update(sharded_phases(
            dev, spill_root, {"27a": args.sharded_windows,
                              "27b": args.sharded_splitk_windows,
                              "27c": args.sharded_lrb_windows,
                              "27d": args.sharded_stacked_windows,
                              "27e": args.sharded_stacked_windows},
            runs["main"]["events_per_s"], wrappers, devices))
        log(f"phase 27: {time.perf_counter() - t0:.1f} s")
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
    sharded = [t for _, t, *_ in SHARDED_RUNS]
    for entry, key in zip(kernels, ("K1", "K2", "K3")):
        # each shard's launches in phase 27, by design
        entry["launches_by_shard"] = {t: runs[t]["by_shard"][key]
                                      for t in sharded}
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

    # phase 7b: the entry point with --arch SSM_ARCH (reduced: K7 on its
    # CUDA-core design at p 32), resumed
    every_k7 = all_wrappers()
    zero_counts(every_k7.values())
    t0 = time.perf_counter()
    entry_root.mkdir(parents=True, exist_ok=True)
    try:
        entry = run_entry(dev, entry_root, arch=SSM_ARCH)
    finally:
        shutil.rmtree(entry_root, ignore_errors=True)
    torch.cuda.synchronize()
    entry["launches"] = {k: fn.launches for k, fn in every_k7.items()}
    entry["by_design"] = by_design(every_k7)["K7"]
    entry["wall_s"] = time.perf_counter() - t0
    log(f"phase 7b: launch.train --arch {SSM_ARCH} ({entry['config']}, "
        f"{entry['params']} parameters) to step {ENTRY_RUN['first']}, then "
        f"resumed from step {entry['resumed_from']} to "
        f"{ENTRY_RUN['second']} with the saved parameters bit for bit, "
        f"restarts {entry['restarts']}, in {entry['wall_s']:.1f} s; losses "
        f"{[round(x, 4) for x in entry['losses']]}; launches "
        f"{entry['launches']} (K7 by design {entry['by_design']})")
    check(entry["launches"]["K7"] > 0, "entry point 7b: K7 never launched")
    check(entry["by_design"] == {"tensor": 0,
                                 "cuda_core": entry["launches"]["K7"]},
          f"entry point 7b: K7 by design {entry['by_design']}: the reduced "
          "config (p 32) must take the CUDA-core design")
    for k, n in entry["launches"].items():
        check(k == "K7" or n == 0, f"entry point 7b: {k} launched {n} "
                                   "times on an attention-free model")
    runs["entry_ssm"] = entry

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

    # phases 17-19: the MoE family served and trained at qwen3-moe-30b's
    # width, then the four examples, each in its own process
    every = all_wrappers()
    runs.update(moe_phases(dev, every))
    t0 = time.perf_counter()
    runs["examples"] = examples_phase()
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    # phases 20-22: the SSM and hybrid families trained at full width and
    # depth, then the training switches
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(ssm_train_phases(dev, every))
    # phases 23-26: the enc-dec (audio) family served and trained at
    # seamless-m4t-medium's full width and depth, the VLM served at
    # internvl2-76b's full width, then K5's and K6's non-causal replays
    gc.collect()
    torch.cuda.empty_cache()
    front = frontend_phases(dev, every, card=card)
    runs.update(front["runs"])
    report["noncausal_replays"] = front["replays"]
    report["masked_replays"] = front["masked"]
    for entry in kernels:
        key = entry["name"].split("(")[1].split(",")[0]
        if key in front["replays"]:
            entry["non_causal"] = {
                name: {k: r[k] for k in (
                    "max_abs_err", "row_err", "control_ratio", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "shape")}
                for name, r in front["replays"][key].items()}
            # the masked replays (per-row key lengths) fold into the
            # kernel's error, as phase 5's window replay does
            masked = {name: rec[key] for name, rec in front["masked"].items()}
            entry["masked"] = {
                name: {k: r[k] for k in (
                    "max_abs_err", "row_err", "control_ratio", "ms",
                    "unmasked_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "shape")}
                for name, r in masked.items()}
            entry["max_abs_err"] = max([entry["max_abs_err"]] + [
                r["max_abs_err"] for r in masked.values()])
            entry["row_err"] = max([entry["row_err"]] + [
                r["row_err"] for r in masked.values()])
    new_runs = {"moe_serve": runs["moe_serve"]["launches"],
                "moe_train": runs["moe_train"]["launches"],
                **{name: r["launches"]
                   for name, r in runs["examples"].items()},
                "entry_ssm": runs["entry_ssm"]["launches"],
                "ssm_train": runs[f"{SSM_ARCH}_train"]["launches"],
                "hybrid_train": runs[f"{HYBRID_ARCH}_train"]["launches"],
                **{name: runs[name]["launches"] for name in (
                    "encdec_serve", "encdec_train", "vlm_serve")}}
    # phase 28: the LM half of multi-device training, a (2, 2) mesh of
    # four ranks on this card
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_world_phase(dev, card)
    log(f"phase 28: {lm['wall_s']:.1f} s")
    for tag, part in LM_PARTS.items():
        runs[f"lm_{tag}"] = {"launches_by_rank": [r["launches"]
                                                  for r in lm[part]],
                             "ranks": lm[part]}
        new_runs.update({f"{tag}_rank{r['rank']}": r["launches"]
                         for r in lm[part]})
    # phase 29: one rank of three production cells of the dry-run, each
    # traced on meta and realized on this card in a process of its own
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun_phase(dev, card)
    log(f"phase 29: {dry.pop('wall_s'):.1f} s")
    for tag, r in dry.items():
        runs[tag] = r
        new_runs[tag] = {k: r["launches"].get(k, 0) for k in every}
    for entry in kernels:
        key = entry["name"].split("(")[1].split(",")[0]
        entry.setdefault("launches_by_run", {}).update(
            {run: n[key] for run, n in new_runs.items()})
        if key in ("K5", "K6", "K7"):
            entry["launches_by_rank"] = {
                tag: [r["launches"][key] for r in lm[part]]
                for tag, part in LM_PARTS.items()}
        if key in ("K5", "K6"):
            entry["replays_by_rank"] = [
                r["replays"][key]["row_err"] for r in lm["dense"]
                if key in r["replays"]]
        if key in ("K5", "K6", "K7"):
            entry["dryrun_replays"] = {
                tag: {sig: rp["max_abs_err"]
                      for sig, rp in r["replays"].items()
                      if sig.split()[0] == key}
                for tag, r in dry.items()}

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
