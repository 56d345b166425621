"""Batched multi-window execution: one device pass per poll/watermark.

Paper §3 orders work by a strict priority rule — live window executions
first, then late re-executions, with demand staging outranking speculative
pre-staging. The per-window reference path (``StreamEngine.
execute_window``) honors that rule one window at a time, paying a jit
dispatch per block per window; with many concurrent due windows (long
lateness horizons keep many past windows re-executing) the dispatch
overhead — not the fold FLOPs — dominates.

This module keeps the priority rule but batches *within* a priority
class: each ``advance_watermark`` gathers every newly-expired window into
one live batch, and each ``poll`` gathers every due late re-execution
into one late batch — live batches always run before late batches because
the engine calls them in that order, so the rule is preserved at batch
granularity. Re-execution stays a pure function of bucket contents, so
folding N windows in one pass is bitwise-equivalent to N independent
folds up to float associativity (parity-tested in
``tests/test_batch_exec.py`` and ``tests/test_slot_sharding.py``).

Row gathering — the **block-table path** (``AionConfig.block_pool``,
default on): blocks staged by ``core.staging`` live in a persistent
device arena (``core.block_pool``), so a batch over already-resident
blocks is assembled as a *table* of pool-slot indices — O(rows) Python
ints — and the operator's ``fold_batch(..., table=)`` reads the event
tiles straight out of the arena inside the block-table CUDA kernel:
**zero per-batch copies**. Folds over the arena launch on the pool's
CUDA stream, the stream its writes use (``DeviceBlockPool.stream``).
Cold p-blocks are demand-staged INTO the pool at ``PRIO_DEMAND_STAGE``
and that I/O **overlaps** the fold of the already-resident blocks
(``pool_overlap_prefetch``): the executor dispatches the resident
block table, waits for the fills, folds the
newly-filled slots as a second table, and merges the partial accumulators
(``WindowOperator.merge_acc``). Blocks that could not be pooled (slot or
budget exhaustion, overlap off) degrade to the legacy stacked gather.

The legacy **stacked path** (``block_pool=False``, and the pooled path's
per-row fallback) re-materializes each batch: m-bucket rows that already
live on the device are stacked with a device concat (``torch.stack`` —
``AionConfig.device_stacking``; False stacks on the host with
``np.stack`` and copies once) and cold p-blocks are read host-side
through ``IOScheduler.fetch_block_host`` (accounted,
simulated-cost-charged). The stacked fold goes through the flat kernel.

The port runs on one device: multi-device slot sharding
(``AionConfig.slot_sharding``) is not ported (the engine refuses it at
construction), so every round folds unsharded.

Pin strategy. The synchronous engine holds ONE pool pin across the whole
round, the demand-fill wait included. Under the pipelined engine
(``core.pipeline``; ``AionConfig.pool_slot_epochs``) the round runs on
the fold worker thread while the main thread ingests and the I/O thread
fills, destages and recycles slots, so the pin shrinks to the
validate -> dispatch section: rows are classified OUTSIDE any pin from a
``(slot, epoch)`` read (``pool.slot_epochs``), demand fills are waited
for unpinned, and then, under ONE short ``pool.pinned()``, the executor
takes ``snapshot_with_epochs``, validates each row and launches the
folds. A row whose slot or epoch moved since the classify read
(destaged, purged, recycled) demotes to the stacked fallback
(``metrics.epoch_demoted_rows``), which reads the block's current truth.

Why an unchanged epoch proves the fold reads the classified data, on an
arena written IN PLACE (the JAX package's argument was made for an
immutable XLA array captured by value, which the port does not have):
a slot's epoch bumps under the pool lock on every commit and release,
and a commit enqueues its arena write (or, under a deferred-fill lease,
buffers it; ``snapshot_with_epochs`` flushes the buffer before it
returns) on the pool's stream in the same critical section. So an epoch
unchanged between the classify read and the pinned validation means
every write of the row's data was enqueued before the validation, and
no write to the slot was enqueued since. While the pin is held, a
released slot is quarantined rather than freed, so no new occupant can
be committed into a validated slot until the pin ends; the folds are
enqueued before it ends, on the same stream as every arena write, so
any write enqueued after the pin lands behind them. Validation and
dispatch must therefore sit under ONE pin: two pins would leave a gap in
which a validated slot could be released, reallocated and overwritten
before its fold is enqueued.

Every device op of a round — the block-table folds, the stacked
fallback's host-to-device copies, ``merge_acc`` and ``finalize_batch`` —
runs with the pool's stream current (``DeviceBlockPool.stream``), on
whichever thread executes the round: current streams are per thread in
PyTorch, and the worker thread must not fold on another stream than the
one the I/O thread writes the arena on.

Split-K chunk planning (``AionConfig.splitk_chunk_rows > 0``, operators
with ``supports_splitk``): instead of one stripe per window padded to the
next power of two, a round's pooled rows pad to a multiple of the chunk
size and decompose greedily into launch groups of {8, 4, 2, 1} chunks
(``_plan_table_groups``); each group folds through the split-K kernel
(fixed-shape per-chunk partials, merged on-device) and the cross-group
partial accumulators merge via ``WindowOperator.merge_acc``. Every launch
shape is drawn from a fixed repertoire of at most four, so batch-size
changes across rounds keep the launch shapes fixed.
"""
from __future__ import annotations

import contextlib
import time as _time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.buckets import Tier, WindowState
from repro_torch.core.windows import WindowId
from repro_torch.kernels.segment_aggregate import next_pow2
from repro_torch.obs import profiler_annotation


def _i32(values: List[int], device) -> torch.Tensor:
    """Host ints as an int32 tensor on ``device``."""
    return torch.tensor(values, dtype=torch.int32, device=device)


# largest split-K launch group, in chunks: greedy pow2 decomposition of a
# round's chunk count into groups of {8, 4, 2, 1} chunks caps the shape
# repertoire at four launch shapes total (e.g. 13 chunks -> 8 + 4 + 1)
_SPLITK_MAX_CHUNKS = 8


@dataclass
class BatchWorkItem:
    """One due window execution (live expiry or late re-execution)."""
    wid: WindowId
    state: WindowState
    late: bool


def snapshot_block_partition(state: WindowState):
    """Atomic (m, p) partition of a window's blocks.

    Shared by the per-window and batched execution paths — the
    double-fold hazard lives here: snapshot BOTH lists before issuing any
    staging request, otherwise the I/O thread can move a block
    device-side between the two snapshots and it would be folded twice.
    """
    m_snapshot = state.m_blocks()
    m_ids = {id(b) for b in m_snapshot}
    p_blocks = [b for b in state.blocks if id(b) not in m_ids]
    return m_snapshot, p_blocks


def plan_slot_placement(num_windows: int) -> Tuple[List[int], int]:
    """Window ``i`` of a batch folds into slot ``i``; the slot count pads
    to a power of two so the fold sees O(log) distinct launch shapes.
    Returns ``(slot_of_window, num_slots)``. (The JAX package's
    round-robin placement onto device-local slot ranges belongs to the
    unported multi-device slice.)"""
    return list(range(num_windows)), next_pow2(num_windows)


class BatchExecutor:
    """Executes a set of due windows in one vectorized device pass."""

    def __init__(self, engine):
        self.engine = engine

    def _stack(self, rows: List[Any], on_device: bool, dtype) -> Any:
        """Stack per-block rows into one [rows, ...] tensor on the
        engine's device.

        ``on_device=True``: a device concat — already-resident rows are
        consumed in place and host rows are transferred individually, so
        hot m-bucket blocks never round-trip through the host.
        ``on_device=False``: a host ``np.stack`` copied to the device
        once (rows already on the device come back to the host first).
        """
        dev = self.engine.device
        if on_device:
            return torch.stack([
                r.to(dev) if isinstance(r, torch.Tensor)
                else torch.from_numpy(np.asarray(r, dtype)).to(dev)
                for r in rows])
        host = np.stack([r.cpu().numpy() if isinstance(r, torch.Tensor)
                         else np.asarray(r, dtype) for r in rows])
        return torch.from_numpy(host).to(dev)

    # ------------------------------------------------------------ execute
    def execute(self, items: List[BatchWorkItem], now: float,
                trace_parent=None) -> Dict[WindowId, Any]:
        """Fold all items in one device pass; returns results by window.

        Falls back to the per-window reference path when the operator has
        no batch contract or the batch is trivial (a single window gains
        nothing from stacking). An empty item list is a no-op — no
        degenerate [0, ...] tensors, no metrics.

        ``trace_parent`` is the submitting span (watermark advance or
        poll sweep) handed across threads EXPLICITLY — the fold-round
        span it parents carries launch-group/split-K counts and whether
        this round launched a new fold shape.
        """
        eng = self.engine
        op = eng.operator
        if not items:
            return {}
        if not op.supports_batch or len(items) == 1:
            stream = eng.pool.stream() if eng.pool is not None \
                else contextlib.nullcontext()
            with stream:
                return {it.wid: eng.execute_window(it.wid, now, it.late)
                        for it in items}

        span = eng.tracer.child(
            trace_parent, "fold_round", windows=len(items),
            late=sum(1 for it in items if it.late))
        # pre-round registry reads for per-round span deltas (only when
        # this round is actually sampled — the disabled path stays free);
        # "recompiled" reads the fold's count of distinct launch shapes
        shapes = getattr(getattr(op, "fold_batch", None),
                         "launch_shapes", ())
        shapes0 = sk0 = pooled0 = fallback0 = 0
        if span.sampled:
            shapes0 = len(shapes)
            sk0 = eng.metrics.splitk_launches
            pooled0 = eng.metrics.pooled_rows
            fallback0 = eng.metrics.fallback_rows

        with span:
            t0 = _time.time()

            # 1. snapshot every window atomically (membership is fixed
            #    from here on: each block folds exactly once, whatever
            #    tier it moves to while the batch assembles)
            plans = [(it, sum(snapshot_block_partition(it.state), []))
                     for it in items]

            with profiler_annotation(
                    f"aion.fold_round[{len(items)}]",
                    enabled=getattr(eng.aion, "profiler_annotations",
                                    False)):
                if eng.pool is not None:
                    # every device op of the round on the arena's stream
                    with eng.pool.stream():
                        results, slot_of, num_slots, dev_dt, gather_dt = \
                            self._fold_pooled(plans)
                else:
                    results, slot_of, num_slots, dev_dt, gather_dt = \
                        self._fold_stacked(plans)

            # per-window bookkeeping, identical to execute_window
            out: Dict[WindowId, Any] = {}
            for i, (it, _) in enumerate(plans):
                result = results[slot_of[i]]
                it.state.result = result
                eng.results[it.wid] = result
                it.state.last_executed_at = now
                it.state.events_at_last_exec = it.state.total_events
                if it.late:
                    eng.metrics.late_executions += 1
                else:
                    eng.metrics.live_executions += 1
                out[it.wid] = result
                eng._post_execute_destage(it.wid, it.state, now)
            eng.metrics.exec_seconds += _time.time() - t0
            eng.metrics.batch_executions += 1
            eng.metrics.batched_windows += len(plans)
            eng.metrics.batch_device_seconds += dev_dt
            eng.metrics.batch_gather_seconds += gather_dt
            eng.metrics.batch_occupancy_series.append(len(plans))
            eng.metrics.fold_seconds.observe(dev_dt)
            if span.sampled:
                span.set(
                    splitk_launches=eng.metrics.splitk_launches - sk0,
                    pooled_rows=eng.metrics.pooled_rows - pooled0,
                    fallback_rows=eng.metrics.fallback_rows - fallback0,
                    recompiled=bool(len(shapes) > shapes0),
                    device_seconds=round(dev_dt, 6),
                    gather_seconds=round(gather_dt, 6))
                span.event("emit", results=len(out))
        return out

    # ------------------------------------------------------ splitk planning
    def _splitk_chunk(self, num_rows: int) -> int:
        """Effective split-K chunk size for a round of ``num_rows`` rows,
        or 0 when disabled: the knob is off, the operator's accumulator
        cannot merge arbitrary row partials (``supports_splitk`` False),
        or the round is no larger than one chunk (chunking it would only
        add merge overhead)."""
        op = self.engine.operator
        chunk = getattr(self.engine.aion, "splitk_chunk_rows", 0)
        if chunk <= 0 or not getattr(op, "supports_splitk", False):
            return 0
        return chunk if num_rows > chunk else 0

    def _plan_table_groups(self, rows):
        """Launch groups ``[(table, fills, slots, splitk)]`` for pooled
        (block, window_slot, pool_slot) rows.

        Split-K disabled: one group, rows padded to a power of two.
        Split-K: rows pad to a chunk multiple (pool slot 0, fill 0 —
        invalid everywhere, including the ±inf min/max identities) and
        the chunk count decomposes greedily into groups of {8, 4, 2, 1}
        chunks, so every launch shape is one of at most four
        ``{1,2,4,8} * chunk_rows`` shapes regardless of batch size.
        Cross-group partials merge via ``op.merge_acc`` in the shared
        tail."""
        chunk = self._splitk_chunk(len(rows))
        dev = self.engine.device
        table = [ps for _, _, ps in rows]
        fills = [blk.fill for blk, _, _ in rows]
        slots = [ws for _, ws, _ in rows]
        pad = (next_pow2(len(rows)) - len(rows) if chunk == 0
               else (-len(rows)) % chunk)
        table += [0] * pad
        fills += [0] * pad
        slots += [0] * pad
        if chunk == 0:
            return [(_i32(table, dev), _i32(fills, dev), _i32(slots, dev),
                     0)]
        groups = []
        off = 0
        remaining = len(table) // chunk
        while remaining:
            g = min(_SPLITK_MAX_CHUNKS, 1 << (remaining.bit_length() - 1))
            n = g * chunk
            groups.append((_i32(table[off:off + n], dev),
                           _i32(fills[off:off + n], dev),
                           _i32(slots[off:off + n], dev),
                           chunk))
            off += n
            remaining -= g
        return groups

    def _fold_table_groups(self, groups, arena_data, num_slots, accs):
        """Dispatch every launch group against one arena snapshot; the
        group accumulators append to ``accs`` (merged in the shared
        tail). Returns the host seconds spent enqueueing them."""
        eng = self.engine
        op = eng.operator
        d0 = _time.time()
        for table, fills, slots, sk in groups:
            accs.append(op.fold_batch(arena_data, fills, slots, num_slots,
                                      table=table, splitk=sk))
            if sk:
                eng.metrics.splitk_launches += 1
        return _time.time() - d0

    def _stack_rows(self, rows):
        """Stacked (data, fills, slots) tensors from (arrays, fill,
        window_slot) rows, padded to a power-of-two row count with
        invalid rows (fill 0, slot 0) so the fold sees O(log) distinct
        shapes. The stack carries keys + values only: no batch fold is
        time-dependent within a window, and stacking timestamps would
        force a D2H pull of every hot device-resident row (see the
        fold_batch contract).
        """
        eng = self.engine
        cap = eng.aion.block_size
        w = eng.value_width
        pad = next_pow2(len(rows)) - len(rows)
        keys_rows = [arrs["keys"] for arrs, _, _ in rows] \
            + [np.zeros((cap,), np.int32)] * pad
        val_rows = [arrs["values"] for arrs, _, _ in rows] \
            + [np.zeros((cap, w), np.float32)] * pad
        fills = [fill for _, fill, _ in rows] + [0] * pad
        slots = [slot for _, _, slot in rows] + [0] * pad
        on_device = getattr(eng.aion, "device_stacking", True)
        data = {
            "keys": self._stack(keys_rows, on_device, np.int32),
            "values": self._stack(val_rows, on_device, np.float32),
        }
        return (data, _i32(fills, eng.device), _i32(slots, eng.device))

    def _gather_rows(self, blocks):
        """(arrays, fill, window_slot) for ``(block, window_slot)`` pairs,
        after one batched store readahead so cold p-blocks arrive via a
        sequential segment sweep instead of per-block random reads.
        Blocks purged mid-gather drop out."""
        eng = self.engine
        eng.io.readahead_blocks([blk for blk, _ in blocks])
        rows = []
        for blk, wslot in blocks:
            arrs = eng.io.fetch_block_arrays(blk)
            if arrs is not None:
                rows.append((arrs, blk.fill, wslot))
        return rows

    # ----------------------------------------------------- stacked gather
    def _fold_stacked(self, plans):
        """Legacy gather: re-materialize the batch as stacked tensors
        (device concat of resident rows; host reads of cold p-blocks)."""
        op = self.engine.operator
        slot_of, num_slots = plan_slot_placement(len(plans))
        g0 = _time.time()
        rows = self._gather_rows([(blk, slot_of[i])
                                  for i, (_, blocks) in enumerate(plans)
                                  for blk in blocks if blk.fill])
        dev_dt = 0.0
        if rows:
            data, fills, slots = self._stack_rows(rows)
            gather_dt = _time.time() - g0
            dev_t0 = _time.time()
            results = op.run_batch(data, fills, slots, num_slots)
            dev_dt = _time.time() - dev_t0
        else:
            gather_dt = _time.time() - g0
            # every window empty: finalize the identity accumulator
            results = [op.finalize(op.init_acc()) for _ in range(num_slots)]
        return results, slot_of, num_slots, dev_dt, gather_dt

    # ------------------------------------------------------- pooled gather
    def _fold_pooled(self, plans):
        """Block-table gather over the persistent pool.

        Three row classes, folded as up to three partial accumulators and
        merged (``op.merge_acc``):
          * resident rows — already in the arena: block table, zero-copy;
          * cold p-blocks — demand pool-fills at PRIO_DEMAND_STAGE whose
            I/O overlaps the resident fold; filled slots fold as a second
            block table, the rest degrade to the stacked fallback;
          * fallback rows — unpoolable (slot/budget exhaustion, legacy
            device_data): the stacked gather.

        The synchronous engine runs the whole round under ONE pool pin: a
        slot released while a fold that names it may still be unlaunched
        is quarantined, never refilled (see ``core.block_pool``).
        ``deferred_fills`` batches the round's cold fills into ONE
        ``index_copy_`` at the second snapshot — k overlapped fills cost
        one write of k blocks. The pipelined engine takes the
        epoch-checked strategy instead (``_fold_pooled_epochs``; the
        module docstring sets out why it is sound on an arena written in
        place).
        """
        eng = self.engine
        pool = eng.pool
        slot_of, num_slots = plan_slot_placement(len(plans))

        g0 = _time.time()
        gather_dt = 0.0
        dev_dt = 0.0
        blocks: List[Tuple[Any, int]] = []        # (block, window index)
        for i, (it, blks) in enumerate(plans):
            for blk in blks:
                if blk.fill:
                    blocks.append((blk, i))

        if eng.pipeline is not None \
                and getattr(eng.aion, "pool_slot_epochs", True):
            return self._fold_pooled_epochs(plans, blocks, slot_of,
                                            num_slots, g0)

        accs: List[Any] = []
        cold: List[Tuple[Any, int]] = []          # (block, window index)
        fallback: List[Tuple[Any, int]] = []      # (block, wslot)
        with pool.pinned(), pool.deferred_fills():
            k_arena, v_arena, pslots = pool.snapshot_for(
                [b for b, _ in blocks])
            arena_data = {"keys": k_arena, "values": v_arena}

            pooled: List[Tuple[Any, int, int]] = []  # (blk, wslot, pslot)
            for (blk, i), ps in zip(blocks, pslots):
                if ps is not None:
                    pooled.append((blk, slot_of[i], ps))
                elif blk.tier != Tier.DEVICE \
                        and eng.aion.pool_overlap_prefetch:
                    cold.append((blk, i))
                else:
                    fallback.append((blk, slot_of[i]))

            # demand pool-fills for cold p-blocks: issued BEFORE the
            # resident fold so the I/O executor stages while the device
            # folds (the paper's demand-staging-outranks-prestaging rule,
            # at pool granularity)
            evs = self._request_fills(plans, cold)
            gather_dt += _time.time() - g0

            if pooled:
                g0 = _time.time()
                groups = self._plan_table_groups(pooled)
                gather_dt += _time.time() - g0
                dev_dt += self._fold_table_groups(groups, arena_data,
                                                  num_slots, accs)
                eng.metrics.pooled_rows += len(pooled)

            if evs:
                self._wait_fills(evs)
                g0 = _time.time()
                k2, v2, ps2 = pool.snapshot_for([b for b, _ in cold])
                staged: List[Tuple[Any, int, int]] = []
                for (blk, i), ps in zip(cold, ps2):
                    if ps is not None:
                        staged.append((blk, slot_of[i], ps))
                    else:
                        # fill failed (budget/pool exhaustion): the
                        # stacked fallback reads it (device-preferred,
                        # host-accounted)
                        fallback.append((blk, slot_of[i]))
                gather_dt += _time.time() - g0
                if staged:
                    g0 = _time.time()
                    groups = self._plan_table_groups(staged)
                    arena2 = {"keys": k2, "values": v2}
                    gather_dt += _time.time() - g0
                    dev_dt += self._fold_table_groups(groups, arena2,
                                                      num_slots, accs)
                    eng.metrics.pooled_rows += len(staged)

        return self._fold_pooled_tail(accs, fallback, slot_of, num_slots,
                                      dev_dt, gather_dt)

    def _fold_pooled_epochs(self, plans, blocks, slot_of, num_slots, g0):
        """The pipelined engine's pin strategy: classify every row from an
        unpinned ``(slot, epoch)`` read, issue and wait for the demand
        fills unpinned, then validate and dispatch under ONE short pin.
        Resident and freshly filled rows fold as one block table; rows
        whose pair moved since classification demote to the stacked
        fallback (``metrics.epoch_demoted_rows``)."""
        eng = self.engine
        pool = eng.pool
        gather_dt = 0.0
        dev_dt = 0.0
        accs: List[Any] = []
        cold: List[Tuple[Any, int]] = []          # (block, window index)
        fallback: List[Tuple[Any, int]] = []      # (block, wslot)
        # (block, window index, pool slot, epoch)
        classified: List[Tuple[Any, int, int, int]] = []
        for (blk, i), (ps, ep) in zip(blocks, pool.slot_epochs(
                [b for b, _ in blocks])):
            if ps is not None:
                classified.append((blk, i, ps, ep))
            elif blk.tier != Tier.DEVICE and eng.aion.pool_overlap_prefetch:
                cold.append((blk, i))
            else:
                fallback.append((blk, slot_of[i]))
        if cold:
            # wait UNPINNED, before the snapshot: inter-round overlap
            # comes from the round queue (round k+1's prefetch staged
            # during round k's fold), so this wait is only the prefetch
            # residual, and resident and freshly filled rows then fold
            # as ONE table
            self._wait_fills(self._request_fills(plans, cold))
            for (blk, i), (ps, ep) in zip(cold, pool.slot_epochs(
                    [b for b, _ in cold])):
                if ps is not None:
                    classified.append((blk, i, ps, ep))
                else:           # the fill could not take a slot
                    fallback.append((blk, slot_of[i]))
        gather_dt += _time.time() - g0

        if classified:
            g0 = _time.time()
            # one short pin: capture + validate + pack + dispatch
            with pool.pinned():
                k_arena, v_arena, ps_now, ep_now = \
                    pool.snapshot_with_epochs(
                        [b for b, _, _, _ in classified])
                pooled: List[Tuple[Any, int, int]] = []
                for (blk, i, ps, ep), ps2, ep2 in zip(classified, ps_now,
                                                       ep_now):
                    if ps2 == ps and ep2 == ep:
                        pooled.append((blk, slot_of[i], ps))
                    else:
                        # destaged / purged / recycled since the classify
                        # read: fold the block's current truth through the
                        # stacked fallback
                        eng.metrics.epoch_demoted_rows += 1
                        fallback.append((blk, slot_of[i]))
                if pooled:
                    groups = self._plan_table_groups(pooled)
                    gather_dt += _time.time() - g0
                    dev_dt += self._fold_table_groups(
                        groups, {"keys": k_arena, "values": v_arena},
                        num_slots, accs)
                    eng.metrics.pooled_rows += len(pooled)
                else:
                    gather_dt += _time.time() - g0
        return self._fold_pooled_tail(accs, fallback, slot_of, num_slots,
                                      dev_dt, gather_dt)

    def _request_fills(self, plans, cold) -> List[Any]:
        """Demand pool-fills for cold ``(block, window index)`` rows, one
        request per window; returns their task handles."""
        eng = self.engine
        by_window: Dict[int, List[Any]] = {}
        for blk, i in cold:
            by_window.setdefault(i, []).append(blk)
        eng.metrics.demand_pool_fills += len(cold)
        return [eng.io.request_stage(plans[i][0].state, blks, demand=True)
                for i, blks in by_window.items()]

    def _wait_fills(self, evs) -> None:
        """Wait for demand fills, counting the stall; a failed fill aborts
        the round (``StagingError``)."""
        w0 = _time.time()
        for ev in evs:
            ev.wait(timeout=60)
        self.engine.metrics.batch_stall_seconds += _time.time() - w0
        for ev in evs:
            ev.check()

    def _fold_pooled_tail(self, accs, fallback, slot_of, num_slots,
                          dev_dt, gather_dt):
        """Fold the fallback rows through the stacked gather, then merge
        the partial accumulators into per-slot results."""
        eng = self.engine
        op = eng.operator
        if fallback:
            g0 = _time.time()
            rows = self._gather_rows(fallback)
            if rows:
                data, fills, slots = self._stack_rows(rows)
                gather_dt += _time.time() - g0
                d0 = _time.time()
                accs.append(op.fold_batch(data, fills, slots, num_slots))
                dev_dt += _time.time() - d0
                eng.metrics.fallback_rows += len(rows)
            else:
                gather_dt += _time.time() - g0

        if not accs:
            # every window empty: finalize the identity accumulator
            results = [op.finalize(op.init_acc()) for _ in range(num_slots)]
        else:
            d0 = _time.time()
            acc = accs[0]
            for a in accs[1:]:
                acc = op.merge_acc(acc, a)
            results = op.finalize_batch(acc, num_slots)
            dev_dt += _time.time() - d0
        return results, slot_of, num_slots, dev_dt, gather_dt
