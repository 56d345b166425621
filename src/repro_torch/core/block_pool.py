"""Persistent device block pool: the arena behind the block-table fold.

The KV-cache idiom (flash-decoding's ``block_tables`` over a paged cache)
applied to Aion's m-bucket: instead of a per-block copy to the device
whose tensors are re-stacked into ``[rows, cap, W]`` on every batched
fold, staging writes each block ONCE into a preallocated device arena —

    keys_arena    [pool_slots, block_capacity]      int32
    values_arena  [pool_slots, block_capacity, W]   float32

— at a free pool slot (an ``index_copy_``), and the batched fold
consumes a *block table* of slot indices. Hot m-bucket blocks never leave
the arena between executions, so a batch over resident blocks launches
with zero per-batch copies: the block-table CUDA kernel reads each row's
tile straight out of the arena (the plain version, for CPU tensors, takes
one ``index_select`` along the pool axis).

Slot lifecycle:

    free -> filling -> resident -> folding -> destaged(free)

Concurrency contract (engine main thread + I/O executor thread):

* Arena updates are **in place** (``index_copy_`` at the slot, O(block)
  per fill) and run on the pool's CUDA stream, the stream that was
  current when the pool was built. The batch executor launches its folds
  on that same stream (``pool.stream()``), so stream order protects a
  fold already enqueued: a later write to a slot it reads runs after it.
* What stream order cannot protect is the gap between ``snapshot_for``
  (which reads each block's slot) and the fold's launch: the I/O thread
  could release a slot in that gap, reallocate it and refill it, and the
  fold would read the new occupant. The executor therefore brackets each
  snapshot -> fold-launch section with ``pinned()``; while any pin is
  held, a released slot is **quarantined** instead of returning to the
  free list, and it comes back only when the last pin ends (by then every
  fold that could name it has been enqueued). Fresh fills during a pin
  take other free slots, which no pinned snapshot names.
* ``commit`` (write + ``block.pool_slot`` assignment) and
  ``snapshot_for`` (slot reads) are atomic under the pool lock, so a
  snapshot either sees a slot with its data already written, or no slot
  at all (the row falls back to the host path). ``release_slot`` clears
  ``block.pool_slot`` under the same lock, which makes a slot return to
  the free list exactly once even when a purge races an in-flight stage
  (both sides run under ``block.lock`` and surrender the slot through
  here).
* Timestamps are deliberately not pooled — no batch fold is
  time-dependent within a window (see the ``fold_batch`` contract); the
  host copy keeps them for checkpoints.

Slots partition into ``num_shards`` contiguous ranges for the slot-sharded
fold: a window's blocks are allocated in the range of the shard that
``distributed.sharding.shard_of_window`` assigns the window to, so the
block table a shard receives only ever references its own arena range
(the shard_map passes each device its ``[pool_slots/D, ...]`` arena tile).
The port runs one device; the shard ranges are kept for the bookkeeping.
"""
from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.obs import MetricsRegistry, StatsMap


class DeviceBlockPool:
    """Preallocated device arena + per-shard slot free lists."""

    def __init__(self, pool_slots: int, block_capacity: int, width: int,
                 num_shards: int = 1,
                 max_arena_bytes: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device=None):
        num_shards = max(int(num_shards), 1)
        pool_slots = max(int(pool_slots), num_shards)
        # round up to a multiple of the shard count so the arena splits
        # evenly into the shard ranges
        pool_slots = -(-pool_slots // num_shards) * num_shards
        row_bytes = block_capacity * (4 + 4 * width)
        if max_arena_bytes is not None and row_bytes > 0:
            # round DOWN to the shard multiple: the arena must never
            # exceed max_arena_bytes (the engine's at-most-half-budget
            # guarantee for utilization-driven policies); a cap below
            # one slot per shard disables the pool entirely — callers
            # check ``pool_slots == 0`` and fall back to the legacy path
            fit = (max_arena_bytes // row_bytes) // num_shards * num_shards
            pool_slots = min(pool_slots, fit)
        self.pool_slots = pool_slots
        self.capacity = block_capacity
        self.width = width
        self.device = resolve_device(device)
        # physical device bytes the arenas occupy — charged ONCE against
        # the engine's device budget at construction; a pooled fill then
        # costs a slot, not a second per-block reservation (the legacy
        # per-block path still reserves per block)
        self.arena_bytes = pool_slots * row_bytes
        self.num_shards = num_shards
        self.slots_per_shard = pool_slots // num_shards
        self._lock = threading.Lock()
        self._pins = 0                     # live snapshot sections
        self._deferred = 0                 # live deferred-fill sections
        # slots released while pinned: free again when the last pin ends
        self._quarantine: List[int] = []
        # slot -> (keys, values) commits buffered while deferred; flushed
        # as ONE batched index_copy_ at the next snapshot/read
        self._pending: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._free: List[deque] = [
            deque(range(d * self.slots_per_shard,
                        (d + 1) * self.slots_per_shard))
            for d in range(num_shards)]
        self._rr = 0                       # round-robin for shard=None
        # per-slot epoch/sequence scheme: a slot's epoch bumps whenever
        # its CONTENTS or OWNERSHIP change (commit, release, free) —
        # never on alloc, which only removes the slot from the free list.
        # An executor may classify rows from an unpinned (slot, epoch)
        # read and re-validate the pairs under a short pin at launch: an
        # unchanged epoch proves the arena still holds exactly the data
        # the row was classified against.
        self._slot_epoch: List[int] = [0] * pool_slots
        self.seq = 0                       # global epoch counter
        self.keys = torch.zeros((pool_slots, block_capacity),
                                dtype=torch.int32, device=self.device)
        self.values = torch.zeros((pool_slots, block_capacity, width),
                                  dtype=torch.float32, device=self.device)
        # every arena write and every fold over it runs on this stream
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        registry = registry if registry is not None else MetricsRegistry()
        self.registry = registry
        self.stats = StatsMap(registry, "aion_pool")
        self.stats.register_many([
            "allocs", "frees", "exhausted", "writes", "quarantined",
            "deferred_fills", "batched_fill_commits", "epoch_bumps"])
        # occupancy gauges are cheaper polled than maintained: the
        # registry snapshot calls back into the pool under its lock
        registry.register_callback(lambda: {
            "aion_pool_free_slots": self.free_slots(),
            "aion_pool_slots": self.pool_slots,
            "aion_pool_arena_bytes": self.arena_bytes,
        })

    def stream(self):
        """Context that makes the pool's CUDA stream current: arena writes
        run under it, and so must every fold that reads the arena (stream
        order is what keeps an enqueued fold ahead of a later write)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _bump_epoch_locked(self, slot: int) -> None:
        self._slot_epoch[slot] += 1
        self.seq += 1
        self.stats.inc("epoch_bumps")

    def _release_locked(self, slot: int) -> None:
        """Return ``slot`` to its free list, or to quarantine while a
        pinned snapshot may still name it (caller holds the lock)."""
        self._pending.pop(slot, None)
        if self._pins:
            self._quarantine.append(slot)
            self.stats.inc("quarantined")
        else:
            self._free[self.shard_of_slot(slot)].append(slot)
        self._bump_epoch_locked(slot)
        self.stats.inc("frees")

    @contextlib.contextmanager
    def deferred_fills(self):
        """Batch-commit lease for a fold round's cold fills: while held,
        ``commit`` buffers (slot, data) pairs instead of writing the
        arena per block, and the next ``snapshot_for``/``read_block`` —
        or the lease exit — flushes them as ONE batched ``index_copy_``.
        Slot attachment stays immediate (a pending slot is resident for
        placement purposes); reads always flush first, so no path can
        observe a slot without its data."""
        with self._lock:
            self._deferred += 1
        try:
            yield
        finally:
            with self._lock:
                self._deferred -= 1
                if self._deferred == 0:
                    self._flush_pending_locked()

    def _write_locked(self, slots: List[int], keys: torch.Tensor,
                      values: torch.Tensor) -> None:
        """In-place arena write of ``[n, cap(, W)]`` rows at ``slots``, on
        the pool's stream (caller holds the pool lock)."""
        idx = torch.as_tensor(slots, dtype=torch.int64)
        with self.stream():
            idx = idx.to(self.device, non_blocking=True)
            self.keys.index_copy_(0, idx, keys.to(self.device))
            self.values.index_copy_(0, idx, values.to(self.device))

    def _flush_pending_locked(self) -> None:
        """One batched write for every buffered fill (caller holds the
        pool lock)."""
        if not self._pending:
            return
        slots = list(self._pending)
        self._write_locked(slots,
                           torch.stack([self._pending[s][0] for s in slots]),
                           torch.stack([self._pending[s][1] for s in slots]))
        self.stats.inc("batched_fill_commits")
        self._pending.clear()

    @contextlib.contextmanager
    def pinned(self):
        """Snapshot-stability lease: while any pin is held, released
        slots are quarantined rather than reused, so the slots a
        ``snapshot_for`` returned keep their data until the fold that
        reads them has been launched. Bracket snapshot -> fold-launch
        sections with this."""
        with self._lock:
            self._pins += 1
        try:
            yield
        finally:
            with self._lock:
                self._pins -= 1
                if self._pins == 0 and self._quarantine:
                    for slot in self._quarantine:
                        self._free[self.shard_of_slot(slot)].append(slot)
                    self._quarantine.clear()

    # ------------------------------------------------------------ slot mgmt
    def shard_of_slot(self, slot: int) -> int:
        return slot // self.slots_per_shard

    def alloc(self, shard: Optional[int] = None) -> Optional[int]:
        """Take a free slot from ``shard``'s range (state: free -> filling).

        ``shard=None`` round-robins across shards (unsharded pools have a
        single shard, so this is simply "any slot"). A full shard range
        returns None — no cross-shard stealing; the caller falls back to
        the legacy per-block path.
        """
        with self._lock:
            if shard is None:
                for off in range(self.num_shards):
                    d = (self._rr + off) % self.num_shards
                    if self._free[d]:
                        self._rr = (d + 1) % self.num_shards
                        self.stats.inc("allocs")
                        return self._free[d].popleft()
                self.stats.inc("exhausted")
                return None
            d = shard % self.num_shards
            if not self._free[d]:
                self.stats.inc("exhausted")
                return None
            self.stats.inc("allocs")
            return self._free[d].popleft()

    def free(self, slot: int) -> None:
        """Return an unattached slot (alloc'd but never committed)."""
        with self._lock:
            self._release_locked(slot)

    def release_slot(self, block) -> Optional[int]:
        """Surrender ``block``'s slot back to the free list, exactly once.

        Callers hold ``block.lock`` (destage / drop / aborted stage), so
        concurrent surrenders serialize there; the None-check under the
        pool lock makes a double call harmless anyway. A buffered
        deferred fill for the slot is discarded — the block is leaving
        the device tier, its data must not land after the slot is
        reused.
        """
        with self._lock:
            slot = block.pool_slot
            if slot is None:
                return None
            block.pool_slot = None
            self._release_locked(slot)
            return slot

    def free_slots(self) -> int:
        with self._lock:
            return sum(len(f) for f in self._free)

    # ------------------------------------------------------------- transfers
    def commit(self, block, slot: int,
               host_data: Dict[str, np.ndarray]) -> None:
        """Write ``host_data`` into ``slot`` and attach it to ``block``
        (state: filling -> resident). Atomic vs ``snapshot_for`` so a
        snapshot never sees a slot whose data is not written. Caller
        holds ``block.lock`` and passes the host arrays it validated —
        re-reading ``block.host_data`` here would race a concurrent spill
        that just nulled it."""
        keys = torch.from_numpy(np.ascontiguousarray(host_data["keys"],
                                                     np.int32))
        vals = torch.from_numpy(np.ascontiguousarray(host_data["values"],
                                                     np.float32))
        with self._lock:
            if self._deferred:
                # a fold round's fills batch into one write at the next
                # snapshot/read (see ``deferred_fills``)
                self._pending[slot] = (keys, vals)
                self.stats.inc("deferred_fills")
            else:
                self._write_locked([slot], keys[None], vals[None])
            block.pool_slot = slot
            block.pool = self
            self._bump_epoch_locked(slot)
            self.stats.inc("writes")

    def slot_epochs(self, blocks) -> List[Tuple[Optional[int], int]]:
        """One consistent ``(pool_slot, epoch)`` read per block — no
        pin required. ``snapshot_with_epochs`` re-reads the pairs under a
        pin; any row whose pair moved (destaged, purged, slot recycled)
        must not fold from its stale slot."""
        with self._lock:
            out: List[Tuple[Optional[int], int]] = []
            for b in blocks:
                s = b.pool_slot
                out.append((s, self._slot_epoch[s]) if s is not None
                           else (None, -1))
            return out

    def snapshot_with_epochs(self, blocks) -> Tuple[
            torch.Tensor, torch.Tensor, List[Optional[int]], List[int]]:
        """``snapshot_for`` + the epoch of each block's slot, one atomic
        read. Call inside a ``pinned()`` section."""
        with self._lock:
            self._flush_pending_locked()
            slots = [b.pool_slot for b in blocks]
            epochs = [self._slot_epoch[s] if s is not None else -1
                      for s in slots]
            return self.keys, self.values, slots, epochs

    def snapshot_for(self, blocks) -> Tuple[torch.Tensor, torch.Tensor,
                                            List[Optional[int]]]:
        """(keys_arena, values_arena, slot-per-block) — one consistent
        view. Call inside a ``pinned()`` section and launch the folds that
        read it before the pin ends."""
        with self._lock:
            self._flush_pending_locked()
            return self.keys, self.values, [b.pool_slot for b in blocks]

    def read_block(self, block) -> Optional[Dict[str, torch.Tensor]]:
        """Device copy of one resident block ({keys, values}), or None if
        the block holds no slot. Used by the per-window fold path.

        The copy is enqueued UNDER the pool lock on the pool's stream, so
        a later write to the slot (after a release and reuse) runs after
        it: the returned tensors never change under the caller.
        """
        with self._lock:
            slot = block.pool_slot
            if slot is None:
                return None
            self._flush_pending_locked()
            with self.stream():
                k = self.keys[slot].clone()
                v = self.values[slot].clone()
        return {"keys": k, "values": v}

    def read_host(self, block) -> Optional[Dict[str, np.ndarray]]:
        """Host copy of a resident block's pooled arrays (destage path
        when the host copy was lost)."""
        d = self.read_block(block)
        if d is None:
            return None
        out = {k: v.cpu().numpy() for k, v in d.items()}
        # timestamps are not pooled (no batch fold is time-dependent);
        # a defensively-rebuilt host copy carries zeros so the SoA schema
        # stays uniform for checkpoints
        out["timestamps"] = np.zeros((self.capacity,), np.float64)
        return out
