"""Two-tier bucket state (paper §3.1): m-bucket in device memory (HBM
analogue), p-bucket in host memory with spill to a persistent block
store.

TPU adaptation: Flink's per-record ListState becomes *block-granular*
state — events append into fixed-capacity SoA blocks; a window's state is
an ordered list of blocks, each resident in exactly one tier:

    DEVICE  (m-bucket)  — torch tensors on the card, counted against an HBM budget
    HOST    (p-bucket)  — pinned numpy arrays
    STORAGE (p-bucket)  — a ``repro.storage`` BlockStore record
                          (log-structured value log, or the legacy
                          file-per-block .npz fallback)

Blocks move between tiers only through ``core.staging`` (the single
prioritized I/O executor), never synchronously inside operator execution —
that asynchrony is what lets proactive caching mask transfer latency.
"""
from __future__ import annotations

import enum
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.events import EventBatch


class Tier(enum.Enum):
    DEVICE = "device"
    HOST = "host"
    STORAGE = "storage"


class _BlockIdGen:
    """Monotonic block-id source. ``bump_to`` lets a checkpoint restore
    re-use the checkpointed ids (the store keys records by them) without
    colliding with ids handed to blocks created afterwards."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def __next__(self) -> int:
        with self._lock:
            self._n += 1
            return self._n

    def bump_to(self, n: int) -> None:
        with self._lock:
            self._n = max(self._n, int(n))


_BLOCK_IDS = _BlockIdGen()


@dataclass
class Block:
    """Fixed-capacity SoA block. Exactly one of (host_data, device_data,
    storage_path) is the authoritative copy, per ``tier``.

    ``lock``/``dropped`` serialize the ownership handoff between the
    engine's predictive cleanup (main thread) and the staging executor
    (I/O thread): a stage that commits after the block was dropped must
    release its own budget reservation, and a drop that races a
    committed stage must report the device bytes so the engine releases
    them — otherwise reservations leak.

    With the persistent block pool (``AionConfig.block_pool``), a
    device-resident block holds a ``pool_slot`` into the arena instead of
    per-block ``device_data`` buffers; ``pool`` is the back-reference
    through which destage/drop surrender the slot (exactly once — the
    surrender happens under ``lock`` via ``pool.release_slot``).
    """
    capacity: int
    width: int
    block_id: int = field(default_factory=lambda: next(_BLOCK_IDS))
    fill: int = 0
    tier: Tier = Tier.HOST
    persisted: bool = False      # has touched the persistent tier (p-bucket)
    dropped: bool = False        # predictive cleanup freed this block
    host_data: Optional[Dict[str, np.ndarray]] = None
    device_data: Optional[Dict[str, object]] = None
    # legacy direct-file path (the npz backend mirrors its ref here so
    # file-per-block code and tests keep working)
    storage_path: Optional[Path] = None
    # persistent store holding this block's record, and the opaque ref
    # its ``put`` returned; the store indexes by (window_key, block_id)
    store: Optional[object] = field(default=None, repr=False, compare=False)
    storage_ref: Optional[object] = None
    window_key: Optional[Tuple[float, float]] = None
    pool_slot: Optional[int] = None    # arena slot while device-resident
    pool: Optional[object] = field(default=None, repr=False, compare=False)
    # host copy counted against IOScheduler's host tier (idempotent
    # accounting: staging keeps host copies, so destage/stage round-trips
    # must not re-count the same bytes)
    host_accounted: bool = False
    # membership flag for IOScheduler._host_lru: set when this block is
    # appended as a spill candidate, cleared when the spill loop pops it
    # — the failure unwind re-queues a block exactly once even when two
    # coalesced flushes over overlapping batches both fail
    in_spill_lru: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    @staticmethod
    def new(capacity: int, width: int) -> "Block":
        b = Block(capacity=capacity, width=width)
        b.host_data = {
            "keys": np.zeros((capacity,), np.int32),
            "timestamps": np.zeros((capacity,), np.float64),
            "values": np.zeros((capacity, width), np.float32),
        }
        return b

    @property
    def nbytes(self) -> int:
        per_event = 4 + 8 + 4 * self.width
        return self.capacity * per_event

    @property
    def full(self) -> bool:
        return self.fill >= self.capacity

    def append(self, batch: EventBatch, start: int) -> int:
        """Copy events from batch[start:] into free space; returns #taken.
        Only valid on HOST tier (ingest path writes host-side)."""
        assert self.tier == Tier.HOST and self.host_data is not None
        take = min(self.capacity - self.fill, len(batch) - start)
        if take <= 0:
            return 0
        sl = slice(self.fill, self.fill + take)
        self.host_data["keys"][sl] = batch.keys[start:start + take]
        self.host_data["timestamps"][sl] = batch.timestamps[start:start + take]
        self.host_data["values"][sl] = batch.values[start:start + take]
        self.fill += take
        return take

    def as_event_batch(self) -> EventBatch:
        """Host view of valid events (host or storage tier)."""
        if self.tier == Tier.STORAGE:
            self._load_from_storage()
        assert self.host_data is not None
        return EventBatch(self.host_data["keys"][:self.fill],
                          self.host_data["timestamps"][:self.fill],
                          self.host_data["values"][:self.fill])

    @property
    def in_storage(self) -> bool:
        """True when a persistent copy exists (store record or legacy
        direct file)."""
        return (self.store is not None and self.storage_ref is not None) \
            or self.storage_path is not None

    def _load_from_storage(self) -> None:
        if self.store is not None and self.storage_ref is not None:
            data = self.store.get(self.window_key, self.block_id)
            assert data is not None, \
                f"store record missing for block {self.block_id}"
            self.host_data = data
        else:
            assert self.storage_path is not None
            with np.load(self.storage_path) as z:
                self.host_data = {
                    k: z[k] for k in ("keys", "timestamps", "values")}
        self.tier = Tier.HOST

    def put_to_store(self, store) -> None:
        """Write this block's current content into ``store`` (skipping
        the write when the store already holds this exact fill — block
        content is append-only, so fill identifies it). Durable after the
        store's next group commit; the caller clears the host copy only
        after that commit. Caller holds ``lock``."""
        assert self.host_data is not None
        if not (self.store is store
                and store.current_fill(self.window_key,
                                       self.block_id) == self.fill):
            ref = store.put(self.window_key, self.block_id,
                            self.host_data, self.fill)
            self.store = store
            self.storage_ref = ref
            self.storage_path = ref if isinstance(ref, Path) else None

    def drop(self) -> int:
        """Free all copies (predictive cleanup). Returns the device bytes
        that were committed to the budget at drop time — the caller owns
        releasing them (an in-flight stage that commits later sees
        ``dropped`` and releases its own reservation instead)."""
        with self.lock:
            self.dropped = True
            # pooled blocks never held a per-block reservation (the
            # arena's bytes are charged once, at pool construction), so
            # only a legacy per-block device copy reports bytes to release
            device_bytes = self.nbytes if (
                self.tier == Tier.DEVICE and self.pool_slot is None) else 0
            self.host_data = None
            self.device_data = None
            if self.pool is not None:
                # surrender the arena slot exactly once (an in-flight
                # stage that commits after this sees ``dropped`` and
                # frees the slot it allocated instead)
                self.pool.release_slot(self)
            if self.store is not None and self.storage_ref is not None:
                # predictive cleanup's purge emits a TOMBSTONE; space
                # comes back through cleanup-driven compaction (the npz
                # backend's delete unlinks eagerly, preserving the
                # legacy behaviour)
                self.store.delete(self.window_key, self.block_id)
            elif self.storage_path is not None \
                    and self.storage_path.exists():
                os.unlink(self.storage_path)
            self.storage_ref = None
            self.storage_path = None
            return device_bytes


class MemoryBudget:
    """Byte accounting for the device (m-bucket) tier."""

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self.used_bytes = 0
        self._lock = threading.Lock()
        self.peak_bytes = 0

    def try_reserve(self, n: int) -> bool:
        with self._lock:
            if self.used_bytes + n > self.capacity_bytes:
                return False
            self.used_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.used_bytes)
            return True

    def release(self, n: int) -> None:
        with self._lock:
            self.used_bytes = max(self.used_bytes - n, 0)

    @property
    def utilization(self) -> float:
        return self.used_bytes / max(self.capacity_bytes, 1)


class TenantBudget(MemoryBudget):
    """A tenant's slice of a shared device budget.

    Reservations must clear BOTH limits: the tenant's own cap (fairness
    — one tenant cannot crowd the others out of the device) and the
    shared parent budget (physics — the device only has so many bytes).
    ``used_bytes``/``utilization`` report the tenant's own usage, which
    is what per-tenant memory policies (GlobalMemoryPolicy thresholds)
    should react to."""

    def __init__(self, parent: MemoryBudget, capacity_bytes: int):
        super().__init__(capacity_bytes)
        self.parent = parent

    def try_reserve(self, n: int) -> bool:
        if not super().try_reserve(n):
            return False
        if not self.parent.try_reserve(n):
            super().release(n)
            return False
        return True

    def release(self, n: int) -> None:
        # release no more from the parent than this tenant actually
        # holds (MemoryBudget.release floors at 0 locally; the parent
        # must see the same clamped amount or shared bytes would leak
        # back twice)
        with self._lock:
            freed = min(self.used_bytes, max(int(n), 0))
            self.used_bytes -= freed
        if freed:
            self.parent.release(freed)


@dataclass
class WindowState:
    """State of one window: ordered blocks split across tiers (Figure 1).

    ``m_blocks``/``p_blocks`` partition ``blocks`` by tier; order inside
    ``blocks`` is append order (event order within a block is arrival
    order, which event-time operators re-sort as needed)."""
    window_start: float
    window_end: float
    width: int
    block_capacity: int
    blocks: List[Block] = field(default_factory=list)
    total_events: int = 0
    late_events: int = 0
    expired: bool = False          # watermark passed window end
    rho_min_blocks: int = 0        # bootstrap set size (policy §3.2)
    last_executed_at: float = -np.inf
    events_at_last_exec: int = 0
    result: Optional[object] = None

    def m_blocks(self) -> List[Block]:
        return [b for b in self.blocks if b.tier == Tier.DEVICE]

    def p_blocks(self) -> List[Block]:
        return [b for b in self.blocks if b.tier != Tier.DEVICE]

    def device_bytes(self) -> int:
        return sum(b.nbytes for b in self.m_blocks())

    def host_bytes(self) -> int:
        return sum(b.nbytes for b in self.blocks if b.tier == Tier.HOST)

    def append_events(self, batch: EventBatch, late: bool) -> List[Block]:
        """Append host-side; returns blocks newly created. Tier placement
        (device vs host) is decided by the policy/staging layer."""
        new_blocks: List[Block] = []
        start = 0
        # fill the last block if it has room and is host-resident — under
        # its lock: the I/O thread's spill, stage and destage decide the
        # block's residency under it, so they see the append whole or not
        # at all (an append between a spill's write and its drop of the
        # host copy would otherwise be lost)
        if self.blocks:
            last = self.blocks[-1]
            with last.lock:
                if not last.full and last.tier == Tier.HOST:
                    start += last.append(batch, start)
        while start < len(batch):
            blk = Block.new(self.block_capacity, self.width)
            blk.window_key = (self.window_start, self.window_end)
            taken = blk.append(batch, start)
            start += taken
            self.blocks.append(blk)
            new_blocks.append(blk)
        self.total_events += len(batch)
        if late:
            self.late_events += len(batch)
        return new_blocks

    def events_since_last_exec(self) -> int:
        return self.total_events - self.events_at_last_exec

    def drop_all(self) -> Tuple[int, int]:
        """Predictive cleanup: free every copy. Returns (total bytes
        freed, device bytes the caller must release from the budget)."""
        freed = sum(b.nbytes for b in self.blocks)
        device_bytes = sum(b.drop() for b in self.blocks)
        self.blocks.clear()
        return freed, device_bytes
