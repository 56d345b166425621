"""The persistent tier of the p-bucket, as an interface.

Aion's p-bucket lives in a real persistent store (RocksDB under Flink);
this module defines the contract every backend implements so the engine,
the staging executor, proactive caching and predictive cleanup all talk
to *storage*, never to files:

* ``put`` / ``commit`` — writes are **group-committed**: ``put`` makes a
  record visible to this process, ``commit`` is the durability barrier
  (a crash after ``commit`` returns loses nothing acknowledged; a crash
  before it may lose the uncommitted tail, whose blocks still hold their
  host copies).
* ``get`` / ``get_many`` / ``readahead`` — reads are block-granular;
  ``get_many`` is the batched multi-block path (one sequential sweep per
  segment on the log backend) and ``readahead`` fills a bounded read
  cache ahead of demand so proactive pre-staging turns cold storage
  reads into cache hits — a first-class, measurable interface
  (``stats['readahead_hits']`` / ``'readahead_misses'``).
* ``delete`` — predictive cleanup's purge emits a *tombstone*; space
  comes back through ``compact_if_needed`` (cleanup-driven compaction),
  not through an eager unlink.
* ``charge`` — the deterministic simulated-cost model for benchmarks
  (one persistent-tier channel: threads queue on the sleep) lives behind
  the store, so ablations price every backend identically and
  **zero-byte transfers are never charged**.

``BlockKey`` is ``(window_key, block_id)`` with ``window_key =
(window_start, window_end)`` — the index the paper's p-bucket keeps.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

WindowKey = Tuple[float, float]
BlockKey = Tuple[WindowKey, int]

# SoA field order every backend serializes in
FIELDS = ("keys", "timestamps", "values")
_DTYPES = {"keys": np.int32, "timestamps": np.float64, "values": np.float32}


def normalize_window_key(window_key: Optional[WindowKey]) -> WindowKey:
    """Blocks created outside a window (unit tests, scratch) map to the
    (0, 0) pseudo-window; ``block_id`` keeps the key unique."""
    if window_key is None:
        return (0.0, 0.0)
    return (float(window_key[0]), float(window_key[1]))


def payload_nbytes(fill: int, width: int) -> int:
    """Logical bytes of one record's event payload (the fill-sliced SoA
    arrays: int32 keys + float64 timestamps + float32 values)."""
    return fill * (4 + 8 + 4 * width)


class TransientStoreError(OSError):
    """A store operation failed in a way a retry is expected to fix
    (flaky device, interrupted syscall, overloaded tier). The staging
    layer retries these up to ``AionConfig.io_retry_limit`` with
    exponential backoff before surfacing them."""


class PermanentStoreError(RuntimeError):
    """A store operation failed in a way retries cannot fix (corrupt
    record, failed media, contract violation). Surfaced immediately —
    recovery means restoring from a checkpoint, not retrying."""


def is_transient_error(exc: BaseException) -> bool:
    """Transient vs. permanent classification for the retry budget.

    OS-level I/O errors (``OSError`` and subclasses — the log backend's
    real failure mode), timeouts and connection drops are transient;
    ``PermanentStoreError`` and everything else (``KeyError``,
    ``AssertionError``, ...) are logic/corruption failures that retries
    would only repeat."""
    if isinstance(exc, PermanentStoreError):
        return False
    return isinstance(exc, (OSError, TimeoutError, ConnectionError))


class SimulatedCost:
    """Deterministic persistent-tier cost model (paper Q3 ablations).

    The calling thread really sleeps ``nbytes * seconds_per_byte`` while
    holding the single-channel lock, so scheduling — priorities,
    preemption, pre-staging lead time — decides who stalls, not host
    noise. Zero-byte transfers are free by contract (empty blocks must
    not be billed for I/O that never happens).
    """

    def __init__(self, seconds_per_byte: float = 0.0):
        self.seconds_per_byte = seconds_per_byte
        self._lock = threading.Lock()
        self.total_seconds = 0.0

    def charge(self, nbytes: int) -> float:
        if self.seconds_per_byte <= 0 or nbytes <= 0:
            return 0.0
        dt = nbytes * self.seconds_per_byte
        self.total_seconds += dt
        with self._lock:               # single channel: threads queue
            time.sleep(dt)
        return dt


class BlockStore:
    """Abstract persistent block store. Thread-safe by contract: the
    engine main thread and the I/O executor both call in."""

    name = "abstract"
    #: True when ``put``+``commit`` give real crash durability — the
    #: staging layer persists late-event writes through such stores
    #: (the legacy npz backend only flips the ``persisted`` flag).
    durable_writes = False

    def __init__(self, sim_spb: float = 0.0, registry=None):
        from repro_torch.obs import MetricsRegistry, StatsMap
        self.simcost = SimulatedCost(sim_spb)
        # registry-backed counters behind the legacy dict API; backends
        # extend the set via ``self.stats.update({...})`` (auto-registers)
        if registry is None:
            registry = MetricsRegistry()
        self.registry = registry
        self.stats = StatsMap(registry, f"aion_store_{self.name}")
        self.stats.register_many([
            "puts", "gets", "deletes", "commits",
            "bytes_written", "bytes_read", "bytes_compacted",
            "logical_bytes_written", "batched_reads",
            "readahead_hits", "readahead_misses",
            "readahead_bytes", "compactions",
        ])

    # ------------------------------------------------------------- writes
    def put(self, window_key: Optional[WindowKey], block_id: int,
            arrays: Dict[str, np.ndarray], fill: int):
        """Write one block's SoA arrays (full-capacity; only ``[:fill]``
        is meaningful). Returns an opaque ref. Durable after the next
        ``commit``."""
        raise NotImplementedError

    def commit(self) -> None:
        """Group-commit barrier: every prior ``put``/``delete`` of this
        process is durable when this returns."""
        raise NotImplementedError

    def delete(self, window_key: Optional[WindowKey],
               block_id: int) -> None:
        """Tombstone one block (predictive cleanup's purge). Space is
        reclaimed by compaction, not by this call."""
        raise NotImplementedError

    # -------------------------------------------------------------- reads
    def get(self, window_key: Optional[WindowKey], block_id: int
            ) -> Optional[Dict[str, np.ndarray]]:
        """Full-capacity SoA arrays of one block, or None if absent.
        The caller owns the returned arrays (they may be mutated by
        tail-block appends after a reload)."""
        raise NotImplementedError

    def get_many(self, keys: List[BlockKey]
                 ) -> List[Optional[Dict[str, np.ndarray]]]:
        """Batched multi-block read, results in input order. Backends
        override to turn random block access into sequential sweeps."""
        return [self.get(wk, bid) for wk, bid in keys]

    def readahead(self, keys: Iterable[BlockKey]) -> None:
        """Prefetch hint: bring these blocks toward memory (into the
        read cache) ahead of demand. Best-effort; default no-op."""

    # ------------------------------------------- segment-granular prefetch
    # (learned prefetch planner; only log-structured backends have a
    # physical segment layout — the defaults make everything else report
    # "no segments" so planners fall back to point readahead)
    def segments_for(self, keys: Iterable[BlockKey]
                     ) -> Dict[int, List[Tuple[BlockKey, int, int]]]:
        """Physical placement of live records: ``segment_id -> [(key,
        offset, record_len)]``. Index-only — no payload reads."""
        return {}

    def readahead_segments(self, sid: int,
                           keys: Iterable[BlockKey]) -> int:
        """One sequential sweep over segment ``sid`` caching ``keys``'s
        records. Returns blocks cached (0: backend has no segments)."""
        return 0

    def window_scatter(self, window_key: Optional[WindowKey]
                       ) -> Tuple[int, int, int, int]:
        """Physical scatter of a window's live records: ``(records,
        segments, span_bytes, record_bytes)`` — the coalescing
        planner's rewrite-worthiness signal."""
        return (0, 0, 0, 0)

    def coalesce_windows(self, window_keys: Iterable[WindowKey]) -> int:
        """Rewrite each window's scattered live records into one
        contiguous run at the log tail. Returns windows rewritten."""
        return 0

    # ---------------------------------------------------------- inventory
    def contains(self, window_key: Optional[WindowKey],
                 block_id: int) -> bool:
        return self.current_fill(window_key, block_id) is not None

    def current_fill(self, window_key: Optional[WindowKey],
                     block_id: int) -> Optional[int]:
        """Fill of the stored record for this key, or None if absent —
        lets spill skip rewriting a block whose exact content is already
        persistent, and checkpoint manifests verify store coverage."""
        raise NotImplementedError

    def locate(self, window_key: Optional[WindowKey], block_id: int):
        """Opaque ref for an existing record (restore re-links blocks to
        their pre-crash records), or None."""
        fill = self.current_fill(window_key, block_id)
        return None if fill is None else True

    def keys(self) -> List[BlockKey]:
        raise NotImplementedError

    def live_bytes(self) -> int:
        """Logical payload bytes of live (non-tombstoned) records."""
        raise NotImplementedError

    def on_disk_bytes(self) -> int:
        raise NotImplementedError

    # ------------------------------------------------- space reclamation
    def compact_if_needed(self, max_ratio: float = 2.0) -> int:
        """Reclaim dead space until on-disk bytes <= max(``max_ratio`` x
        live bytes, one segment). Returns bytes compacted away."""
        return 0

    def reconcile(self, live_keys: Iterable[BlockKey]) -> int:
        """Tombstone every record not in ``live_keys`` (orphans left by a
        crash between a checkpoint and the purge tombstones that should
        have followed it). Returns the number of orphans dropped."""
        live = set(live_keys)
        dropped = 0
        for wk, bid in self.keys():
            if (wk, bid) not in live:
                self.delete(wk, bid)
                dropped += 1
        if dropped:
            self.commit()
        return dropped

    # ------------------------------------------------------------- costs
    def charge(self, nbytes: int) -> float:
        """Simulated persistent-tier cost for an ``nbytes`` transfer.
        Empty transfers are free (see ``SimulatedCost``)."""
        return self.simcost.charge(nbytes)

    @property
    def write_amplification(self) -> float:
        """Physical bytes written (incl. compaction rewrites) per logical
        payload byte the engine asked to persist."""
        logical = self.stats["logical_bytes_written"]
        if logical <= 0:
            return 0.0
        return self.stats["bytes_written"] / logical

    # ---------------------------------------------------------- lifecycle
    def flush(self) -> None:
        self.commit()

    def close(self) -> None:
        self.flush()
