"""Persistent p-bucket storage: the BlockStore interface, the
log-structured backend (segmented value log + WAL recovery +
cleanup-driven compaction), and the legacy file-per-block npz fallback.
"""
from repro_torch.storage.blockstore import (
    BlockKey, BlockStore, PermanentStoreError, SimulatedCost,
    TransientStoreError, WindowKey, is_transient_error,
    normalize_window_key, payload_nbytes,
)
from repro_torch.storage.logstore import LogBlockStore
from repro_torch.storage.npzstore import NpzBlockStore


def make_store(backend: str, directory, *, segment_bytes: int = 1 << 20,
               sim_spb: float = 0.0,
               readahead_bytes: int = 16 << 20,
               registry=None) -> BlockStore:
    """Build a store by config name (``AionConfig.store_backend``)."""
    if backend == "log":
        return LogBlockStore(directory, segment_bytes=segment_bytes,
                             sim_spb=sim_spb,
                             readahead_bytes=readahead_bytes,
                             registry=registry)
    if backend == "npz":
        return NpzBlockStore(directory, sim_spb=sim_spb, registry=registry)
    raise ValueError(f"unknown store backend: {backend!r}")


__all__ = [
    "BlockKey", "BlockStore", "LogBlockStore", "NpzBlockStore",
    "PermanentStoreError", "SimulatedCost", "TransientStoreError",
    "WindowKey", "is_transient_error", "make_store",
    "normalize_window_key", "payload_nbytes",
]
