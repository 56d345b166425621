"""Legacy file-per-block ``.npz`` backend, behind the BlockStore
interface.

This is the seed repo's original persistent tier — one uncompressed
``block_<id>.npz`` per spilled block, deleted eagerly on purge — kept as
the fallback implementation and the ablation baseline the log-structured
store is measured against (write batching, batched reads, compaction).
Refs returned by ``put`` are the real file paths so legacy code (and
tests) that look at ``Block.storage_path`` keep working.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.storage.blockstore import (
    BlockKey, BlockStore, FIELDS, WindowKey, normalize_window_key,
    payload_nbytes,
)


class NpzBlockStore(BlockStore):
    """File-per-block store: every record is its own ``.npz``."""

    name = "npz"
    durable_writes = False      # legacy late writes only flip `persisted`

    def __init__(self, directory: Path, sim_spb: float = 0.0,
                 registry=None):
        super().__init__(sim_spb=sim_spb, registry=registry)
        self.directory = Path(directory)
        # engine main thread (purge tombstones) and the I/O executor
        # (spill/stage) both call in
        self._lock = threading.RLock()
        # (window_key, block_id) -> (path, fill, payload_bytes, disk_bytes)
        self._index: Dict[BlockKey, Tuple[Path, int, int, int]] = {}
        if self.directory.exists():
            self._scan_existing()

    def _scan_existing(self) -> None:
        """Adopt pre-existing block files (reopen after restart). The
        window key and fill are not recoverable from the legacy layout;
        records index under the pseudo-window at full capacity — a
        conservative fill that only ever forces a harmless rewrite on
        the next spill (see ``_key_of`` for the lookup fallback)."""
        for p in sorted(self.directory.glob("block_*.npz")):
            try:
                bid = int(p.stem.split("_", 1)[1])
                with np.load(p) as z:
                    fill = int(z["keys"].shape[0])
                    width = int(z["values"].shape[1])
            except Exception:
                continue
            self._index[(normalize_window_key(None), bid)] = (
                p, fill, payload_nbytes(fill, width), p.stat().st_size)

    def _key_of(self, window_key: Optional[WindowKey],
                block_id: int) -> Optional[BlockKey]:
        """Resolve a key, tolerating the pseudo-window of adopted files
        (the npz layout is keyed by block_id alone on disk)."""
        wk = normalize_window_key(window_key)
        if (wk, block_id) in self._index:
            return (wk, block_id)
        alt = (normalize_window_key(None), block_id)
        if alt in self._index:
            return alt
        return None

    # ------------------------------------------------------------- writes
    def put(self, window_key, block_id, arrays, fill):
        with self._lock:
            self.directory.mkdir(parents=True, exist_ok=True)
            path = self.directory / f"block_{block_id}.npz"
            # full-capacity arrays, verbatim — byte-identical to the
            # seed's ``spill_to_storage`` so reload parity is trivial
            np.savez(path, **{k: arrays[k] for k in FIELDS})
            wk = normalize_window_key(window_key)
            disk = path.stat().st_size
            width = int(arrays["values"].shape[1])
            self._index[(wk, block_id)] = (
                path, int(fill), payload_nbytes(int(fill), width), disk)
            self.stats["puts"] += 1
            self.stats["bytes_written"] += disk
            self.stats["logical_bytes_written"] += payload_nbytes(
                int(fill), width)
            return path

    def commit(self) -> None:
        # each savez is already its own file; nothing buffered
        self.stats["commits"] += 1

    def delete(self, window_key, block_id) -> None:
        with self._lock:
            key = self._key_of(window_key, block_id)
            if key is None:
                return
            path, _, _, _ = self._index.pop(key)
            if path.exists():
                os.unlink(path)
            self.stats["deletes"] += 1

    # -------------------------------------------------------------- reads
    def get(self, window_key, block_id):
        with self._lock:
            key = self._key_of(window_key, block_id)
            if key is None:
                return None
            path, _, _, disk = self._index[key]
            if not path.exists():
                return None
            with np.load(path) as z:
                out = {k: z[k] for k in FIELDS}
            self.stats["gets"] += 1
            self.stats["bytes_read"] += disk
            return out

    def get_many(self, keys: List[BlockKey]):
        self.stats["batched_reads"] += 1
        return [self.get(wk, bid) for wk, bid in keys]

    # ---------------------------------------------------------- inventory
    def current_fill(self, window_key, block_id):
        with self._lock:
            key = self._key_of(window_key, block_id)
            if key is None:
                return None
            return self._index[key][1]

    def locate(self, window_key, block_id):
        with self._lock:
            key = self._key_of(window_key, block_id)
            return None if key is None else self._index[key][0]

    def keys(self) -> List[BlockKey]:
        with self._lock:
            return list(self._index)

    def live_bytes(self) -> int:
        with self._lock:
            return sum(pb for _, _, pb, _ in self._index.values())

    def on_disk_bytes(self) -> int:
        with self._lock:
            return sum(d for _, _, _, d in self._index.values())
