"""Events: keyed, event-timestamped records in SoA layout.

The engine works on *batches* of events (structure-of-arrays), the
accelerator-native analogue of Flink's per-record streams: dense arrays
batch into fixed-size blocks (``core.buckets``) that tile cleanly into
VMEM and transfer in large contiguous DMAs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class EventBatch:
    """keys: [n] int32; timestamps: [n] float64 (event-time seconds);
    values: [n, width] float32."""
    keys: np.ndarray
    timestamps: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        self.keys = np.asarray(self.keys, dtype=np.int32)
        self.timestamps = np.asarray(self.timestamps, dtype=np.float64)
        self.values = np.asarray(self.values, dtype=np.float32)
        if self.values.ndim == 1:
            self.values = self.values[:, None]
        n = len(self.keys)
        assert len(self.timestamps) == n and len(self.values) == n

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def nbytes(self) -> int:
        return self.keys.nbytes + self.timestamps.nbytes + self.values.nbytes

    def select(self, mask: np.ndarray) -> "EventBatch":
        return EventBatch(self.keys[mask], self.timestamps[mask],
                          self.values[mask])

    def slice(self, start: int, stop: int) -> "EventBatch":
        return EventBatch(self.keys[start:stop], self.timestamps[start:stop],
                          self.values[start:stop])

    @staticmethod
    def empty(width: int) -> "EventBatch":
        return EventBatch(np.zeros((0,), np.int32), np.zeros((0,), np.float64),
                          np.zeros((0, width), np.float32))

    @staticmethod
    def concat(batches: list) -> "EventBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            raise ValueError("concat of empty list")
        return EventBatch(
            np.concatenate([b.keys for b in batches]),
            np.concatenate([b.timestamps for b in batches]),
            np.concatenate([b.values for b in batches]),
        )

    def partition_by_shard(self, num_shards: int) -> list:
        """Key-hash partitioning (Flink keyBy analogue) for distributed
        ingest: shard = hash(key) % num_shards."""
        shard = (self.keys.astype(np.uint32) * np.uint32(2654435761)
                 >> np.uint32(16)) % np.uint32(num_shards)
        return [self.select(shard == s) for s in range(num_shards)]
