"""The slot mesh of Aion's slot-sharded fold (``AionConfig.slot_sharding``).

Window slots partition across a 1-D mesh of devices with NO cross-device
reduction: slots are disjoint, so each device owns a contiguous slot
range outright, and a fold's output is the concatenation of the
per-device tiles along the slot axis. The JAX package runs this as a
``shard_map`` over the local devices of one process; the port runs it in
one process as well: a mesh is a tuple of ``torch.device``, each shard's
kernel launches on its own entry, and the tiles are concatenated on the
first. No collective is involved, so there is no process group.

An entry may repeat a device: ``SlotMesh((cpu,) * 4)`` shards four ways
on one CPU, and ``(cuda:0,) * 4`` on one card. That checks the sharded
placement, masking and per-shard launches where only one device exists
(the counterpart of XLA's forced host device count); it says nothing of
scaling across devices.

The LM half of the JAX module (logical-axis rules, ``ShardingProfile``,
``constrain``, ``pad_vocab``) is not here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

# Default mesh axis for the streaming engine's slot-sharded batched fold.
SLOT_AXIS = "slots"


def shard_of_window(start: float, end: float, num_shards: int) -> int:
    """Stable window -> shard assignment for the pooled sharded fold.

    The block pool places a window's blocks in per-device slot ranges at
    STAGING time — before any batch composition is known — so placement
    must be a pure function of the window identity, not of the batch.
    Both the staging shard hint and the batch executor's pooled placement
    call this, which is what keeps a window's block-table rows local to
    the shard that owns its arena range. Python's float hash is
    process-stable (PYTHONHASHSEED only perturbs str/bytes), and the JAX
    package computes the same one, so a window lands on the same shard in
    both.
    """
    if num_shards <= 1:
        return 0
    return int(abs(hash((float(start), float(end))))) % num_shards


@dataclass(frozen=True)
class SlotMesh:
    """A 1-D mesh: shard ``d`` runs on ``devices[d]``. Hashable."""
    devices: Tuple[torch.device, ...]
    axis_name: str = SLOT_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def _local_devices() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the index its tensors report (``cuda:<current>``), so
    that a tile's device compares equal to its mesh entry."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_slot_mesh(num_devices: int = 0, axis_name: str = SLOT_AXIS,
                   devices: Optional[Sequence] = None
                   ) -> Optional[SlotMesh]:
    """1-D mesh for slot-sharded window execution.

    ``devices=None`` takes the local devices: ``cuda:0`` .. ``cuda:n-1``,
    or the single CPU where CUDA is missing. An explicit ``devices`` list
    may name a device more than once. ``num_devices == 0`` takes every
    entry, else the first ``num_devices``. Returns ``None`` below two
    entries — callers fall back to the single-device batched path, which
    keeps ``slot_sharding=True`` a safe no-op on one device.
    """
    devs = _local_devices() if devices is None else \
        [_indexed(torch.device(d)) for d in devices]
    n = num_devices if num_devices > 0 else len(devs)
    n = min(n, len(devs))
    if n <= 1:
        return None
    return SlotMesh(tuple(devs[:n]), axis_name)
