"""Public kernel entry points with backend dispatch.

``backend``:
  'auto'  the CUDA kernel for a tensor on the card, its plain torch
          version for a tensor on the CPU (the wrapper decides by the
          tensor's device; on the card it launches the kernel or raises)
  'ref'   the plain-torch oracle (``kernels/ref.py``)

Inputs may be tensors or array-likes. Array-likes go to ``device``, which
defaults to the card. The empty-batch guards return the fold identity
without a launch. ``mesh`` (the JAX package's slot-sharded variants) is
not ported and raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.segment_aggregate import (
    ALL_STATS, empty_batch_identity as _empty_batch_identity,
    norm_stats as _norm_stats, segment_aggregate_batched_cuda,
    segment_aggregate_block_table_cuda,
    segment_aggregate_block_table_splitk_cuda, segment_aggregate_cuda,
)

BACKENDS = ("auto", "ref")


def _device_of(x, device) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _opt(x, dev, dtype):
    return None if x is None else as_tensor(x, dev, dtype)


def _check(backend: str, mesh) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (of {BACKENDS})")
    if mesh is not None:
        raise NotImplementedError(
            "the slot-sharded (mesh) folds are not ported to repro_torch")


def _select(out: dict, stats) -> dict:
    return {k: v for k, v in out.items() if k in stats}


def segment_aggregate(values, segment_ids, num_segments: int, valid=None,
                      backend: str = "auto",
                      stats: tuple = ALL_STATS, device=None):
    """values [N, W], segment_ids [N] -> per-segment stats (K1)."""
    _check(backend, None)
    stats = _norm_stats(stats)
    dev = _device_of(values, device)
    values = as_tensor(values, dev, torch.float32)
    segment_ids = as_tensor(segment_ids, dev, torch.int32)
    valid = _opt(valid, dev, torch.bool)
    if backend == "ref":
        return _select(_ref.ref_segment_aggregate(
            values, segment_ids, num_segments, valid), stats)
    return segment_aggregate_cuda(values, segment_ids, num_segments,
                                  valid=valid, stats=stats)


def segment_aggregate_batched(values, segment_ids, num_segments: int,
                              valid=None, slot_ids=None,
                              num_slots: Optional[int] = None,
                              backend: str = "auto",
                              stats: tuple = ALL_STATS, mesh=None,
                              device=None):
    """Batched multi-window reduce-by-key: values [B, N, W], ids [B, N],
    slot_ids [B] -> aggregates [num_slots, num_segments, ...] in one K1
    launch through composite ids."""
    _check(backend, mesh)
    stats = _norm_stats(stats)
    dev = _device_of(values, device)
    values = as_tensor(values, dev, torch.float32)
    b = values.shape[0]
    ns = num_slots if num_slots is not None else \
        (b if slot_ids is None else None)
    if ns is None:
        raise ValueError("num_slots is required when slot_ids is given")
    if b == 0 or ns == 0:
        return _select(_empty_batch_identity(ns, num_segments,
                                             values.shape[2], dev), stats)
    segment_ids = as_tensor(segment_ids, dev, torch.int32)
    valid = _opt(valid, dev, torch.bool)
    slot_ids = _opt(slot_ids, dev, torch.int32)
    if backend == "ref":
        return _select(_ref.ref_segment_aggregate_batched(
            values, segment_ids, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots), stats)
    return segment_aggregate_batched_cuda(
        values, segment_ids, num_segments, valid=valid, slot_ids=slot_ids,
        num_slots=num_slots, stats=stats)


def _table_args(values_arena, segment_ids, table, valid, slot_ids, device):
    dev = _device_of(values_arena, device)
    return (dev, as_tensor(values_arena, dev, torch.float32),
            as_tensor(segment_ids, dev, torch.int32),
            as_tensor(table, dev, torch.int32),
            _opt(valid, dev, torch.bool), _opt(slot_ids, dev, torch.int32))


def segment_aggregate_block_table(values_arena, segment_ids, table,
                                  num_segments: int, valid=None,
                                  slot_ids=None,
                                  num_slots: Optional[int] = None,
                                  backend: str = "auto",
                                  stats: tuple = ALL_STATS, mesh=None,
                                  num_cols: Optional[int] = None,
                                  device=None):
    """Batched reduce-by-key over the persistent block pool (K2):
    values_arena [pool_slots, cap, W], table [R] pool slots, segment_ids
    [R, cap], slot_ids [R] -> [num_slots, num_segments, ...]. Rows are
    read out of the arena inside the kernel; ``num_cols`` keeps the
    leading value columns."""
    _check(backend, mesh)
    stats = _norm_stats(stats)
    dev, values_arena, segment_ids, table, valid, slot_ids = _table_args(
        values_arena, segment_ids, table, valid, slot_ids, device)
    r = table.shape[0]
    ns = num_slots if num_slots is not None else \
        (r if slot_ids is None else None)
    if ns is None:
        raise ValueError("num_slots is required when slot_ids is given")
    if r == 0 or ns == 0:
        w_out = num_cols if num_cols is not None else values_arena.shape[2]
        return _select(_empty_batch_identity(ns, num_segments, w_out, dev),
                       stats)
    if backend == "ref":
        return _select(_ref.ref_segment_aggregate_block_table(
            values_arena, segment_ids, table, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots, num_cols=num_cols),
            stats)
    return segment_aggregate_block_table_cuda(
        values_arena, segment_ids, table, num_segments, valid=valid,
        slot_ids=slot_ids, num_slots=num_slots, stats=stats,
        num_cols=num_cols)


def segment_aggregate_block_table_splitk(values_arena, segment_ids, table,
                                         num_segments: int, chunk_rows: int,
                                         valid=None, slot_ids=None,
                                         num_slots: Optional[int] = None,
                                         backend: str = "auto",
                                         stats: tuple = ALL_STATS,
                                         mesh=None,
                                         num_cols: Optional[int] = None,
                                         device=None):
    """Split-K block-table fold (K3): the K2 gather with the rows cut
    into fixed chunks of ``chunk_rows``, one partial per chunk, merged on
    the device. ``'ref'`` is the chunk-looped oracle."""
    _check(backend, mesh)
    stats = _norm_stats(stats)
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    dev, values_arena, segment_ids, table, valid, slot_ids = _table_args(
        values_arena, segment_ids, table, valid, slot_ids, device)
    r = table.shape[0]
    ns = num_slots if num_slots is not None else \
        (r if slot_ids is None else None)
    if ns is None:
        raise ValueError("num_slots is required when slot_ids is given")
    if r == 0 or ns == 0:
        w_out = num_cols if num_cols is not None else values_arena.shape[2]
        return _select(_empty_batch_identity(ns, num_segments, w_out, dev),
                       stats)
    if backend == "ref":
        return _select(_ref.ref_segment_aggregate_block_table_splitk(
            values_arena, segment_ids, table, num_segments, chunk_rows,
            valid=valid, slot_ids=slot_ids, num_slots=num_slots,
            num_cols=num_cols), stats)
    return segment_aggregate_block_table_splitk_cuda(
        values_arena, segment_ids, table, num_segments, chunk_rows,
        valid=valid, slot_ids=slot_ids, num_slots=num_slots, stats=stats,
        num_cols=num_cols)
