"""Plain-torch oracles for the segment-aggregate folds (the correctness
contract the plain versions and the CUDA kernels are held against).

Written independently of ``segment_aggregate.py``: a straight scatter
formulation with invalid rows parked on an extra segment. The attention
and SSD oracles of the JAX package come with the kernels they check.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.segment_aggregate import empty_batch_identity


def ref_segment_aggregate(values: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int,
                          valid: Optional[torch.Tensor] = None) -> dict:
    """values [N, W] f32; segment_ids [N] -> per-segment sum / count /
    min / max. Invalid rows (valid == False) contribute nothing."""
    n, w = values.shape
    dev = values.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid = valid.to(dev, torch.bool)
    sid = torch.where(valid, segment_ids.to(dev, torch.int64),
                      num_segments)                       # park invalid
    idx = sid[:, None].expand(n, w)
    inf = float("inf")
    vsum = torch.zeros(num_segments + 1, w, device=dev).index_add_(
        0, sid, torch.where(valid[:, None], values, 0.0))
    cnt = torch.zeros(num_segments + 1, device=dev).index_add_(
        0, sid, valid.to(torch.float32))
    vmin = torch.full((num_segments + 1, w), inf, device=dev).scatter_reduce_(
        0, idx, torch.where(valid[:, None], values, inf), "amin")
    vmax = torch.full((num_segments + 1, w), -inf, device=dev).scatter_reduce_(
        0, idx, torch.where(valid[:, None], values, -inf), "amax")
    return {"sum": vsum[:num_segments], "count": cnt[:num_segments],
            "min": vmin[:num_segments], "max": vmax[:num_segments]}


def ref_segment_aggregate_batched(values: torch.Tensor,
                                  segment_ids: torch.Tensor,
                                  num_segments: int,
                                  valid: Optional[torch.Tensor] = None,
                                  slot_ids: Optional[torch.Tensor] = None,
                                  num_slots: Optional[int] = None) -> dict:
    """values [B, N, W]; segment_ids [B, N]; slot_ids [B] -> per-slot
    sum/count/min/max [num_slots, num_segments, ...] via composite
    (slot, key) ids."""
    b, n, w = values.shape
    dev = values.device
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    if slot_ids is None:
        slot_ids = torch.arange(b, device=dev)
        if num_slots is None:
            num_slots = b
    elif num_slots is None:
        raise ValueError("num_slots is required when slot_ids is given")
    if b == 0 or num_slots == 0:
        return empty_batch_identity(num_slots, num_segments, w, dev)
    composite = (slot_ids.to(dev, torch.int64)[:, None] * num_segments
                 + segment_ids.to(dev, torch.int64))
    out = ref_segment_aggregate(values.reshape(b * n, w),
                                composite.reshape(b * n),
                                num_slots * num_segments,
                                valid=valid.reshape(b * n))
    return {
        "sum": out["sum"].reshape(num_slots, num_segments, w),
        "count": out["count"].reshape(num_slots, num_segments),
        "min": out["min"].reshape(num_slots, num_segments, w),
        "max": out["max"].reshape(num_slots, num_segments, w),
    }


def ref_segment_aggregate_block_table(values_arena: torch.Tensor,
                                      segment_ids: torch.Tensor,
                                      table: torch.Tensor,
                                      num_segments: int,
                                      valid: Optional[torch.Tensor] = None,
                                      slot_ids: Optional[torch.Tensor] = None,
                                      num_slots: Optional[int] = None,
                                      num_cols: Optional[int] = None
                                      ) -> dict:
    """Block-table oracle: an explicit gather along the pool axis
    (``num_cols`` keeps the leading value columns), then the batched
    oracle."""
    vals = values_arena[table.to(values_arena.device, torch.int64)]
    if num_cols is not None:
        vals = vals[:, :, :num_cols]
    return ref_segment_aggregate_batched(
        vals, segment_ids, num_segments, valid=valid, slot_ids=slot_ids,
        num_slots=num_slots)


def ref_segment_aggregate_block_table_splitk(
        values_arena: torch.Tensor, segment_ids: torch.Tensor,
        table: torch.Tensor, num_segments: int, chunk_rows: int,
        valid: Optional[torch.Tensor] = None,
        slot_ids: Optional[torch.Tensor] = None,
        num_slots: Optional[int] = None,
        num_cols: Optional[int] = None) -> dict:
    """Split-K oracle: fold ``chunk_rows`` table rows at a time through
    the block-table oracle from the fold identity, merging each chunk's
    partial through the stat's own reduction. Zero rows merges to the
    identity."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    r = table.shape[0]
    dev = values_arena.device
    w_out = num_cols if num_cols is not None else values_arena.shape[2]
    if slot_ids is None:
        slot_ids = torch.arange(r, device=dev)
        if num_slots is None:
            num_slots = r
    elif num_slots is None:
        raise ValueError("num_slots is required when slot_ids is given")
    acc = empty_batch_identity(num_slots, num_segments, w_out, dev)
    for off in range(0, r, chunk_rows):
        sl = slice(off, min(off + chunk_rows, r))
        part = ref_segment_aggregate_block_table(
            values_arena, segment_ids[sl], table[sl], num_segments,
            valid=None if valid is None else valid[sl],
            slot_ids=slot_ids[sl], num_slots=num_slots, num_cols=num_cols)
        acc = {
            "sum": acc["sum"] + part["sum"],
            "count": acc["count"] + part["count"],
            "min": torch.minimum(acc["min"], part["min"]),
            "max": torch.maximum(acc["max"], part["max"]),
        }
    return acc
