"""Windowed segment aggregation (reduce-by-key): the folds of Aion's
late-event loop, as hand-written CUDA kernels for Hopper and their plain
PyTorch versions.

Three kernels (``csrc/segment_aggregate.cu``), each behind a wrapper that
launches it for a CUDA tensor and takes the plain version only for a
tensor on the CPU:

  K1 ``segment_aggregate_cuda``              flat reduce-by-key: values
     [N, W], ids [N], valid [N] -> per-segment sum / count / min / max.
     ``segment_aggregate_batched_cuda`` reaches it with composite ids
     ``slot * S + key`` (the stacked fold of many windows).
  K2 ``segment_aggregate_block_table_cuda``  the K1 reduction over the
     persistent block pool: row ``r``'s event tile is read straight out
     of ``arena[table[r]]`` inside the kernel (no per-batch gather copy),
     keeping the first ``num_cols`` value columns.
  K3 ``segment_aggregate_block_table_splitk_cuda``  the K2 fold with the
     table's rows cut into fixed chunks of ``chunk_rows``; chunk ``c``
     accumulates its own partial ``[k, slots, S(, W)]``, merged by
     ``merge_partials`` or returned raw.

Only the requested ``stats`` are allocated and computed: a sum/count fold
touches no min/max memory. Empty segments hold the fold identities (0 sum
and count, +inf min, -inf max), and min/max propagate NaN as
``jnp.minimum``/``jnp.maximum`` do. Each wrapper counts its launches in a
plain int attribute (``segment_aggregate_cuda.launches``), which
``chip_smoke.py`` reads to show that the engine's run went through the
kernels.

The plain versions (``*_plain``) compute the same function with
``index_add_`` / ``scatter_reduce``; the CPU tests hold them against the
JAX package, and on the card they are the reference each kernel is held
against. The multi-device wrappers of the JAX package, and their row
placement (``pack_rows_shard_major``), are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import resolve_device

ALL_STATS = ("sum", "count", "min", "max")


def norm_stats(stats) -> Tuple[str, ...]:
    """Canonicalize a stats selection: fixed order, validated, deduped."""
    stats = tuple(stats)
    for s in stats:
        if s not in ALL_STATS:
            raise ValueError(f"unknown stat {s!r} (of {ALL_STATS})")
    out = tuple(s for s in ALL_STATS if s in stats)
    if not out:
        raise ValueError("stats selection is empty")
    return out


def _identity(stats, prefix: Tuple[int, ...], w: int,
              device) -> Dict[str, torch.Tensor]:
    """Fold identities for ``stats``: [*prefix(, w)] float32 tensors."""
    out = {}
    for s in stats:
        shape = prefix if s == "count" else (*prefix, w)
        if s == "min":
            out[s] = torch.full(shape, float("inf"), device=device)
        elif s == "max":
            out[s] = torch.full(shape, float("-inf"), device=device)
        else:
            out[s] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out


def empty_batch_identity(num_slots: int, num_segments: int, w: int,
                         device=None) -> dict:
    """Fold identity per (slot, segment) for an empty batch: zero
    sums/counts, +/-inf extrema. Shared by the entry points and the ref
    oracle so the empty-batch contract cannot drift between them."""
    return _identity(ALL_STATS, (num_slots, num_segments), w,
                     resolve_device(device))


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def merge_partials(partials: dict) -> dict:
    """Merge ``[k, ...]`` per-chunk partials along the chunk axis through
    each stat's identity: sum/count add, min/max take elementwise extrema
    (NaN propagates). ``k == 0`` merges to the fold identity."""
    out = {}
    for s, v in partials.items():
        if v.shape[0] == 0:
            fill = {"min": float("inf"), "max": float("-inf")}.get(s, 0.0)
            out[s] = torch.full(v.shape[1:], fill, dtype=torch.float32,
                                device=v.device)
        elif s == "min":
            out[s] = torch.amin(v, dim=0)
        elif s == "max":
            out[s] = torch.amax(v, dim=0)
        else:
            out[s] = torch.sum(v, dim=0)
    return out


def _slots(slot_ids, num_slots, rows: int, device):
    """Default slot layout (one row per slot) and the num_slots check."""
    if slot_ids is None:
        slot_ids = torch.arange(rows, dtype=torch.int32, device=device)
        if num_slots is None:
            num_slots = rows
    elif num_slots is None:
        raise ValueError("num_slots is required when slot_ids is given")
    return slot_ids, num_slots


def _shape(out: dict, prefix: Tuple[int, ...], w: int) -> dict:
    return {s: v.reshape(prefix if s == "count" else (*prefix, w))
            for s, v in out.items()}


# ------------------------------------------------------------ plain versions
def segment_aggregate_plain(values: torch.Tensor, segment_ids: torch.Tensor,
                            num_segments: int,
                            valid: Optional[torch.Tensor] = None,
                            stats: Tuple[str, ...] = ALL_STATS) -> dict:
    """K1's function in plain torch: values [N, W], segment_ids [N] ->
    {sum [S, W], count [S], min [S, W], max [S, W]} restricted to
    ``stats``. Invalid rows and out-of-range ids park on an extra
    segment that is cut off."""
    stats = norm_stats(stats)
    n, w = values.shape
    dev = values.device
    values = values.to(torch.float32)
    ok = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
          else valid.to(device=dev, dtype=torch.bool))
    ids = segment_ids.to(device=dev, dtype=torch.int64)
    ok = ok & (ids >= 0) & (ids < num_segments)
    sid = torch.where(ok, ids, num_segments)
    out = {}
    if "sum" in stats:
        acc = torch.zeros(num_segments + 1, w, device=dev)
        acc.index_add_(0, sid, torch.where(ok[:, None], values, 0.0))
        out["sum"] = acc[:num_segments]
    if "count" in stats:
        acc = torch.zeros(num_segments + 1, device=dev)
        acc.index_add_(0, sid, ok.to(torch.float32))
        out["count"] = acc[:num_segments]
    for s, red, ident in (("min", "amin", float("inf")),
                          ("max", "amax", float("-inf"))):
        if s in stats:
            acc = torch.full((num_segments + 1, w), ident, device=dev)
            acc.scatter_reduce_(0, sid[:, None].expand(n, w),
                                torch.where(ok[:, None], values, ident),
                                red, include_self=True)
            out[s] = acc[:num_segments]
    return out


def segment_aggregate_batched_plain(values, segment_ids, num_segments: int,
                                    valid=None, slot_ids=None,
                                    num_slots: Optional[int] = None,
                                    stats: Tuple[str, ...] = ALL_STATS
                                    ) -> dict:
    """The stacked multi-window fold in plain torch: values [B, N, W],
    ids [B, N], slot_ids [B] -> [num_slots, S(, W)] through composite ids
    ``slot * S + key``."""
    stats = norm_stats(stats)
    b, n, w = values.shape
    slot_ids, num_slots = _slots(slot_ids, num_slots, b, values.device)
    if b == 0 or num_slots == 0:
        return _identity(stats, (num_slots, num_segments), w, values.device)
    comp = (slot_ids.to(values.device, torch.int64)[:, None] * num_segments
            + segment_ids.to(values.device, torch.int64))
    out = segment_aggregate_plain(
        values.reshape(b * n, w), comp.reshape(b * n),
        num_slots * num_segments,
        valid=None if valid is None else valid.reshape(b * n), stats=stats)
    return _shape(out, (num_slots, num_segments), w)


def _gather_rows(values_arena, table, num_cols):
    vals = values_arena.index_select(0, table.to(values_arena.device,
                                                 torch.int64))
    return vals if num_cols is None else vals[:, :, :num_cols]


def segment_aggregate_block_table_plain(values_arena, segment_ids, table,
                                        num_segments: int, valid=None,
                                        slot_ids=None,
                                        num_slots: Optional[int] = None,
                                        stats: Tuple[str, ...] = ALL_STATS,
                                        num_cols: Optional[int] = None
                                        ) -> dict:
    """K2's function in plain torch: one ``index_select`` along the pool
    axis, then the stacked fold."""
    return segment_aggregate_batched_plain(
        _gather_rows(values_arena, table, num_cols), segment_ids,
        num_segments, valid=valid, slot_ids=slot_ids, num_slots=num_slots,
        stats=stats)


def _pad_rows(table, segment_ids, valid, slot_ids, chunk_rows: int):
    """Pad the rows to a multiple of ``chunk_rows`` with inert rows
    (pool slot 0, slot 0, valid 0)."""
    r = table.shape[0]
    pad = (-r) % chunk_rows
    if pad:
        table = torch.nn.functional.pad(table, (0, pad))
        segment_ids = torch.nn.functional.pad(segment_ids, (0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, 0, 0, pad))
        slot_ids = torch.nn.functional.pad(slot_ids, (0, pad))
    return table, segment_ids, valid, slot_ids, (r + pad) // chunk_rows


def _splitk_prologue(values_arena, segment_ids, table, chunk_rows, valid,
                     slot_ids, num_slots, num_cols):
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    p, cap, w = values_arena.shape
    w_out = num_cols if num_cols is not None else w
    r = table.shape[0]
    slot_ids, num_slots = _slots(slot_ids, num_slots, r,
                                 values_arena.device)
    if valid is None:
        valid = torch.ones((r, cap), dtype=torch.bool,
                           device=values_arena.device)
    return w_out, r, slot_ids, num_slots, valid


def _splitk_empty(stats, num_slots, num_segments, w_out, merge, device):
    """Zero-row split-K result: the identity when merging, else an empty
    ``k == 0`` partial stack."""
    ident = _identity(stats, (num_slots, num_segments), w_out, device)
    if merge:
        return ident
    return {s: v[None][:0] for s, v in ident.items()}


def segment_aggregate_block_table_splitk_plain(
        values_arena, segment_ids, table, num_segments: int,
        chunk_rows: int, valid=None, slot_ids=None,
        num_slots: Optional[int] = None,
        stats: Tuple[str, ...] = ALL_STATS,
        num_cols: Optional[int] = None, merge: bool = True) -> dict:
    """K3's function in plain torch, with the kernel's own layout: rows
    pad to a chunk multiple, chunk ``c``'s rows fold into partial ``c``
    (composite ids offset by ``c * slots * S``), and the partials merge
    through ``merge_partials`` or come back raw."""
    stats = norm_stats(stats)
    dev = values_arena.device
    w_out, r, slot_ids, num_slots, valid = _splitk_prologue(
        values_arena, segment_ids, table, chunk_rows, valid, slot_ids,
        num_slots, num_cols)
    if r == 0 or num_slots == 0:
        return _splitk_empty(stats, num_slots, num_segments, w_out, merge,
                             dev)
    table, segment_ids, valid, slot_ids, k = _pad_rows(
        table.to(dev), segment_ids.to(dev), valid.to(dev),
        slot_ids.to(dev), chunk_rows)
    chunk = torch.arange(k * chunk_rows, device=dev) // chunk_rows
    part_slot = chunk * num_slots + slot_ids.to(torch.int64)
    out = segment_aggregate_block_table_plain(
        values_arena, segment_ids, table, num_segments, valid=valid,
        slot_ids=part_slot, num_slots=k * num_slots, stats=stats,
        num_cols=num_cols)
    parts = _shape(out, (k, num_slots, num_segments), w_out)
    return merge_partials(parts) if merge else parts


# -------------------------------------------------------- CUDA kernel wrappers
def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _valid_u8(valid, shape, device) -> torch.Tensor:
    """``valid`` as a contiguous uint8 mask of ``shape`` (1 = valid)."""
    if valid is None:
        return torch.ones(shape, dtype=torch.uint8, device=device)
    if valid.device != device or tuple(valid.shape) != tuple(shape):
        raise ValueError(f"valid must be {tuple(shape)} on {device}, got "
                         f"{tuple(valid.shape)} on {valid.device}")
    return valid.to(torch.bool).contiguous().view(torch.uint8)


def _i32(t: torch.Tensor, shape, device, name: str) -> torch.Tensor:
    if t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.int32).contiguous()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lib():
    from repro_torch.kernels._build import library
    return library()


def segment_aggregate_cuda(values: torch.Tensor, segment_ids: torch.Tensor,
                           num_segments: int,
                           valid: Optional[torch.Tensor] = None,
                           stats: Tuple[str, ...] = ALL_STATS) -> dict:
    """K1: flat reduce-by-key. values [N, W] float32 (rows may be strided,
    columns contiguous), segment_ids [N], valid [N] -> dict of [S, W] /
    [S] stats. A CPU tensor takes ``segment_aggregate_plain``."""
    stats = norm_stats(stats)
    if not values.is_cuda:
        return segment_aggregate_plain(values, segment_ids, num_segments,
                                       valid=valid, stats=stats)
    dev = values.device
    n, w = values.shape
    if values.dtype != torch.float32 or values.stride(1) != 1:
        raise ValueError("values must be float32 with contiguous columns")
    ids = _i32(segment_ids, (n,), dev, "segment_ids")
    ok = _valid_u8(valid, (n,), dev)
    out = _identity(stats, (num_segments,), w, dev)
    if n == 0 or num_segments == 0:
        return out
    _lib().call("seg_agg_flat", values.data_ptr(), values.stride(0), w,
                ids.data_ptr(), ok.data_ptr(), n, num_segments,
                _ptr(out.get("sum")), _ptr(out.get("count")),
                _ptr(out.get("min")), _ptr(out.get("max")), _stream(dev))
    segment_aggregate_cuda.launches += 1
    return out


segment_aggregate_cuda.launches = 0


def segment_aggregate_batched_cuda(values, segment_ids, num_segments: int,
                                   valid=None, slot_ids=None,
                                   num_slots: Optional[int] = None,
                                   stats: Tuple[str, ...] = ALL_STATS
                                   ) -> dict:
    """Many windows in ONE K1 launch: values [B, N, W], ids [B, N],
    slot_ids [B] -> [num_slots, S(, W)], through composite segment ids
    ``slot * S + key`` built here."""
    stats = norm_stats(stats)
    if not values.is_cuda:
        return segment_aggregate_batched_plain(
            values, segment_ids, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots, stats=stats)
    b, n, w = values.shape
    slot_ids, num_slots = _slots(slot_ids, num_slots, b, values.device)
    if b == 0 or num_slots == 0:
        return _identity(stats, (num_slots, num_segments), w, values.device)
    comp = (slot_ids.to(torch.int32)[:, None] * num_segments
            + segment_ids.to(torch.int32))
    flat = values.reshape(b * n, w)
    if flat.stride(1) != 1:
        flat = flat.contiguous()
    out = segment_aggregate_cuda(
        flat, comp.reshape(b * n), num_slots * num_segments,
        valid=None if valid is None else valid.reshape(b * n), stats=stats)
    return _shape(out, (num_slots, num_segments), w)


def _block_table_launch(name: str, values_arena, segment_ids, table,
                        num_segments, valid, slot_ids, num_slots, stats,
                        num_cols, chunk_rows: int, parts: int):
    """Shared K2/K3 launch: composite ids, checks, identity outputs of
    ``parts`` partials, one launch. Returns flat outputs."""
    dev = values_arena.device
    p, cap, w = values_arena.shape
    w_out = num_cols if num_cols is not None else w
    if not 1 <= w_out <= w:
        raise ValueError(f"num_cols must be in [1, {w}], got {num_cols}")
    if values_arena.dtype != torch.float32 \
            or not values_arena.is_contiguous():
        raise ValueError("values_arena must be a contiguous float32 "
                         "[pool_slots, cap, W] tensor")
    r = table.shape[0]
    tbl = _i32(table, (r,), dev, "table")
    comp = (_i32(slot_ids, (r,), dev, "slot_ids")[:, None] * num_segments
            + _i32(segment_ids, (r, cap), dev, "segment_ids")).contiguous()
    ok = _valid_u8(valid, (r, cap), dev)
    s_total = num_slots * num_segments
    out = _identity(stats, (parts * s_total,), w_out, dev)
    args = [values_arena.data_ptr(), p, cap, w, w_out, tbl.data_ptr(), r,
            comp.data_ptr(), ok.data_ptr(), s_total]
    if chunk_rows:
        args.append(chunk_rows)
    args += [_ptr(out.get("sum")), _ptr(out.get("count")),
             _ptr(out.get("min")), _ptr(out.get("max")), _stream(dev)]
    _lib().call(name, *args)
    return out, w_out


def segment_aggregate_block_table_cuda(values_arena, segment_ids, table,
                                       num_segments: int, valid=None,
                                       slot_ids=None,
                                       num_slots: Optional[int] = None,
                                       stats: Tuple[str, ...] = ALL_STATS,
                                       num_cols: Optional[int] = None
                                       ) -> dict:
    """K2: fold over the block pool, reading each row's tile from the
    arena inside the kernel. values_arena [P, cap, W] float32, table [R]
    pool slots, segment_ids / valid [R, cap], slot_ids [R] -> per-slot
    stats [num_slots, S(, num_cols)]."""
    stats = norm_stats(stats)
    if not values_arena.is_cuda:
        return segment_aggregate_block_table_plain(
            values_arena, segment_ids, table, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots, stats=stats,
            num_cols=num_cols)
    r = table.shape[0]
    slot_ids, num_slots = _slots(slot_ids, num_slots, r,
                                 values_arena.device)
    w_out = num_cols if num_cols is not None else values_arena.shape[2]
    if r == 0 or num_slots == 0:
        return _identity(stats, (num_slots, num_segments), w_out,
                         values_arena.device)
    out, w_out = _block_table_launch(
        "seg_agg_block_table", values_arena, segment_ids, table,
        num_segments, valid, slot_ids, num_slots, stats, num_cols, 0, 1)
    segment_aggregate_block_table_cuda.launches += 1
    return _shape(out, (num_slots, num_segments), w_out)


segment_aggregate_block_table_cuda.launches = 0


def segment_aggregate_block_table_splitk_cuda(
        values_arena, segment_ids, table, num_segments: int,
        chunk_rows: int, valid=None, slot_ids=None,
        num_slots: Optional[int] = None,
        stats: Tuple[str, ...] = ALL_STATS,
        num_cols: Optional[int] = None, merge: bool = True) -> dict:
    """K3: the K2 fold with the rows padded to a multiple of
    ``chunk_rows`` (inert rows: pool slot 0, slot 0, valid 0) and chunk
    ``c`` folding into its own partial. ``merge=False`` returns the raw
    ``[k, num_slots, S(, W)]`` partials."""
    stats = norm_stats(stats)
    if not values_arena.is_cuda:
        return segment_aggregate_block_table_splitk_plain(
            values_arena, segment_ids, table, num_segments, chunk_rows,
            valid=valid, slot_ids=slot_ids, num_slots=num_slots,
            stats=stats, num_cols=num_cols, merge=merge)
    dev = values_arena.device
    w_out, r, slot_ids, num_slots, valid = _splitk_prologue(
        values_arena, segment_ids, table, chunk_rows, valid, slot_ids,
        num_slots, num_cols)
    if r == 0 or num_slots == 0:
        return _splitk_empty(stats, num_slots, num_segments, w_out, merge,
                             dev)
    table, segment_ids, valid, slot_ids, k = _pad_rows(
        table, segment_ids, valid.to(torch.bool), slot_ids, chunk_rows)
    out, w_out = _block_table_launch(
        "seg_agg_block_table_splitk", values_arena, segment_ids, table,
        num_segments, valid, slot_ids, num_slots, stats, num_cols,
        chunk_rows, k)
    segment_aggregate_block_table_splitk_cuda.launches += 1
    parts = _shape(out, (k, num_slots, num_segments), w_out)
    return merge_partials(parts) if merge else parts


segment_aggregate_block_table_splitk_cuda.launches = 0

#: the kernel wrappers whose ``launches`` the smoke run reads
KERNEL_WRAPPERS = (segment_aggregate_cuda,
                   segment_aggregate_block_table_cuda,
                   segment_aggregate_block_table_splitk_cuda)
