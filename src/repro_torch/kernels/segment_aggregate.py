"""Windowed segment aggregation (reduce-by-key): the folds of Aion's
late-event loop, as hand-written CUDA kernels for Hopper and their plain
PyTorch versions.

Three kernels (``csrc/segment_aggregate.cu``, and the shared-memory
designs of K1, K2 and K3 in ``csrc/segment_splitk.cu``), each behind a
wrapper that launches it for a CUDA tensor and takes the plain version
only for a tensor on the CPU:

  K1 ``segment_aggregate_cuda``              flat reduce-by-key: values
     [N, W], ids [N], valid [N] -> per-segment sum / count / min / max.
     ``segment_aggregate_batched_cuda`` reaches it with composite ids
     ``slot * S + key`` (the stacked fold of many windows). Its design
     comes from the rule of K3: ``smem`` (``seg_agg_flat_smem`` in
     ``csrc/segment_splitk.cu``: K2's fold and flush with the event's row
     at ``values + e * ld``, the composite ids made inside the kernel)
     where a block's partial fits SPLITK_SMEM_BYTES, else ``global``
     (one thread an event, global atomics). Both wrappers count on
     ``segment_aggregate_cuda``, by design in ``launches_by_design``.
  K2 ``segment_aggregate_block_table_cuda``  the K1 reduction over the
     persistent block pool: row ``r``'s event tile is read straight out
     of ``arena[table[r]]`` inside the kernel (no per-batch gather copy),
     keeping the first ``num_cols`` value columns. Its design comes from
     the rule of K3: ``smem`` (``csrc/segment_splitk.cu``: blocks of
     SPLITK_EVENTS_PER_BLOCK events fold into shared-memory partials,
     each flushed into the output with one global atomic per touched word,
     the composite ids and identities made inside the kernel) where a
     block's partial fits SPLITK_SMEM_BYTES, else ``global``, the kernel
     with one thread an event and global atomics. It counts its launches
     by design in ``launches_by_design``.
  K3 ``segment_aggregate_block_table_splitk_cuda``  the K2 fold with the
     table's rows cut into fixed chunks of ``chunk_rows``; chunk ``c``
     accumulates its own partial ``[k, slots, S(, W)]``, merged or
     returned raw. Its design comes from ``splitk_design``: where a
     block's partial fits SPLITK_SMEM_BYTES of shared memory, ``smem``
     (``csrc/segment_splitk.cu``: each block of ``splitk_plan``'s events
     folds into a private shared-memory partial, and the last block of
     each chunk to finish merges the chunk's blocks in order, all in one
     launch); else ``global``, the K2 kernel on
     padded rows with global atomics into the partials. It counts its
     launches by design in ``launches_by_design``.

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
against.

The slot-sharded wrappers (``*_sharded``, over a ``SlotMesh`` of
``repro_torch.distributed.sharding``) split one fold across the mesh's
devices: shard ``d`` takes its rows, rebases their window slots (and pool
slots) to its own ranges, masks misplaced rows invalid, and launches the
K1/K2/K3 wrapper on ``mesh.devices[d]`` over its arena tile; the tiles
concatenate along the slot axis on ``mesh.devices[0]`` (the split-K
variant merges D full partials instead). Each shard's launch is issued
without a host sync before the next. Their row placement is
``pack_rows_shard_major``. Each kernel wrapper also counts the launches
a sharded call made, by shard and design, in ``launches_by_shard``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import raw_stream, resolve_device

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


SPLITK_DESIGNS = ("smem", "global")
#: the largest per-block partial the smem design keeps (the shared memory
#: a block gets without opting in)
SPLITK_SMEM_BYTES = 48 * 1024
#: events one block of the smem design folds, 4 for each of its 512
#: threads (one batch of loads): a chunk of 64 rows of 512 events takes 16
#: blocks (the partials its last block merges), so the 8 chunks of the
#: stock fold give 128 blocks, one on each SM
SPLITK_EVENTS_PER_BLOCK = 2048
#: the stats argument of the smem kernel: one bit per requested stat
_STAT_BITS = {"sum": 1, "count": 2, "min": 4, "max": 8}


def splitk_partial_bytes(stats, s_total: int, w_out: int) -> int:
    """Bytes of one block's partial for normalized ``stats``: [s_total]
    counts, [s_total, w_out] for each value stat, float32."""
    return 4 * s_total * (w_out * len(stats) - (w_out - 1) * ("count"
                                                             in stats))


def splitk_design(stats, s_total: int, w_out: int,
                  forced: str | None = None) -> str:
    """K3's, K2's and K1's design for normalized ``stats``: ``smem`` where a
    block's partial fits SPLITK_SMEM_BYTES, else ``global``; or ``forced``
    (a measurement's choice), which must take these inputs."""
    nbytes = splitk_partial_bytes(stats, s_total, w_out)
    table = "smem" if 0 < nbytes <= SPLITK_SMEM_BYTES else "global"
    if forced is None:
        return table
    if forced not in SPLITK_DESIGNS:
        raise ValueError(f"design {forced!r} is none of {SPLITK_DESIGNS}")
    if forced == "smem" and table != "smem":
        raise ValueError(f"the smem design keeps partials of at most "
                         f"{SPLITK_SMEM_BYTES} bytes, these take {nbytes}")
    return forced


def splitk_plan(rows: int, cap: int, chunk_rows: int) -> tuple:
    """(chunks k, blocks per chunk, events per block) of an smem launch:
    each chunk's chunk_rows x cap events cut into equal runs of at most
    SPLITK_EVENTS_PER_BLOCK (the last chunk's blocks past row ``rows``
    fold nothing)."""
    k = -(-rows // chunk_rows)
    events = chunk_rows * cap
    per_chunk = max(1, -(-events // SPLITK_EVENTS_PER_BLOCK))
    return k, per_chunk, -(-events // per_chunk)


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
    return w_out, r, slot_ids, num_slots


def _all_valid(valid, r: int, cap: int, device) -> torch.Tensor:
    return torch.ones((r, cap), dtype=torch.bool, device=device) \
        if valid is None else valid


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
    w_out, r, slot_ids, num_slots = _splitk_prologue(
        values_arena, segment_ids, table, chunk_rows, valid, slot_ids,
        num_slots, num_cols)
    if r == 0 or num_slots == 0:
        return _splitk_empty(stats, num_slots, num_segments, w_out, merge,
                             dev)
    valid = _all_valid(valid, r, values_arena.shape[1], dev)
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
    if t.shape != shape or t.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _valid_bytes(valid, shape, device) -> Optional[torch.Tensor]:
    """``valid`` as contiguous bool bytes (0 / 1) of ``shape``, or None
    (every event valid)."""
    if valid is None:
        return None
    if valid.shape != shape or valid.device != device:
        raise ValueError(f"valid must be {tuple(shape)} on {device}, got "
                         f"{tuple(valid.shape)} on {valid.device}")
    if valid.dtype != torch.bool:
        valid = valid != 0
    return valid if valid.is_contiguous() else valid.contiguous()


def _lib(source: str = "segment_aggregate.cu"):
    from repro_torch.kernels._build import library
    return library(source)


def flat_smem_launch(values: torch.Tensor, segment_ids, num_segments: int,
                     valid, slot_ids, num_slots: Optional[int], stats,
                     per_block: Optional[int] = None):
    """The checks, outputs and C arguments of one launch of K1's smem
    design (``seg_agg_flat_smem``): returns (arguments, outputs, tensors
    the launch reads, to be kept alive until it is enqueued). ``values``
    is [N, W] with ``slot_ids`` None (the ids are the segments; outputs
    [S(, W)]), or [B, N, W] with ``slot_ids`` [B] (composite ids ``slot *
    S + id`` made in the kernel; outputs [num_slots, S(, W)]); an event's
    row may be strided, its columns contiguous. ``stats`` must be
    normalized and the events non-empty. ``per_block`` (a measurement's
    choice) replaces SPLITK_EVENTS_PER_BLOCK."""
    dev = values.device
    if values.dtype != torch.float32 or values.stride(-1) != 1:
        raise ValueError("values must be float32 with contiguous columns")
    lead, w = tuple(values.shape[:-1]), values.shape[-1]
    rows, n = (1, lead[0]) if slot_ids is None else lead
    if slot_ids is not None and rows > 1 \
            and values.stride(0) != n * values.stride(1):
        # event b * N + i must sit at (b * N + i) * ld
        values = values.contiguous()
    ids = _i32(segment_ids, lead, dev, "segment_ids")
    slots = None if slot_ids is None else _i32(slot_ids, (rows,), dev,
                                               "slot_ids")
    ok = _valid_bytes(valid, lead, dev)
    s_total = (num_slots or 1) * num_segments
    # one allocation: the outputs, each a view of it, then the kernel's
    # block counter
    words = splitk_partial_bytes(stats, s_total, w) // 4
    buf = torch.empty(words + 1, dtype=torch.float32, device=dev)
    out, _, _ = _stat_views(buf, stats, (), num_slots, num_segments, w, 1)
    args = (values.data_ptr(), values.stride(-2), n, rows, w,
            ids.data_ptr(), _ptr(slots), _ptr(ok), num_segments, s_total,
            per_block or SPLITK_EVENTS_PER_BLOCK,
            sum(_STAT_BITS[s] for s in stats),
            buf.data_ptr(), raw_stream(dev))
    return args, out, (values, ids, slots, ok, buf)


def _flat_global(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                 valid, stats) -> dict:
    """K1's earlier design (``seg_agg_flat``: one thread an event, global
    atomics into outputs filled with the identities) on values [N, W] and
    composite ids [N]."""
    dev = values.device
    n, w = values.shape
    if values.dtype != torch.float32 or values.stride(1) != 1:
        raise ValueError("values must be float32 with contiguous columns")
    ids = _i32(ids, (n,), dev, "segment_ids")
    ok = _valid_u8(valid, (n,), dev)
    out = _identity(stats, (num_segments,), w, dev)
    _lib().call("seg_agg_flat", values.data_ptr(), values.stride(0), w,
                ids.data_ptr(), ok.data_ptr(), n, num_segments,
                _ptr(out.get("sum")), _ptr(out.get("count")),
                _ptr(out.get("min")), _ptr(out.get("max")), raw_stream(dev))
    return out


def _count(wrapper, design: str, shard: Optional[int]) -> None:
    """One launch of ``wrapper``'s kernel on ``design``; a sharded call's
    launch (``shard``, its index in the mesh) counts on
    ``launches_by_shard`` too."""
    wrapper.launches += 1
    wrapper.launches_by_design[design] += 1
    if shard is not None:
        wrapper.launches_by_shard.setdefault(
            shard, dict.fromkeys(SPLITK_DESIGNS, 0))[design] += 1


def segment_aggregate_cuda(values: torch.Tensor, segment_ids: torch.Tensor,
                           num_segments: int,
                           valid: Optional[torch.Tensor] = None,
                           stats: Tuple[str, ...] = ALL_STATS,
                           design: Optional[str] = None,
                           shard: Optional[int] = None) -> dict:
    """K1: flat reduce-by-key. values [N, W] float32 (rows may be strided,
    columns contiguous), segment_ids [N], valid [N] -> dict of [S, W] /
    [S] stats. Its design is ``splitk_design``'s: ``smem``
    (``seg_agg_flat_smem`` in ``csrc/segment_splitk.cu``: block partials
    in shared memory flushed into the output by atomics) where a block's
    partial fits, else ``global`` (``seg_agg_flat``). ``design`` forces
    one (for measurements) and raises where it does not take the inputs.
    Launches count on this wrapper, by design in ``launches_by_design``,
    whichever K1 wrapper launched, and a sharded call's (``shard``) by
    shard in ``launches_by_shard``. A CPU tensor takes
    ``segment_aggregate_plain``."""
    stats = norm_stats(stats)
    if not values.is_cuda:
        return segment_aggregate_plain(values, segment_ids, num_segments,
                                       valid=valid, stats=stats)
    n, w = values.shape
    if n == 0 or num_segments == 0:
        return _identity(stats, (num_segments,), w, values.device)
    chosen = splitk_design(stats, num_segments, w, design)
    if chosen == "smem":
        args, out, _keep = flat_smem_launch(values, segment_ids,
                                            num_segments, valid, None, None,
                                            stats)
        _lib("segment_splitk.cu").call("seg_agg_flat_smem", *args)
    else:
        out = _flat_global(values, segment_ids, num_segments, valid, stats)
    _count(segment_aggregate_cuda, chosen, shard)
    return out


segment_aggregate_cuda.launches = 0
segment_aggregate_cuda.launches_by_design = dict.fromkeys(SPLITK_DESIGNS, 0)


def segment_aggregate_batched_cuda(values, segment_ids, num_segments: int,
                                   valid=None, slot_ids=None,
                                   num_slots: Optional[int] = None,
                                   stats: Tuple[str, ...] = ALL_STATS,
                                   design: Optional[str] = None,
                                   shard: Optional[int] = None) -> dict:
    """Many windows in ONE K1 launch: values [B, N, W], ids [B, N],
    slot_ids [B] -> [num_slots, S(, W)] through composite segment ids
    ``slot * S + key``: made inside the kernel on the smem design, here
    on the global one. ``design`` and ``shard`` as
    ``segment_aggregate_cuda``'s."""
    stats = norm_stats(stats)
    if not values.is_cuda:
        return segment_aggregate_batched_plain(
            values, segment_ids, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots, stats=stats)
    b, n, w = values.shape
    slot_ids, num_slots = _slots(slot_ids, num_slots, b, values.device)
    if b == 0 or n == 0 or num_slots == 0 or num_segments == 0:
        return _identity(stats, (num_slots, num_segments), w, values.device)
    chosen = splitk_design(stats, num_slots * num_segments, w, design)
    if chosen == "smem":
        args, out, _keep = flat_smem_launch(values, segment_ids,
                                            num_segments, valid, slot_ids,
                                            num_slots, stats)
        _lib("segment_splitk.cu").call("seg_agg_flat_smem", *args)
    else:
        comp = (slot_ids.to(torch.int32)[:, None] * num_segments
                + segment_ids.to(torch.int32))
        flat = values.reshape(b * n, w)
        if flat.stride(1) != 1:
            flat = flat.contiguous()
        out = _shape(_flat_global(
            flat, comp.reshape(b * n), num_slots * num_segments,
            None if valid is None else valid.reshape(b * n), stats),
            (num_slots, num_segments), w)
    _count(segment_aggregate_cuda, chosen, shard)
    return out


def _check_arena(values_arena, num_cols) -> int:
    """The arena's checks; returns the columns the fold reads."""
    w = values_arena.shape[2]
    w_out = num_cols if num_cols is not None else w
    if not 1 <= w_out <= w:
        raise ValueError(f"num_cols must be in [1, {w}], got {num_cols}")
    if values_arena.dtype != torch.float32 \
            or not values_arena.is_contiguous():
        raise ValueError("values_arena must be a contiguous float32 "
                         "[pool_slots, cap, W] tensor")
    return w_out


def _block_table_launch(name: str, values_arena, segment_ids, table,
                        num_segments, valid, slot_ids, num_slots, stats,
                        num_cols, chunk_rows: int, parts: int):
    """Shared K2/K3 launch: composite ids, checks, identity outputs of
    ``parts`` partials, one launch. Returns flat outputs."""
    dev = values_arena.device
    p, cap, w = values_arena.shape
    w_out = _check_arena(values_arena, num_cols)
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
             _ptr(out.get("min")), _ptr(out.get("max")), raw_stream(dev)]
    _lib().call(name, *args)
    return out, w_out


def _stat_views(buf: torch.Tensor, stats, lead: tuple,
                num_slots: Optional[int], num_segments: int, w_out: int,
                k_out: int) -> tuple:
    """Each stat's output as a view of ``buf`` ([*lead,] slots, S(, w_out),
    one stat after another, in a partial's layout; no slot axis where
    ``num_slots`` is None) and its address; returns (views, addresses by
    stat, floats used)."""
    slot_axis = () if num_slots is None else (num_slots,)
    s_total = (num_slots or 1) * num_segments
    base = buf.data_ptr()
    out, ptr, at = {}, dict.fromkeys(ALL_STATS), 0
    for s in stats:
        width, tail = (1, ()) if s == "count" else (w_out, (w_out,))
        out[s] = buf.as_strided(
            (*lead, *slot_axis, num_segments, *tail),
            (*(s_total * width,) * len(lead),
             *(num_segments * width,) * len(slot_axis), width,
             *(1,) * len(tail)), at)
        ptr[s] = base + 4 * at
        at += k_out * s_total * width
    return out, ptr, at


def block_table_smem_launch(values_arena, segment_ids, table,
                            num_segments: int, valid, slot_ids,
                            num_slots: int, stats, num_cols: Optional[int]):
    """The checks, outputs and C arguments of one launch of K2's smem
    design (``seg_agg_block_table_smem``): returns (arguments, outputs,
    tensors the launch reads, to be kept alive until it is enqueued).
    ``stats`` must be normalized, ``slot_ids`` given and the table
    non-empty."""
    dev = values_arena.device
    p, cap, w = values_arena.shape
    w_out = _check_arena(values_arena, num_cols)
    r = table.shape[0]
    tbl = _i32(table, (r,), dev, "table")
    ids = _i32(segment_ids, (r, cap), dev, "segment_ids")
    slots = _i32(slot_ids, (r,), dev, "slot_ids")
    ok = _valid_bytes(valid, (r, cap), dev)
    s_total = num_slots * num_segments
    # one allocation: the outputs, each a view of it, then the kernel's
    # block counter
    words = splitk_partial_bytes(stats, s_total, w_out) // 4
    buf = torch.empty(words + 1, dtype=torch.float32, device=dev)
    out, _, _ = _stat_views(buf, stats, (), num_slots, num_segments, w_out,
                            1)
    args = (values_arena.data_ptr(), p, cap, w, w_out, tbl.data_ptr(), r,
            ids.data_ptr(), slots.data_ptr(), _ptr(ok), num_segments,
            s_total, SPLITK_EVENTS_PER_BLOCK,
            sum(_STAT_BITS[s] for s in stats), buf.data_ptr(), raw_stream(dev))
    return args, out, (tbl, ids, slots, ok, buf)


def segment_aggregate_block_table_cuda(values_arena, segment_ids, table,
                                       num_segments: int, valid=None,
                                       slot_ids=None,
                                       num_slots: Optional[int] = None,
                                       stats: Tuple[str, ...] = ALL_STATS,
                                       num_cols: Optional[int] = None,
                                       design: Optional[str] = None,
                                       shard: Optional[int] = None
                                       ) -> dict:
    """K2: fold over the block pool, reading each row's tile from the
    arena inside the kernel. values_arena [P, cap, W] float32, table [R]
    pool slots, segment_ids / valid [R, cap], slot_ids [R] -> per-slot
    stats [num_slots, S(, num_cols)]. Its design is ``splitk_design``'s
    for one result: ``smem`` (``csrc/segment_splitk.cu``: block partials
    in shared memory, flushed into the output by atomics) where a block's
    partial fits, else ``global`` (``csrc/segment_aggregate.cu``: one
    thread an event, global atomics). ``design`` forces one (for
    measurements) and raises where it does not take the inputs. A
    sharded call's launch (``shard``) counts in ``launches_by_shard``."""
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
    if r == 0 or num_slots == 0 or values_arena.shape[1] == 0:
        return _identity(stats, (num_slots, num_segments), w_out,
                         values_arena.device)
    chosen = splitk_design(stats, num_slots * num_segments, w_out, design)
    if chosen == "smem":
        args, out, _keep = block_table_smem_launch(
            values_arena, segment_ids, table, num_segments, valid, slot_ids,
            num_slots, stats, num_cols)
        _lib("segment_splitk.cu").call("seg_agg_block_table_smem", *args)
    else:
        out, w_out = _block_table_launch(
            "seg_agg_block_table", values_arena, segment_ids, table,
            num_segments, valid, slot_ids, num_slots, stats, num_cols, 0, 1)
        out = _shape(out, (num_slots, num_segments), w_out)
    _count(segment_aggregate_block_table_cuda, chosen, shard)
    return out


segment_aggregate_block_table_cuda.launches = 0
segment_aggregate_block_table_cuda.launches_by_design = \
    dict.fromkeys(SPLITK_DESIGNS, 0)


def splitk_smem_launch(values_arena, segment_ids, table, num_segments: int,
                       chunk_rows: int, valid, slot_ids, num_slots: int,
                       stats, num_cols: Optional[int], merge: bool):
    """The checks, outputs, scratch and C arguments of one launch of K3's
    smem design (``seg_agg_splitk_smem``): returns (arguments, outputs,
    tensors the launch reads, to be kept alive until it is enqueued).
    ``stats`` must be normalized and ``slot_ids`` given."""
    dev = values_arena.device
    p, cap, w = values_arena.shape
    w_out = _check_arena(values_arena, num_cols)
    r = table.shape[0]
    tbl = _i32(table, (r,), dev, "table")
    ids = _i32(segment_ids, (r, cap), dev, "segment_ids")
    slots = _i32(slot_ids, (r,), dev, "slot_ids")
    ok = _valid_bytes(valid, (r, cap), dev)
    s_total = num_slots * num_segments
    k, per_chunk, per_block = splitk_plan(r, cap, chunk_rows)
    # one allocation (an allocation or a view costs the host more than
    # the device's fold): the outputs, each a view of it, then the
    # kernel's scratch: block partials, chunk partials, k + 1 int32
    # counters
    k_out = 1 if merge else k
    words = splitk_partial_bytes(stats, s_total, w_out) // 4
    buf = torch.empty((k_out + k * per_chunk + k) * words + k + 1,
                      dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    out, ptr, at = _stat_views(buf, stats, () if merge else (k,),
                               num_slots, num_segments, w_out, k_out)
    args = (values_arena.data_ptr(), p, cap, w, w_out, tbl.data_ptr(), r,
            ids.data_ptr(), slots.data_ptr(), _ptr(ok), num_segments,
            s_total, chunk_rows, k, per_chunk, per_block,
            sum(_STAT_BITS[s] for s in stats), int(merge), base + 4 * at,
            ptr["sum"], ptr["count"], ptr["min"], ptr["max"], raw_stream(dev))
    return args, out, (tbl, ids, slots, ok, buf)


def segment_aggregate_block_table_splitk_cuda(
        values_arena, segment_ids, table, num_segments: int,
        chunk_rows: int, valid=None, slot_ids=None,
        num_slots: Optional[int] = None,
        stats: Tuple[str, ...] = ALL_STATS,
        num_cols: Optional[int] = None, merge: bool = True,
        design: Optional[str] = None, shard: Optional[int] = None) -> dict:
    """K3: the K2 fold with the rows cut into chunks of ``chunk_rows``,
    chunk ``c`` folding into its own partial. ``merge=False`` returns the
    raw ``[k, num_slots, S(, W)]`` partials. ``design`` None takes
    ``splitk_design``'s choice; a name forces that design (for
    measurements) and raises where it does not take the inputs.
    ``shard`` as ``segment_aggregate_block_table_cuda``'s."""
    stats = norm_stats(stats)
    if not values_arena.is_cuda:
        return segment_aggregate_block_table_splitk_plain(
            values_arena, segment_ids, table, num_segments, chunk_rows,
            valid=valid, slot_ids=slot_ids, num_slots=num_slots,
            stats=stats, num_cols=num_cols, merge=merge)
    dev = values_arena.device
    w_out, r, slot_ids, num_slots = _splitk_prologue(
        values_arena, segment_ids, table, chunk_rows, valid, slot_ids,
        num_slots, num_cols)
    if r == 0 or num_slots == 0:
        return _splitk_empty(stats, num_slots, num_segments, w_out, merge,
                             dev)
    chosen = splitk_design(stats, num_slots * num_segments, w_out, design)
    if chosen == "smem":
        args, parts, _keep = splitk_smem_launch(
            values_arena, segment_ids, table, num_segments, chunk_rows,
            valid, slot_ids, num_slots, stats, num_cols, merge)
        _lib("segment_splitk.cu").call("seg_agg_splitk_smem", *args)
    else:
        # the K2 kernel on rows padded to a chunk multiple (inert rows:
        # pool slot 0, slot 0, valid 0), global atomics into the partials
        table, segment_ids, valid, slot_ids, k = _pad_rows(
            table, segment_ids,
            _all_valid(valid, r, values_arena.shape[1], dev).to(torch.bool),
            slot_ids, chunk_rows)
        out, w_out = _block_table_launch(
            "seg_agg_block_table_splitk", values_arena, segment_ids, table,
            num_segments, valid, slot_ids, num_slots, stats, num_cols,
            chunk_rows, k)
        parts = _shape(out, (k, num_slots, num_segments), w_out)
        if merge:
            parts = merge_partials(parts)
    _count(segment_aggregate_block_table_splitk_cuda, chosen, shard)
    return parts


segment_aggregate_block_table_splitk_cuda.launches = 0
segment_aggregate_block_table_splitk_cuda.launches_by_design = \
    dict.fromkeys(SPLITK_DESIGNS, 0)

#: the kernel wrappers whose ``launches`` the smoke run reads
KERNEL_WRAPPERS = (segment_aggregate_cuda,
                   segment_aggregate_block_table_cuda,
                   segment_aggregate_block_table_splitk_cuda)
for _fn in KERNEL_WRAPPERS:
    # shard -> {design: launches} of the sharded wrappers' calls
    _fn.launches_by_shard = {}


# ------------------------------------------------------- slot-sharded folds
def pack_rows_shard_major(slot_ids, num_devices: int, slots_per: int,
                          balance: bool = False) -> Tuple[list, int]:
    """Host-side row placement for the sharded fold.

    Default (ownership) mode groups row indices by owning shard
    (``slot // slots_per``) and picks the common power-of-two per-shard
    row count every shard pads to, so the ``[num_devices *
    rows_per_shard, ...]`` stack splits evenly over the mesh. Returns
    ``(per_shard_row_indices, rows_per_shard)``.

    ``balance=True`` ignores slot ownership and deals rows round-robin
    across shards — the split-K layout: a hot window's rows spread over
    every device instead of serializing on their owner. Only valid for
    ``segment_aggregate_batched_splitk_sharded``; the ownership-masked
    folds would drop balanced rows.
    """
    if balance:
        idx = np.arange(len(np.asarray(slot_ids)), dtype=np.int64)
        per = [idx[d::num_devices] for d in range(num_devices)]
    else:
        shard = np.asarray(slot_ids, np.int64) // max(slots_per, 1)
        per = [np.flatnonzero(shard == d) for d in range(num_devices)]
    rows_per_shard = next_pow2(max([len(p) for p in per] + [1]))
    return per, rows_per_shard


def _on_device(dev: torch.device):
    """Makes ``dev`` the current CUDA device (a kernel launches on a
    stream of the current device); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _shard_call(d: int, dev: torch.device, fn, *args, **kw):
    """Shard ``d``'s call of a kernel wrapper on ``dev``: its launch
    counts on the wrapper's ``launches_by_shard[d]``."""
    with _on_device(dev):
        return fn(*args, shard=d, **kw)


def _shard_rows(x: torch.Tensor, d: int, per: int, dev) -> torch.Tensor:
    """Rows ``[d * per, (d + 1) * per)`` of ``x`` on ``dev`` (no copy where
    they are there; an asynchronous copy to another device)."""
    return x[d * per:(d + 1) * per].to(dev, non_blocking=True)


def _owned(slots: torch.Tensor, base: int, size: int):
    """(local index, owned): ``slots - base`` where it falls in ``[0,
    size)``, else 0, and whether it did."""
    local = slots.to(torch.int32) - base
    own = (local >= 0) & (local < size)
    return torch.where(own, local, 0), own


def _concat(outs: list, dev: torch.device) -> dict:
    """The shards' outputs concatenated along the slot axis on ``dev``."""
    return {s: torch.cat([o[s].to(dev, non_blocking=True) for o in outs])
            for s in outs[0]}


def _valid_rows(valid, shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.bool, device=device) \
        if valid is None else valid.to(torch.bool)


def arena_tiles(values_arena, mesh) -> list:
    """The arena's per-shard tiles: a tensor splits into ``mesh.size``
    views along the pool axis, a sequence is taken as the tiles. Tile
    ``d`` must lie on ``mesh.devices[d]``."""
    tiles = list(values_arena.chunk(mesh.size)) \
        if isinstance(values_arena, torch.Tensor) else list(values_arena)
    if len(tiles) != mesh.size or len({t.shape for t in tiles}) != 1:
        raise ValueError(f"the arena must split into {mesh.size} equal "
                         "tiles, one for each mesh entry")
    for d, (t, dev) in enumerate(zip(tiles, mesh.devices)):
        if t.device.type != dev.type or None not in (
                t.device.index, dev.index) and t.device.index != dev.index:
            raise ValueError(f"arena tile {d} is on {t.device}, its mesh "
                             f"entry is {dev}")
    return tiles


def segment_aggregate_block_table_sharded(
        values_arena, segment_ids: torch.Tensor, table: torch.Tensor,
        num_segments: int, valid: Optional[torch.Tensor] = None,
        slot_ids: Optional[torch.Tensor] = None,
        num_slots: Optional[int] = None, *, mesh,
        stats: Tuple[str, ...] = ALL_STATS,
        num_cols: Optional[int] = None, chunk_rows: int = 0) -> dict:
    """Slot-sharded block-table fold over a 1-D ``SlotMesh``.

    Both the pool arena (slot axis) and the table rows partition across
    the mesh: shard ``d`` gets arena tile ``d`` (``values_arena`` is the
    whole arena, split into views, or the sequence of tiles) and its
    shard-major rows, and rewrites global pool slots / window slots to
    shard-local indices — the block table stays local to each shard, so
    the kernel never reads another device's tile and the output is a
    slot-axis concatenation. A misplaced row (table entry or window slot
    outside the shard's ranges) is masked invalid. K2 runs on each
    shard, or K3 where ``chunk_rows > 0`` (per-shard chunks, merged on
    the shard's device)."""
    stats = norm_stats(stats)
    num_devices = mesh.size
    p = values_arena.shape[0] if isinstance(values_arena, torch.Tensor) \
        else sum(t.shape[0] for t in values_arena)
    r = table.shape[0]
    slot_ids, num_slots = _slots(slot_ids, num_slots, r, table.device)
    if r % num_devices or num_slots % num_devices or p % num_devices:
        raise ValueError(
            f"rows ({r}), slots ({num_slots}) and pool slots ({p}) must "
            f"all divide the slot mesh ({num_devices} devices); pad with "
            "invalid rows (pack_rows_shard_major) and size the pool to "
            "the mesh")
    tiles = arena_tiles(values_arena, mesh)
    pool_per, cap = tiles[0].shape[0], tiles[0].shape[1]
    slots_per = num_slots // num_devices
    rows_per = r // num_devices
    valid = _valid_rows(valid, (r, cap), table.device)
    outs = []
    for d, (tile, dev) in enumerate(zip(tiles, mesh.devices)):
        local_tbl, own_t = _owned(_shard_rows(table, d, rows_per, dev),
                                  d * pool_per, pool_per)
        local_sl, own_s = _owned(_shard_rows(slot_ids, d, rows_per, dev),
                                 d * slots_per, slots_per)
        ok = _shard_rows(valid, d, rows_per, dev) & (own_t & own_s)[:, None]
        ids = _shard_rows(segment_ids, d, rows_per, dev)
        kw = dict(valid=ok, slot_ids=local_sl, num_slots=slots_per,
                  stats=stats, num_cols=num_cols)
        if chunk_rows > 0:
            outs.append(_shard_call(
                d, dev, segment_aggregate_block_table_splitk_cuda, tile, ids,
                local_tbl, num_segments, chunk_rows, **kw))
        else:
            outs.append(_shard_call(
                d, dev, segment_aggregate_block_table_cuda, tile, ids,
                local_tbl, num_segments, **kw))
    return _concat(outs, mesh.devices[0])


def segment_aggregate_batched_sharded(
        values: torch.Tensor, segment_ids: torch.Tensor,
        num_segments: int, valid: Optional[torch.Tensor] = None,
        slot_ids: Optional[torch.Tensor] = None,
        num_slots: Optional[int] = None, *, mesh,
        stats: Tuple[str, ...] = ALL_STATS) -> dict:
    """Slot-sharded stacked fold (K1 on each shard) over a 1-D mesh.

    Rows are **shard-major** — row ``r`` belongs to shard ``r // (B /
    D)``, and its (global) slot must fall in that shard's range ``[d *
    slots_per, (d + 1) * slots_per)`` (``pack_rows_shard_major`` produces
    this layout). Each shard reduces its own rows into its own slot
    tile; the tiles are disjoint, so the output is a concatenation along
    the slot axis. Misplaced rows are masked invalid inside the shard
    instead of aliasing into a resident slot."""
    stats = norm_stats(stats)
    b, n, _ = values.shape
    num_devices = mesh.size
    slot_ids, num_slots = _slots(slot_ids, num_slots, b, values.device)
    if b % num_devices or num_slots % num_devices:
        raise ValueError(
            f"rows ({b}) and slots ({num_slots}) must both divide the slot "
            f"mesh ({num_devices} devices); pad with invalid rows / unused "
            "slots (pack_rows_shard_major)")
    slots_per = num_slots // num_devices
    rows_per = b // num_devices
    valid = _valid_rows(valid, (b, n), values.device)
    outs = []
    for d, dev in enumerate(mesh.devices):
        local, own = _owned(_shard_rows(slot_ids, d, rows_per, dev),
                            d * slots_per, slots_per)
        outs.append(_shard_call(
            d, dev, segment_aggregate_batched_cuda,
            _shard_rows(values, d, rows_per, dev),
            _shard_rows(segment_ids, d, rows_per, dev), num_segments,
            valid=_shard_rows(valid, d, rows_per, dev) & own[:, None],
            slot_ids=local, num_slots=slots_per, stats=stats))
    return _concat(outs, mesh.devices[0])


def segment_aggregate_batched_splitk_sharded(
        values: torch.Tensor, segment_ids: torch.Tensor,
        num_segments: int, valid: Optional[torch.Tensor] = None,
        slot_ids: Optional[torch.Tensor] = None,
        num_slots: Optional[int] = None, *, mesh,
        stats: Tuple[str, ...] = ALL_STATS) -> dict:
    """Row-balanced (split-K) sharded fold over a 1-D mesh.

    Rows are dealt across the mesh with no slot-ownership precondition
    (``pack_rows_shard_major(..., balance=True)``), each shard folds its
    rows (K1) into a **full** ``[num_slots, S, ...]`` partial, and the D
    partials merge through each stat's identity on ``mesh.devices[0]``
    (``merge_partials``). A Zipf-hot window's rows fold on every device
    instead of serializing on its owner. ``num_slots`` need not divide
    the mesh — only the row count must. Only safe for operators whose
    batch fold reduces through plain per-slot accumulators."""
    stats = norm_stats(stats)
    b, n, _ = values.shape
    num_devices = mesh.size
    slot_ids, num_slots = _slots(slot_ids, num_slots, b, values.device)
    if b % num_devices:
        raise ValueError(
            f"rows ({b}) must divide the slot mesh ({num_devices} "
            "devices); pad with invalid rows "
            "(pack_rows_shard_major(balance=True))")
    rows_per = b // num_devices
    valid = _valid_rows(valid, (b, n), values.device)
    dev0 = mesh.devices[0]
    parts = []
    for d, dev in enumerate(mesh.devices):
        part = _shard_call(
            d, dev, segment_aggregate_batched_cuda,
            _shard_rows(values, d, rows_per, dev),
            _shard_rows(segment_ids, d, rows_per, dev), num_segments,
            valid=_shard_rows(valid, d, rows_per, dev),
            slot_ids=_shard_rows(slot_ids, d, rows_per, dev),
            num_slots=num_slots, stats=stats)
        parts.append({s: v.to(dev0, non_blocking=True)
                      for s, v in part.items()})
    return merge_partials({s: torch.stack([p[s] for p in parts])
                           for s in stats})
