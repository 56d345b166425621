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
against. The multi-device wrappers of the JAX package, and their row
placement (``pack_rows_shard_major``), are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def _count_k1(design: str) -> None:
    segment_aggregate_cuda.launches += 1
    segment_aggregate_cuda.launches_by_design[design] += 1


def segment_aggregate_cuda(values: torch.Tensor, segment_ids: torch.Tensor,
                           num_segments: int,
                           valid: Optional[torch.Tensor] = None,
                           stats: Tuple[str, ...] = ALL_STATS,
                           design: Optional[str] = None) -> dict:
    """K1: flat reduce-by-key. values [N, W] float32 (rows may be strided,
    columns contiguous), segment_ids [N], valid [N] -> dict of [S, W] /
    [S] stats. Its design is ``splitk_design``'s: ``smem``
    (``seg_agg_flat_smem`` in ``csrc/segment_splitk.cu``: block partials
    in shared memory flushed into the output by atomics) where a block's
    partial fits, else ``global`` (``seg_agg_flat``). ``design`` forces
    one (for measurements) and raises where it does not take the inputs.
    Launches count on this wrapper, by design in ``launches_by_design``,
    whichever K1 wrapper launched. A CPU tensor takes
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
    _count_k1(chosen)
    return out


segment_aggregate_cuda.launches = 0
segment_aggregate_cuda.launches_by_design = dict.fromkeys(SPLITK_DESIGNS, 0)


def segment_aggregate_batched_cuda(values, segment_ids, num_segments: int,
                                   valid=None, slot_ids=None,
                                   num_slots: Optional[int] = None,
                                   stats: Tuple[str, ...] = ALL_STATS,
                                   design: Optional[str] = None) -> dict:
    """Many windows in ONE K1 launch: values [B, N, W], ids [B, N],
    slot_ids [B] -> [num_slots, S(, W)] through composite segment ids
    ``slot * S + key``: made inside the kernel on the smem design, here
    on the global one. ``design`` as ``segment_aggregate_cuda``'s."""
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
    _count_k1(chosen)
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
                                       design: Optional[str] = None
                                       ) -> dict:
    """K2: fold over the block pool, reading each row's tile from the
    arena inside the kernel. values_arena [P, cap, W] float32, table [R]
    pool slots, segment_ids / valid [R, cap], slot_ids [R] -> per-slot
    stats [num_slots, S(, num_cols)]. Its design is ``splitk_design``'s
    for one result: ``smem`` (``csrc/segment_splitk.cu``: block partials
    in shared memory, flushed into the output by atomics) where a block's
    partial fits, else ``global`` (``csrc/segment_aggregate.cu``: one
    thread an event, global atomics). ``design`` forces one (for
    measurements) and raises where it does not take the inputs."""
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
    segment_aggregate_block_table_cuda.launches += 1
    segment_aggregate_block_table_cuda.launches_by_design[chosen] += 1
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
        design: Optional[str] = None) -> dict:
    """K3: the K2 fold with the rows cut into chunks of ``chunk_rows``,
    chunk ``c`` folding into its own partial. ``merge=False`` returns the
    raw ``[k, num_slots, S(, W)]`` partials. ``design`` None takes
    ``splitk_design``'s choice; a name forces that design (for
    measurements) and raises where it does not take the inputs."""
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
    segment_aggregate_block_table_splitk_cuda.launches += 1
    segment_aggregate_block_table_splitk_cuda.launches_by_design[chosen] += 1
    return parts


segment_aggregate_block_table_splitk_cuda.launches = 0
segment_aggregate_block_table_splitk_cuda.launches_by_design = \
    dict.fromkeys(SPLITK_DESIGNS, 0)

#: the kernel wrappers whose ``launches`` the smoke run reads
KERNEL_WRAPPERS = (segment_aggregate_cuda,
                   segment_aggregate_block_table_cuda,
                   segment_aggregate_block_table_splitk_cuda)
