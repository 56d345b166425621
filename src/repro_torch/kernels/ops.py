"""Public kernel entry points with backend dispatch.

``backend``:
  'auto'  the CUDA kernel for a tensor on the card, its plain torch
          version for a tensor on the CPU (the wrapper decides by the
          tensor's device; on the card it launches the kernel or raises)
  'ref'   the plain-torch version of each kernel, the ``*_plain``
          function of its module (which CPU tensors take as well)

Inputs may be tensors or array-likes. The folds run on the values'
device, attention on the K/V's, the SSD scan on xdt's; array-likes go
there, or to ``device``, which defaults to the card. The empty-batch guards return the fold identity
without a launch. ``mesh`` (a ``SlotMesh`` of two or more entries) routes
the folds through their slot-sharded variants (``*_sharded`` in
``kernels/segment_aggregate.py``); the ``'ref'`` backend ignores it, as
the unsharded oracle the sharded path is held against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch.kernels.decode_attention import (
    decode_attention_paged_cuda, decode_attention_paged_plain,
)
from repro_torch.kernels.flash_attention import (
    _FlashForward, flash_attention_cuda, flash_attention_plain,
)
from repro_torch.kernels.segment_aggregate import (
    ALL_STATS, empty_batch_identity as _empty_batch_identity,
    norm_stats as _norm_stats, segment_aggregate_batched_cuda,
    segment_aggregate_batched_plain, segment_aggregate_block_table_cuda,
    segment_aggregate_block_table_plain,
    segment_aggregate_block_table_sharded,
    segment_aggregate_block_table_splitk_cuda,
    segment_aggregate_block_table_splitk_plain, segment_aggregate_cuda,
    segment_aggregate_batched_sharded,
    segment_aggregate_batched_splitk_sharded, segment_aggregate_plain,
)
from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain
from repro_torch.obs import lm

BACKENDS = ("auto", "ref")


def _device_of(x, device) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _opt(x, dev, dtype):
    return None if x is None else as_tensor(x, dev, dtype)


def _identity(ns: int, num_segments: int, w: int, dev, stats) -> dict:
    out = _empty_batch_identity(ns, num_segments, w, dev)
    return {k: v for k, v in out.items() if k in stats}


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (of {BACKENDS})")


def _sharded(backend: str, mesh) -> bool:
    """Whether a fold takes its slot-sharded variant: a mesh of two or
    more entries, and not the ``'ref'`` oracle, which ignores it."""
    return mesh is not None and backend != "ref" and mesh.size > 1


def segment_aggregate(values, segment_ids, num_segments: int, valid=None,
                      backend: str = "auto",
                      stats: tuple = ALL_STATS, device=None):
    """values [N, W], segment_ids [N] -> per-segment stats (K1)."""
    _check(backend)
    stats = _norm_stats(stats)
    dev = _device_of(values, device)
    values = as_tensor(values, dev, torch.float32)
    segment_ids = as_tensor(segment_ids, dev, torch.int32)
    valid = _opt(valid, dev, torch.bool)
    if backend == "ref":
        return segment_aggregate_plain(values, segment_ids, num_segments,
                                       valid=valid, stats=stats)
    return segment_aggregate_cuda(values, segment_ids, num_segments,
                                  valid=valid, stats=stats)


def segment_aggregate_batched(values, segment_ids, num_segments: int,
                              valid=None, slot_ids=None,
                              num_slots: Optional[int] = None,
                              backend: str = "auto",
                              stats: tuple = ALL_STATS, mesh=None,
                              device=None, splitk: int = 0):
    """Batched multi-window reduce-by-key: values [B, N, W], ids [B, N],
    slot_ids [B] -> aggregates [num_slots, num_segments, ...] in one K1
    launch through composite ids.

    ``mesh`` shards the fold by slot (``segment_aggregate_batched_sharded``:
    rows shard-major, one K1 launch per shard); with ``splitk > 0`` it
    takes the row-balanced variant instead
    (``segment_aggregate_batched_splitk_sharded``: rows dealt across the
    shards, D full partials merged), which only operators with
    ``supports_splitk`` may ask for. Without a mesh ``splitk`` is a no-op
    here (single-device chunking lives on the block-table path)."""
    _check(backend)
    stats = _norm_stats(stats)
    dev = _device_of(values, device)
    values = as_tensor(values, dev, torch.float32)
    b = values.shape[0]
    ns = num_slots if num_slots is not None else \
        (b if slot_ids is None else None)
    if ns is None:
        raise ValueError("num_slots is required when slot_ids is given")
    if b == 0 or ns == 0:
        return _identity(ns, num_segments, values.shape[2], dev, stats)
    segment_ids = as_tensor(segment_ids, dev, torch.int32)
    valid = _opt(valid, dev, torch.bool)
    slot_ids = _opt(slot_ids, dev, torch.int32)
    if _sharded(backend, mesh):
        fold = segment_aggregate_batched_splitk_sharded if splitk > 0 \
            else segment_aggregate_batched_sharded
        return fold(values, segment_ids, num_segments, valid=valid,
                    slot_ids=slot_ids, num_slots=ns, mesh=mesh,
                    stats=stats)
    if backend == "ref":
        return segment_aggregate_batched_plain(
            values, segment_ids, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots, stats=stats)
    return segment_aggregate_batched_cuda(
        values, segment_ids, num_segments, valid=valid, slot_ids=slot_ids,
        num_slots=num_slots, stats=stats)


def _arena_width(values_arena) -> int:
    tile = values_arena[0] if isinstance(values_arena, tuple) \
        else values_arena
    return tile.shape[-1]


def _table_args(values_arena, segment_ids, table, valid, slot_ids, device,
                sharded: bool):
    """The block-table folds' arguments as tensors on the arena's device.
    A sharded pool's arena on several devices comes as the sequence of
    its per-shard tiles: the sharded fold takes them as they are, any
    other path concatenates them on the first tile's device."""
    if isinstance(values_arena, (list, tuple)):
        dev = values_arena[0].device
        values_arena = tuple(values_arena) if sharded else torch.cat(
            [t.to(dev) for t in values_arena])
    else:
        dev = _device_of(values_arena, device)
        values_arena = as_tensor(values_arena, dev, torch.float32)
    return (dev, values_arena,
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
    leading value columns. ``mesh`` shards the fold by slot: the arena
    (or the sequence of its per-shard tiles) and the table partition
    across the mesh, one K2 launch per shard on its own tile
    (``segment_aggregate_block_table_sharded``)."""
    _check(backend)
    stats = _norm_stats(stats)
    dev, values_arena, segment_ids, table, valid, slot_ids = _table_args(
        values_arena, segment_ids, table, valid, slot_ids, device,
        _sharded(backend, mesh))
    r = table.shape[0]
    ns = num_slots if num_slots is not None else \
        (r if slot_ids is None else None)
    if ns is None:
        raise ValueError("num_slots is required when slot_ids is given")
    if r == 0 or ns == 0:
        w_out = num_cols if num_cols is not None \
            else _arena_width(values_arena)
        return _identity(ns, num_segments, w_out, dev, stats)
    if _sharded(backend, mesh):
        return segment_aggregate_block_table_sharded(
            values_arena, segment_ids, table, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots, mesh=mesh,
            stats=stats, num_cols=num_cols)
    if backend == "ref":
        return segment_aggregate_block_table_plain(
            values_arena, segment_ids, table, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots, stats=stats,
            num_cols=num_cols)
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
    the device. ``'ref'`` is the chunk-looped oracle. ``mesh`` shards the
    fold as ``segment_aggregate_block_table`` does, each shard's rows
    through K3."""
    _check(backend)
    stats = _norm_stats(stats)
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    dev, values_arena, segment_ids, table, valid, slot_ids = _table_args(
        values_arena, segment_ids, table, valid, slot_ids, device,
        _sharded(backend, mesh))
    r = table.shape[0]
    ns = num_slots if num_slots is not None else \
        (r if slot_ids is None else None)
    if ns is None:
        raise ValueError("num_slots is required when slot_ids is given")
    if r == 0 or ns == 0:
        w_out = num_cols if num_cols is not None \
            else _arena_width(values_arena)
        return _identity(ns, num_segments, w_out, dev, stats)
    if _sharded(backend, mesh):
        return segment_aggregate_block_table_sharded(
            values_arena, segment_ids, table, num_segments, valid=valid,
            slot_ids=slot_ids, num_slots=num_slots, mesh=mesh,
            stats=stats, num_cols=num_cols, chunk_rows=chunk_rows)
    if backend == "ref":
        return segment_aggregate_block_table_splitk_plain(
            values_arena, segment_ids, table, num_segments, chunk_rows,
            valid=valid, slot_ids=slot_ids, num_slots=num_slots,
            stats=stats, num_cols=num_cols)
    return segment_aggregate_block_table_splitk_cuda(
        values_arena, segment_ids, table, num_segments, chunk_rows,
        valid=valid, slot_ids=slot_ids, num_slots=num_slots, stats=stats,
        num_cols=num_cols)


# ------------------------------------------------------------- attention
def _kv_device(kv, device) -> torch.device:
    """Where attention runs: on the K/V (the pool, for decode), which is
    never moved; ``device`` places them when they are array-likes."""
    if not isinstance(kv, torch.Tensor):
        return resolve_device(device)
    if device is not None:
        want = torch.device(device)
        if want.type != kv.device.type or (
                want.index is not None and want.index != kv.device.index):
            raise ValueError(f"device {want} asked for, the K/V are on "
                             f"{kv.device}")
    return kv.device


def _on(x, dev: torch.device, name: str, dtype=None) -> torch.Tensor:
    """``x`` on the K/V's device: an array-like is put there, and a tensor
    on another device raises rather than drawing the K/V after it."""
    if isinstance(x, torch.Tensor) and x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the K/V on {dev}")
    return as_tensor(x, dev, dtype)


def _lengths(kv_valid_len, dev: torch.device):
    """A per-row key length as the kernels take it: int32 on the K/V's
    device (None stays None)."""
    if kv_valid_len is None:
        return None
    return _on(kv_valid_len, dev, "kv_valid_len", torch.int32).contiguous()


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    backend: str = "auto", block_q: int = 512,
                    block_k: int = 512, device=None, *, kv_valid_len=None):
    """Attention forward (K5): q [B, Sq, H, D], k/v [B, Sk, Hkv, D] ->
    [B, Sq, H, D], on k's device (``device`` places array-likes; q, v or
    the lengths on another device raise). ``kv_valid_len`` [B]: each
    row's count of valid keys (``blocked_attention``'s padding mask), put
    to int32. ``block_q`` and ``block_k`` are the JAX entry point's
    Pallas tile sizes, accepted for signature parity and read by neither
    path here: the CUDA kernels tile by their own sizes
    (``kernels/flash_tiles.py``), and the plain version does not tile."""
    _check(backend)
    dev = _kv_device(k, device)
    k = _on(k, dev, "k")
    q, v = _on(q, dev, "q"), _on(v, dev, "v")
    lens = _lengths(kv_valid_len, dev)
    if backend == "ref":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_valid_len=lens)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                kv_valid_len=lens)


def flash_attention_vjp(q, k, v, causal: bool = True, window: int = 0,
                        block_q: int = 512, block_k: int = 512,
                        backend: str = "auto", device=None, *,
                        kv_valid_len=None):
    """Attention differentiable in q, k and v (K5 forward, K6 backward):
    q [B, Sq, H, D], k/v [B, Sk, Hkv, D] -> [B, Sq, H, D], on k's device
    (``device`` places array-likes; q, v or the lengths on another device
    raise). ``kv_valid_len`` [B]: each row's count of valid keys, as
    ``flash_attention`` takes it; it gets no gradient, and a key past its
    row's length gets a gradient of exactly 0.
    Neither pass materializes the [Sq, Sk] probabilities on the card.
    ``backend="ref"`` takes both passes' plain versions on any device.

    ``block_q`` and ``block_k`` are the JAX entry point's Pallas tile
    sizes, accepted for signature parity and read by neither path: K5 and
    K6 tile by their own sizes (``kernels/flash_tiles.py``), and the plain
    versions do not tile. The JAX ``interpret`` argument (run the Pallas
    kernels in the interpreter) has no counterpart: a CPU tensor takes the
    plain versions, and a CUDA tensor the kernels. Its span is
    ``kernel.k5``."""
    _check(backend)
    with lm.span("kernel.k5"):
        dev = _kv_device(k, device)
        k = _on(k, dev, "k")
        q, v = _on(q, dev, "q"), _on(v, dev, "v")
        o, _ = _FlashForward.apply(q, k, v, bool(causal), int(window),
                                   False, backend == "ref", None,
                                   _lengths(kv_valid_len, dev))
        return o


def decode_attention_paged(q, k_pages, v_pages, block_table, seq_lens,
                           backend: str = "auto", device=None):
    """Paged decode attention (K4): q [B, H, D], k/v_pages
    [P, page, Hkv, D], block_table [B, pages_per_seq] (-1 = not
    resident), seq_lens [B] -> [B, H, D], on the pool's device (``device``
    places array-likes; q, the table or the lengths on another device
    raise: the pool is never copied)."""
    _check(backend)
    dev = _kv_device(k_pages, device)
    k_pages = _on(k_pages, dev, "k_pages")
    q, v_pages = _on(q, dev, "q"), _on(v_pages, dev, "v_pages")
    block_table = _on(block_table, dev, "block_table", torch.int32)
    seq_lens = _on(seq_lens, dev, "seq_lens", torch.int32)
    if backend == "ref":
        return decode_attention_paged_plain(q, k_pages, v_pages,
                                            block_table, seq_lens)
    return decode_attention_paged_cuda(q, k_pages, v_pages, block_table,
                                       seq_lens)


def ssd_chunk_scan(xdt, a, B, C, chunk: int = 256, head_block: int = 8,
                   backend: str = "auto", device=None):
    """The Mamba-2 SSD chunk scan (K7) from a zero state: xdt [b, s, h, p]
    (x * dt), a [b, s, h] (dt * A), B, C [b, s, n] -> y [b, s, h, p] in
    xdt's type, on xdt's device (``device`` places array-likes). ``a`` is
    taken as float32.

    ``head_block`` is the JAX entry point's Pallas block of heads,
    accepted for signature parity and read by neither path. The JAX
    kernel asserts ``s % chunk == 0`` (for s above the chunk); here the
    kernel tiles by its own 64 tokens and the plain version by ``chunk``,
    and both mask a ragged tail, so any length works (ROADMAP Queue 3)."""
    _check(backend)
    dev = _device_of(xdt, device)
    xdt = as_tensor(xdt, dev)
    a = as_tensor(a, dev, torch.float32)
    B, C = as_tensor(B, dev, xdt.dtype), as_tensor(C, dev, xdt.dtype)
    if backend == "ref":
        return ssd_scan_plain(xdt, a, B, C, chunk=chunk)[0]
    return ssd_scan_cuda(xdt.contiguous(), a.contiguous(), B.contiguous(),
                         C.contiguous(), chunk=chunk)[0]
