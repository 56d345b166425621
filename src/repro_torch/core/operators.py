"""Windowed operators: the paper's evaluation workloads as block folds.

Operators consume window state *block by block* from the m-bucket (lazy
iteration): non-blocking operators fold incrementally so compute overlaps
staging; blocking operators (§3.3) must see the whole window before
finalizing. Folds are plain functions on tensors, run eagerly on the
operator's device (``make_operator(..., device=None)`` is the card).

  average      non-blocking  mean of a stream of numbers
  bigrams      non-blocking  co-occurrence counts over token payloads
                             (2-3 orders more compute, like the paper)
  stock        non-blocking  per-symbol rolling min/max/mean + 5% alerts
  lrb          non-blocking  Linear Road: per-segment vehicle counts, avg
                             speed, accident detection -> toll
  percentile   BLOCKING      exact percentiles (needs the full window)

Batched contract: operators may additionally implement ``fold_batch`` /
``finalize_batch`` — a vectorized path that folds the blocks of MANY
windows in one device pass by reducing over composite ``(window_slot,
key)`` segment ids through the batched segment-aggregate kernels.
All five operators implement it — including the blocking ``percentile``,
whose accumulator is a per-slot sorted run merged by sorted-merge.

  fold_batch(data, fills, slots, num_slots, mesh=None, table=None,
             splitk=0) -> acc
      data   table is None: {"keys": [B, cap] i32, "values": [B, cap, W]
             f32} — B stacked blocks, padded.
             table given: the persistent pool ARENAS — {"keys":
             [pool_slots, cap] i32, "values": [pool_slots, cap, W] f32};
             rows are *referenced* by the table, never stacked.
             Timestamps are deliberately NOT part of either layout: no
             batch fold is time-dependent within a window.
      fills  [B] i32   valid events per block (ragged fills)
      slots  [B] i32   block row -> window slot (several blocks of one
                       window share a slot)
      mesh   optional ``SlotMesh`` (``distributed.sharding``): the fold
             runs slot-sharded, one kernel launch per shard on its device
             (rows shard-major, or with ``splitk`` on the stacked layout
             row-balanced). With a sharded pool across devices the
             arenas come as the tuples of per-shard tiles.
      table  optional [B] i32 pool-slot indices (the block-table path):
             the keyed folds read the event tiles straight out of the
             arena inside the CUDA kernel (zero per-batch copies)
      splitk optional chunk size: > 0 routes block-table folds through
             the split-K kernel (fixed-shape chunks of ``splitk`` rows,
             per-chunk partials merged on the device). Operators whose
             fold cannot reduce into plain per-slot partials ignore it
             and declare ``supports_splitk=False``.
  finalize_batch(acc, num_slots) -> [per-window result] * num_slots
      element i is equal (up to float assoc.) to the per-window
      ``finalize(fold(...))`` over slot i's blocks.
  merge_acc(a, b) -> acc
      combines two partial batch accumulators over the SAME slot layout
      (the executor's resident + demand-filled tables, split-K launch
      groups, the stacked fallback). Default (``default_merge_acc``):
      'min' -> elementwise minimum, 'max' -> maximum, everything else
      adds. Percentile's sorted runs override it (concatenate + re-sort).

Each ``fold_batch`` carries ``launch_shapes``, the set of distinct launch
shapes it has run (rows, slots, split-K, table or stacked, shards): PyTorch
compiles nothing per shape, so this count stands where the JAX package
read its jit cache size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device, to_numpy

INF = float("inf")


def default_merge_acc(a: Dict[str, Any], b: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Combine two partial batch accumulators (dicts of per-slot tensors):
    'min' -> elementwise minimum, 'max' -> maximum (both propagate NaN),
    everything else adds."""
    out = {}
    for k in a:
        if k == "min":
            out[k] = torch.minimum(a[k], b[k])
        elif k == "max":
            out[k] = torch.maximum(a[k], b[k])
        else:
            out[k] = a[k] + b[k]
    return out


@dataclass
class WindowOperator:
    name: str
    blocking: bool
    init_acc: Callable[[], Any]
    fold: Callable[[Any, Dict[str, Any], Any], Any]
    finalize: Callable[[Any], Any]
    # vectorized multi-window contract (see module docstring); None ->
    # the engine falls back to per-window execution for this operator
    fold_batch: Optional[Callable[..., Any]] = None
    finalize_batch: Optional[Callable[[Any, int], list]] = None
    # partial-accumulator combine; None -> ``default_merge_acc``
    merge: Optional[Callable[[Any, Any], Any]] = None
    # split-K safety: True when fold_batch reduces into plain per-slot
    # partial accumulators, so rows may be chunked arbitrarily and
    # partials merged via merge_acc
    supports_splitk: bool = False

    @property
    def supports_batch(self) -> bool:
        return self.fold_batch is not None and \
            self.finalize_batch is not None

    def merge_acc(self, a: Any, b: Any) -> Any:
        if self.merge is not None:
            return self.merge(a, b)
        return default_merge_acc(a, b)

    def run(self, blocks, fills) -> Any:
        """Reference path: fold over (block_data, fill) pairs."""
        acc = self.init_acc()
        for data, fill in zip(blocks, fills):
            acc = self.fold(acc, data, fill)
        return self.finalize(acc)

    def run_batch(self, data, fills, slots, num_slots: int,
                  mesh=None, table=None, splitk: int = 0) -> list:
        """Batched path: one device pass over the blocks of many windows;
        returns one finalized result per slot."""
        if not self.supports_batch:
            raise TypeError(f"operator {self.name!r} has no batch contract")
        acc = self.fold_batch(data, fills, slots, num_slots, mesh=mesh,
                              table=table, splitk=splitk)
        return self.finalize_batch(acc, num_slots)


def _batch_fold(dev: torch.device):
    """Decorator for a ``fold_batch``: records its launch shapes, and hands
    the body the arrays as tensors on ``dev`` (or on the device of the
    tensors it was given; per-shard arena tiles stay where they are, the
    rest goes to the first tile's device)."""
    def wrap(body):
        shapes = set()

        def fold_batch(data, fills, slots, num_slots, mesh=None,
                       table=None, splitk=0):
            vals = data["values"]
            if isinstance(vals, tuple):
                d = vals[0].device
            else:
                d = vals.device if isinstance(vals, torch.Tensor) else dev
                data = {k: as_tensor(v, d) for k, v in data.items()}
            fills = as_tensor(fills, d, torch.int32)
            slots = as_tensor(slots, d, torch.int32)
            if table is not None:
                table = as_tensor(table, d, torch.int32)
            rows = len(fills)
            shapes.add((rows, num_slots, splitk, table is None,
                        mesh.size if mesh is not None else 1))
            return body(data, fills, slots, num_slots, mesh=mesh,
                        table=table, splitk=splitk)

        fold_batch.launch_shapes = shapes
        return fold_batch
    return wrap


def _valid_mask(n: int, fill, dev) -> torch.Tensor:
    return torch.arange(n, device=dev) < int(fill)


def _batch_valid(cap: int, fills: torch.Tensor) -> torch.Tensor:
    """[B, cap] ragged-fill mask from per-block fills."""
    return torch.arange(cap, device=fills.device)[None, :] < fills[:, None]


def _take_rows(arena, table: torch.Tensor) -> torch.Tensor:
    """The arena rows ``table`` names, on the table's device. ``arena``
    is one tensor, or a sharded pool's per-shard tiles: each row then
    comes from the tile that holds it."""
    idx = table.to(torch.int64)
    if isinstance(arena, torch.Tensor):
        return arena.index_select(0, idx)
    per = arena[0].shape[0]
    out = None
    for d, tile in enumerate(arena):
        local = idx - d * per
        own = (local >= 0) & (local < per)
        rows = tile.index_select(0, torch.where(own, local, 0).to(
            tile.device)).to(table.device)
        own = own.view(-1, *([1] * (rows.dim() - 1)))
        out = rows if out is None else torch.where(own, rows, out)
    return out


def _cap(values) -> int:
    """Events a block holds: the arena's (or a tile's) second axis."""
    return (values[0] if isinstance(values, tuple) else values).shape[1]


def _per_slot_finalize(finalize: Callable[[Any], Any]):
    """finalize_batch from a per-window finalize: copy the batched acc
    (dict of [num_slots, ...] tensors) to the host once, slice per slot
    and finalize each."""
    def finalize_batch(acc, num_slots):
        acc = {k: to_numpy(v) for k, v in acc.items()}
        return [finalize({k: v[i] for k, v in acc.items()})
                for i in range(num_slots)]
    return finalize_batch


# ------------------------------------------------------------------ average

def make_average(block_capacity: int, width: int,
                 device=None) -> WindowOperator:
    from repro_torch.kernels import (
        segment_aggregate_batched, segment_aggregate_block_table,
        segment_aggregate_block_table_splitk,
    )
    dev = resolve_device(device)

    def init_acc():
        return {"sum": torch.zeros((), device=dev),
                "count": torch.zeros((), device=dev)}

    def fold(acc, data, fill):
        vals = as_tensor(data["values"], dev, torch.float32)
        mask = _valid_mask(vals.shape[0], fill, dev)
        v = torch.where(mask, vals[:, 0], 0.0)
        return {"sum": acc["sum"] + v.sum(),
                "count": acc["count"] + mask.sum(dtype=torch.float32)}

    def finalize(acc):
        return float(acc["sum"] / torch.clamp(acc["count"], min=1.0))

    @_batch_fold(dev)
    def fold_batch(data, fills, slots, num_slots, mesh=None, table=None,
                   splitk=0):
        cap = _cap(data["values"])
        valid = _batch_valid(cap, fills)
        zeros = torch.zeros((len(fills), cap), dtype=torch.int32,
                            device=valid.device)
        # single segment per window: the composite id IS the slot
        if table is not None:
            # full arena + num_cols: the width-1 selection happens inside
            # the kernel's row read, never as an arena-wide slice copy
            if splitk > 0:
                out = segment_aggregate_block_table_splitk(
                    data["values"], zeros, table, 1, splitk, valid=valid,
                    slot_ids=slots, num_slots=num_slots,
                    stats=("sum", "count"), mesh=mesh, num_cols=1)
            else:
                out = segment_aggregate_block_table(
                    data["values"], zeros, table, 1, valid=valid,
                    slot_ids=slots, num_slots=num_slots,
                    stats=("sum", "count"), mesh=mesh, num_cols=1)
        else:
            out = segment_aggregate_batched(
                data["values"][:, :, :1], zeros, 1, valid=valid,
                slot_ids=slots, num_slots=num_slots, stats=("sum", "count"),
                mesh=mesh, splitk=splitk)
        return {"sum": out["sum"][:, 0, 0], "count": out["count"][:, 0]}

    def finalize_batch(acc, num_slots):
        s = to_numpy(acc["sum"])
        c = to_numpy(acc["count"])
        return [float(s[i] / max(c[i], 1.0)) for i in range(num_slots)]

    return WindowOperator("average", False, init_acc, fold, finalize,
                          fold_batch=fold_batch,
                          finalize_batch=finalize_batch,
                          supports_splitk=True)


# ------------------------------------------------------------------ bigrams

def _bigram_segment_count(ids: torch.Tensor, pval: torch.Tensor,
                          slots: torch.Tensor, num_slots: int,
                          vocab: int, mesh=None) -> torch.Tensor:
    """Composite (window_slot, pair) segment COUNT via one ``index_add_``
    — the big-vocab bigram path, where a count through the kernels'
    [num_slots * vocab^2] segment axis would be mostly empty segments.

    ids [B, P] local pair ids (a * vocab + b), pval [B, P] pair validity,
    slots [B] window slots -> [num_slots, vocab^2] counts. With a mesh
    the scatter shards as the stacked fold does: rows arrive shard-major,
    each shard rewrites its slots to shard-local indices and scatters into
    its own [slots_per * vocab^2] tile on its device, and the tiles
    concatenate on the first. Rows or slots that do not divide the mesh
    (callers outside the executor's packed layout) take the unsharded
    scatter."""
    v2 = vocab * vocab

    def flat_count(ids_, pv_, sl_, ns):
        total = ns * v2
        sid = (sl_.to(torch.int64)[:, None] * v2 + ids_).reshape(-1)
        pv = pv_.reshape(-1)
        sid = torch.where(pv, sid, total)                  # park invalid
        out = torch.zeros(total + 1, device=ids_.device)
        out.index_add_(0, sid, pv.to(torch.float32))
        return out[:total].reshape(ns, v2)

    if mesh is None or mesh.size <= 1 or ids.shape[0] % mesh.size \
            or num_slots % mesh.size:
        return flat_count(ids, pval, slots, num_slots)
    slots_per = num_slots // mesh.size
    rows = ids.shape[0] // mesh.size
    outs = []
    for d, dev in enumerate(mesh.devices):
        part = slice(d * rows, (d + 1) * rows)
        local = slots[part].to(dev, torch.int64) - d * slots_per
        own = (local >= 0) & (local < slots_per)
        outs.append(flat_count(
            ids[part].to(dev), pval[part].to(dev) & own[:, None],
            torch.where(own, local, 0), slots_per).to(ids.device))
    return torch.cat(outs)


def make_bigrams(block_capacity: int, width: int, vocab: int = 256,
                 device=None) -> WindowOperator:
    """Token payloads: each event's value row is a mini-document of
    ``width`` token ids; counts a dense [vocab, vocab] co-occurrence —
    deliberately compute-heavy like the paper's bigrams workload.

    Batch contract: every adjacent token pair is an "event" with the
    composite segment id ``(window_slot, a * vocab + b)`` and the bigram
    table is the per-slot segment COUNT, through the count-only stacked
    kernel while ``num_slots * vocab^2`` stays small, and through one
    ``index_add_`` above ``_BIGRAM_KERNEL_LIMIT`` segments.
    """
    from repro_torch.kernels import segment_aggregate_batched
    dev = resolve_device(device)

    _BIGRAM_KERNEL_LIMIT = 8192

    def init_acc():
        return torch.zeros((vocab, vocab), device=dev)

    def fold(acc, data, fill):
        vals = as_tensor(data["values"], dev, torch.float32)
        toks = vals.abs().to(torch.int64) % vocab               # [n, w]
        mask = _valid_mask(toks.shape[0], fill, dev)
        pair = toks[:, :-1] * vocab + toks[:, 1:]               # [n, w-1]
        # an invalid row's pairs contribute nothing anywhere
        pv = mask[:, None].expand_as(pair)
        contrib = torch.zeros(vocab * vocab, device=dev).index_add_(
            0, pair.reshape(-1), pv.reshape(-1).to(torch.float32))
        return acc + contrib.reshape(vocab, vocab)

    def finalize(acc):
        return to_numpy(acc)

    @_batch_fold(dev)
    def fold_batch(data, fills, slots, num_slots, mesh=None, table=None,
                   splitk=0):
        # splitk deliberately ignored (supports_splitk=False): the sharded
        # scatter masks rows by slot ownership, so balanced or chunk-padded
        # rows would be dropped
        vals = data["values"]
        if table is not None:
            # pool gather: one index_select along the arena's pool axis
            # (the pair ids are derived values, so the tokens cannot be
            # read inside the kernel)
            vals = _take_rows(vals, table)
        b, cap, w = vals.shape
        if w < 2:
            return {"pairs": torch.zeros((num_slots, vocab, vocab),
                                         device=vals.device)}
        toks = vals.abs().to(torch.int64) % vocab               # [B, cap, w]
        pair = toks[:, :, :-1] * vocab + toks[:, :, 1:]         # [B, cap, w-1]
        valid = _batch_valid(cap, fills)                        # [B, cap]
        pvalid = valid[:, :, None].expand_as(pair)
        ids = pair.reshape(b, cap * (w - 1))
        pval = pvalid.reshape(b, cap * (w - 1))
        if num_slots * vocab * vocab <= _BIGRAM_KERNEL_LIMIT:
            ones = torch.ones((b, cap * (w - 1), 1), device=vals.device)
            out = segment_aggregate_batched(
                ones, ids.to(torch.int32), vocab * vocab, valid=pval,
                slot_ids=slots, num_slots=num_slots, stats=("count",),
                mesh=mesh)
            cnt = out["count"]
        else:
            cnt = _bigram_segment_count(ids, pval, slots, num_slots, vocab,
                                        mesh)
        return {"pairs": cnt.reshape(num_slots, vocab, vocab)}

    def finalize_batch(acc, num_slots):
        pairs = to_numpy(acc["pairs"])
        return [pairs[i] for i in range(num_slots)]

    return WindowOperator("bigrams", False, init_acc, fold, finalize,
                          fold_batch=fold_batch,
                          finalize_batch=finalize_batch)


# -------------------------------------------------------------------- stock

def make_stock(block_capacity: int, width: int,
               num_keys: int = 128, device=None) -> WindowOperator:
    """Rolling per-symbol aggregates + price-warning alerts (>=5% swing).

    The per-block ``fold`` is a scatter; the JAX package's
    ``use_kernel=True`` variant of it is not ported."""
    from repro_torch.kernels import (
        segment_aggregate_batched, segment_aggregate_block_table,
        segment_aggregate_block_table_splitk,
    )
    dev = resolve_device(device)

    def init_acc():
        return {
            "min": torch.full((num_keys,), INF, device=dev),
            "max": torch.full((num_keys,), -INF, device=dev),
            "sum": torch.zeros((num_keys,), device=dev),
            "count": torch.zeros((num_keys,), device=dev),
        }

    def fold(acc, data, fill):
        vals = as_tensor(data["values"], dev, torch.float32)
        mask = _valid_mask(vals.shape[0], fill, dev)
        keys = torch.where(
            mask, as_tensor(data["keys"], dev, torch.int64), 0) % num_keys
        price = vals[:, 0]
        return {
            "min": acc["min"].scatter_reduce(
                0, keys, torch.where(mask, price, INF), "amin"),
            "max": acc["max"].scatter_reduce(
                0, keys, torch.where(mask, price, -INF), "amax"),
            "sum": acc["sum"].index_add(
                0, keys, torch.where(mask, price, 0.0)),
            "count": acc["count"].index_add(
                0, keys, mask.to(torch.float32)),
        }

    def finalize(acc):
        mean = to_numpy(acc["sum"]) / np.maximum(to_numpy(acc["count"]),
                                                 1.0)
        mx, mn = to_numpy(acc["max"]), to_numpy(acc["min"])
        with np.errstate(invalid="ignore"):
            alerts = (mx - mn) / np.where(mn > 0, mn, np.inf) >= 0.05
        return {"mean": mean, "min": mn, "max": mx, "alerts": alerts}

    @_batch_fold(dev)
    def fold_batch(data, fills, slots, num_slots, mesh=None, table=None,
                   splitk=0):
        cap = _cap(data["values"])
        valid = _batch_valid(cap, fills)
        if table is not None:
            # keys gather cheaply via one index_select (int32, needed to
            # derive segment ids); the fat value tiles stay in the arena
            # and are read inside the kernel (num_cols selects the price
            # column — no arena-wide slice copy)
            keys = _take_rows(data["keys"], table) % num_keys
            if splitk > 0:
                out = segment_aggregate_block_table_splitk(
                    data["values"], keys, table, num_keys, splitk,
                    valid=valid, slot_ids=slots, num_slots=num_slots,
                    mesh=mesh, num_cols=1)
            else:
                out = segment_aggregate_block_table(
                    data["values"], keys, table, num_keys, valid=valid,
                    slot_ids=slots, num_slots=num_slots, mesh=mesh,
                    num_cols=1)
        else:
            keys = data["keys"] % num_keys
            out = segment_aggregate_batched(
                data["values"][:, :, :1], keys, num_keys, valid=valid,
                slot_ids=slots, num_slots=num_slots, mesh=mesh,
                splitk=splitk)
        return {"min": out["min"][:, :, 0], "max": out["max"][:, :, 0],
                "sum": out["sum"][:, :, 0], "count": out["count"]}

    return WindowOperator("stock", False, init_acc, fold, finalize,
                          fold_batch=fold_batch,
                          finalize_batch=_per_slot_finalize(finalize),
                          supports_splitk=True)


# ---------------------------------------------------------------------- lrb

def make_lrb(block_capacity: int, width: int,
             num_segments: int = 256, device=None) -> WindowOperator:
    """Linear Road: values[:,0]=speed, values[:,1]=lane; per-segment vehicle
    count + average speed + accident flag (stopped vehicles) -> toll."""
    from repro_torch.kernels import segment_aggregate_batched
    dev = resolve_device(device)

    def init_acc():
        return {
            "count": torch.zeros((num_segments,), device=dev),
            "speed_sum": torch.zeros((num_segments,), device=dev),
            "stopped": torch.zeros((num_segments,), device=dev),
        }

    def fold(acc, data, fill):
        vals = as_tensor(data["values"], dev, torch.float32)
        mask = _valid_mask(vals.shape[0], fill, dev)
        seg = torch.where(mask, as_tensor(data["keys"], dev, torch.int64),
                          0) % num_segments
        speed = vals[:, 0]
        stopped = mask & (speed <= 1e-3)
        return {
            "count": acc["count"].index_add(0, seg, mask.to(torch.float32)),
            "speed_sum": acc["speed_sum"].index_add(
                0, seg, torch.where(mask, speed, 0.0)),
            "stopped": acc["stopped"].index_add(
                0, seg, stopped.to(torch.float32)),
        }

    def finalize(acc):
        count = to_numpy(acc["count"])
        avg_speed = to_numpy(acc["speed_sum"]) / np.maximum(count, 1.0)
        accident = to_numpy(acc["stopped"]) >= 2
        base = 2.0
        congestion = np.maximum(count - 50, 0.0)
        toll = np.where(accident, 0.0, base * congestion ** 2 * 1e-4)
        return {"count": count, "avg_speed": avg_speed,
                "accident": accident, "toll": toll}

    @_batch_fold(dev)
    def fold_batch(data, fills, slots, num_slots, mesh=None, table=None,
                   splitk=0):
        keys, values = data["keys"], data["values"]
        if table is not None:
            # the fold consumes DERIVED values ([speed, stopped]), so the
            # pool gather is one index_select along the pool axis per
            # tensor; split-K chunking happens at the executor
            # (chunk-group launches merged via merge_acc), while the
            # stacked sharded fold below still takes the balanced layout
            keys = _take_rows(keys, table)
            values = _take_rows(values, table)
        cap = values.shape[1]
        valid = _batch_valid(cap, fills)
        seg = keys.to(torch.int32) % num_segments
        speed = values[:, :, 0].to(torch.float32)
        stopped = (valid & (speed <= 1e-3)).to(torch.float32)
        # width-2 payload: the segment-sum of [speed, stopped] yields both
        # speed_sum and the stopped-vehicle count in one kernel pass
        vals = torch.stack([speed, stopped], dim=-1)
        out = segment_aggregate_batched(
            vals, seg, num_segments, valid=valid, slot_ids=slots,
            num_slots=num_slots, stats=("sum", "count"), mesh=mesh,
            splitk=splitk)
        return {"count": out["count"], "speed_sum": out["sum"][:, :, 0],
                "stopped": out["sum"][:, :, 1]}

    return WindowOperator("lrb", False, init_acc, fold, finalize,
                          fold_batch=fold_batch,
                          finalize_batch=_per_slot_finalize(finalize),
                          supports_splitk=True)


# --------------------------------------------------------------- percentile

def make_percentile(block_capacity: int, width: int,
                    qs=(0.5, 0.95, 0.99), device=None) -> WindowOperator:
    """BLOCKING operator (paper §3.3): the full window must be resident
    before the percentiles can be computed.

    Batch contract: the per-slot accumulator is a NaN-padded **sorted
    run** of the slot's valid values (``torch.sort`` orders NaN last, so
    the first ``count`` entries are the ascending data) — exact, not a
    sketch. Two accumulators merge by concatenating runs and re-sorting,
    which is why the ``merge`` override exists: the default add-merge
    would corrupt the state."""
    dev = resolve_device(device)

    def init_acc():
        return []

    def fold(acc, data, fill):
        # blocking: accumulate blocks; compute happens in finalize
        acc.append((as_tensor(data["values"], dev, torch.float32)[:, 0],
                    fill))
        return acc

    def finalize(acc):
        if not acc:
            return {q: float("nan") for q in qs}
        vals = torch.cat([v[_valid_mask(v.shape[0], f, dev)]
                          for v, f in acc])
        vals = vals[~torch.isnan(vals)]
        if vals.numel() == 0:
            return {q: float("nan") for q in qs}
        return {q: float(torch.quantile(vals, q)) for q in qs}

    @_batch_fold(dev)
    def fold_batch(data, fills, slots, num_slots, mesh=None, table=None,
                   splitk=0):
        # mesh and splitk ignored: a sort has no per-slot reduction to
        # shard, and the sorted-merge composes with chunk-group partials
        vals = data["values"]
        if table is not None:
            # pool gather: one index_select along the pool axis (the sort
            # consumes every row's values)
            vals = _take_rows(vals, table)
        v = vals[:, :, 0].to(torch.float32)                   # [B, cap]
        b, cap = v.shape
        valid = _batch_valid(cap, fills)
        keep = valid[:, :, None] & (
            slots[:, None, None] ==
            torch.arange(num_slots, device=v.device)[None, None, :])
        mat = torch.where(keep, v[:, :, None], float("nan")) \
            .permute(2, 0, 1).reshape(num_slots, b * cap)
        return {"sorted": torch.sort(mat, dim=1).values,
                "count": keep.sum(dim=(0, 1)).to(torch.int32)}

    def merge(a, b):
        # sorted-merge: concatenate the runs and re-sort (NaN padding
        # stays at the tail); counts add
        return {"sorted": torch.sort(torch.cat(
                    [a["sorted"], b["sorted"]], dim=1), dim=1).values,
                "count": a["count"] + b["count"]}

    def finalize_batch(acc, num_slots):
        srt = to_numpy(acc["sorted"])
        cnt = to_numpy(acc["count"])
        out = []
        for i in range(num_slots):
            n = int(cnt[i])
            if n == 0:
                out.append({q: float("nan") for q in qs})
            else:
                out.append({q: float(np.quantile(srt[i, :n], q))
                            for q in qs})
        return out

    return WindowOperator("percentile", True, init_acc, fold, finalize,
                          fold_batch=fold_batch,
                          finalize_batch=finalize_batch,
                          merge=merge, supports_splitk=True)


OPERATORS = {
    "average": make_average,
    "bigrams": make_bigrams,
    "stock": make_stock,
    "lrb": make_lrb,
    "percentile": make_percentile,
}


def make_operator(name: str, block_capacity: int, width: int,
                  **kw) -> WindowOperator:
    """``kw`` goes to the operator's factory, ``device`` included (None:
    the card)."""
    if name not in OPERATORS:
        raise KeyError(f"unknown operator {name!r}")
    return OPERATORS[name](block_capacity, width, **kw)
