#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--windows 6] [--splitk-windows 2] [--out FILE]

Phases (the first failed check exits non-zero, with no result line):

0. The card's name and power limit, then the nvcc build of the kernels
   (``src/repro_torch/kernels/csrc/segment_aggregate.cu`` for sm_90a).
1. The main path: ``StreamEngine`` with the stock operator at the Table-1
   deployment (10,000 events/s into 30 s tumbling windows, 1,664-byte
   payloads, 128 keys, lognormal lateness from ``WorkloadGenerator``)
   with a 3,072-slot device block pool (2.6 GB of window state on the
   card) and a small host budget that spills to the log store. The
   stream runs ``--windows`` windows of processing time, then closes out
   (watermark past the end, polls, one batched sweep of every window) and
   every window's result is held against a numpy oracle over all events.
2. The same deployment with ``splitk_chunk_rows=64`` and a 1,024-slot
   pool below the live state, over ``--splitk-windows`` windows: the
   split-K fold and the stacked fallback under pool pressure. Three
   quarters of the way, a manifest ``checkpoint_state`` is restored into
   a new engine over the same log store (``restore_state``), which
   finishes the stream.
3. Kernel checks on the main path's own launches. While phases 1 and 2
   run, a recorder around the fold entry points of ``repro_torch.kernels``
   keeps the inputs of each kernel's largest call (most rows): the value
   column the fold reads, the ids, valid flags, table and window slots.
   Each kernel (K1 flat / stacked fallback, K2 block table, K3 split-K)
   is replayed on those inputs and held against its plain PyTorch
   version on the card: the unread value columns are random, and pool
   slot 0, which only padding rows name, holds NaN (they must stay
   inert). Each is timed with CUDA events beside its plain version, one
   PyTorch ``index_add_`` of the same sums (a yardstick only) and its
   bound. Besides: K3 on rows that its wrapper must pad, its raw
   partials, and a NaN case for min/max in K1.

The kernels' launch counters are set to 0 just before phases 1 and 2 and
read just after. A kernel's ``launches`` is its count in the run whose
launch it replays (K1 and K2 the main run where they launched there, K3
the split-K run); ``launches_by_run`` gives both counts. The last line of
the output is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' numbers as one JSON object, and the line before that the
card's name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor fp32
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# sum tolerance: rtol, and atol per unit of max|v| x events in the segment
SUM_RTOL = 1e-5
SUM_ATOL = 1e-5
SEED = 0

JAX_FILE = "src/repro/kernels/segment_aggregate.py"
SOURCE = "src/repro_torch/kernels/csrc/segment_aggregate.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


# ------------------------------------------------------------------ phase 0
def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# --------------------------------------------------- the launch recorder
#: each kernel: its name, the line of the TPU kernel it replaces in
#: JAX_FILE, and the fold entry point of ``repro_torch.kernels`` (and the
#: ``*_cuda`` / ``*_plain`` pair of the module) that reaches it
KERNELS = {
    "K1": ("seg_agg_flat (K1, stacked fallback fold)", 165,
           "segment_aggregate_batched"),
    "K2": ("seg_agg_block_table (K2, resident block-table fold)", 339,
           "segment_aggregate_block_table"),
    "K3": ("seg_agg_block_table_splitk (K3, split-K block-table fold)", 505,
           "segment_aggregate_block_table_splitk"),
}
ENTRY_POINTS = {k: v[2] for k, v in KERNELS.items()}


class LaunchRecorder:
    """Wraps the fold entry points of ``repro_torch.kernels`` while it is
    entered, and keeps the inputs of each one's largest call (most rows):
    the value columns the fold reads, ids, valid flags, table and window
    slots, as device copies on the caller's stream. The operators import
    the entry points when they are made, so the engine is built inside."""

    def __init__(self):
        self.largest = {}
        self._saved = {}

    def __enter__(self):
        import inspect
        kernels = importlib.import_module("repro_torch.kernels")
        for key, name in ENTRY_POINTS.items():
            fn = getattr(kernels, name)
            self._saved[name] = fn
            setattr(kernels, name,
                    self._wrap(key, fn, inspect.signature(fn)))
        return self

    def __exit__(self, *exc):
        kernels = importlib.import_module("repro_torch.kernels")
        for name, fn in self._saved.items():
            setattr(kernels, name, fn)
        return False

    def _wrap(self, key, fn, sig):
        def recorded(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            self._keep(key, bound.arguments)
            return fn(*args, **kw)
        return recorded

    def _keep(self, key, a) -> None:
        vals = a["values"] if key == "K1" else a["values_arena"]
        rows = vals.shape[0] if key == "K1" else a["table"].shape[0]
        if rows <= self.largest.get(key, {}).get("rows", 0):
            return
        rec = {"rows": rows, "num_segments": a["num_segments"],
               "num_slots": a["num_slots"], "stats": tuple(a["stats"])}
        for k in ("segment_ids", "valid", "slot_ids"):
            rec[k] = a[k].clone()
        if key == "K1":
            # [B, cap, 1]: the column the fold reads out of its width-W rows
            rec["values"] = vals.clone()
            rec["row_width"] = vals.stride(1)
        else:
            cols = a["num_cols"] or vals.shape[2]
            table = a["table"]
            rec.update(arena_shape=tuple(vals.shape),
                       num_cols=a["num_cols"], table=table.clone(),
                       values=vals[:, :, :cols].index_select(
                           0, table.long()))
            if key == "K3":
                rec["chunk_rows"] = a["chunk_rows"]
        self.largest[key] = rec


# ------------------------------------------------------------------ phase 3
def _sync_time_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA
    events, after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(out: dict, ref: dict, scale: float) -> float:
    """Hold a kernel's stats against the plain version's: count, min and
    max exactly (NaN where the plain version has NaN), sums within
    SUM_RTOL x |ref| + SUM_ATOL x max|v| x events-in-segment. Returns the
    largest absolute difference over the finite entries."""
    import torch
    check(set(out) == set(ref), f"stats {sorted(out)} != {sorted(ref)}")
    worst = 0.0
    rows = float(ref["count"].max()) if "count" in ref else 1.0
    for k in ref:
        a, b = out[k].float(), ref[k].float()
        check(a.shape == b.shape, f"{k}: shape {tuple(a.shape)} != "
                                  f"{tuple(b.shape)}")
        check(torch.equal(torch.isnan(a), torch.isnan(b)),
              f"{k}: NaN positions differ")
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a)) and torch.equal(
            a[~fin & ~torch.isnan(b)], b[~fin & ~torch.isnan(b)]),
            f"{k}: infinite entries differ")
        diff = (a[fin] - b[fin]).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        worst = max(worst, err)
        if k == "sum":
            tol = SUM_RTOL * b[fin].abs() + SUM_ATOL * scale * max(rows, 1.0)
            check(bool((diff <= tol).all()),
                  f"sum: max error {err} beyond tolerance")
        else:
            check(err == 0.0, f"{k}: max error {err}, must be exact")
    return worst


def _bound(n_events: int, n_valid: int, w_out: int, n_rows: int,
           s_total: int, stats) -> tuple:
    """Least time (ms) for the fold on an H100, and what bounds it. Bytes:
    every event's valid flag (1 B), each valid event's id (4 B) and its
    w_out value columns (4 B each), 8 B per table row (pool slot and
    window slot), the outputs written once. Operations: one per value
    stat per column and one count per valid event, in fp32."""
    n_val = sum(1 for s in stats if s != "count")
    out_bytes = s_total * 4 * (w_out * n_val + ("count" in stats))
    nbytes = n_events + n_valid * (4 + 4 * w_out) + 8 * n_rows + out_bytes
    ops = n_valid * (w_out * n_val + ("count" in stats))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_sum_ms(vals_col, comp, valid, s_total: int, iters: int):
    """One ``index_add_`` of the valid events' values into their composite
    segments: the sums alone, as PyTorch computes them (a yardstick)."""
    import torch
    ids = torch.where(valid.reshape(-1), comp.reshape(-1).long(), s_total)
    v = vals_col.reshape(ids.shape[0], -1).contiguous()
    acc = torch.zeros(s_total + 1, v.shape[1], device=v.device)

    def call():
        acc.index_add_(0, ids, v)
    return _sync_time_ms(call, iters)


def replay(key: str, rec: dict, g) -> dict:
    """A recorded launch's inputs, rebuilt on the recording's device: the
    wrapper's positional and keyword arguments, its kernel and plain
    functions, and the value columns the fold reads (for the yardstick
    and the tolerance). K2/K3 get an arena of the recorded shape with
    random unread columns, the recorded column written into the rows the
    table names, and NaN in pool slot 0 (a live row that held slot 0
    moves to a slot the table does not name, past the recorded ones
    where the table names every slot)."""
    import torch
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    valid = rec["valid"]
    dev = valid.device
    kw = dict(valid=valid, slot_ids=rec["slot_ids"],
              num_slots=rec["num_slots"], stats=rec["stats"])
    kernel = getattr(sa, KERNELS[key][2] + "_cuda")
    plain = getattr(sa, KERNELS[key][2] + "_plain")

    def prices(shape):
        return torch.rand(shape, generator=g, device=dev) * 490.0 + 10.0

    if key == "K1":
        b, cap, _ = rec["values"].shape
        full = prices((b, cap, rec["row_width"]))
        full[:, :, :1] = rec["values"]
        read = full[:, :, :1]
        args = (read, rec["segment_ids"], rec["num_segments"])
        return dict(kernel=kernel, plain=plain, args=args, kw=kw,
                    read=read, scale=float(read.abs().max()))
    p, cap, w = rec["arena_shape"]
    table = rec["table"].clone()
    live = valid.any(1)
    moved = torch.nonzero(live & (table == 0)).flatten()
    extra = 0
    if moved.numel():
        free = torch.ones(p, dtype=torch.bool, device=dev)
        free[table.long()] = False
        spare = torch.nonzero(free).flatten()
        extra = max(moved.numel() - spare.numel(), 0)
        spare = torch.cat([spare, torch.arange(p, p + extra, device=dev)])
        table[moved] = spare[:moved.numel()].to(table.dtype)
    arena = prices((p + extra, cap, w))
    cols = rec["values"].shape[2]
    arena[table[live].long(), :, :cols] = rec["values"][live]
    arena[0] = float("nan")
    kw["num_cols"] = rec["num_cols"]
    args = (arena, rec["segment_ids"], table, rec["num_segments"])
    if key == "K3":
        args += (rec["chunk_rows"],)
    return dict(kernel=kernel, plain=plain, args=args, kw=kw,
                read=arena[:, :, :cols].index_select(0, table.long()),
                scale=float(rec["values"][live].abs().max()))


def check_replay(key: str, rp: dict) -> float:
    """The kernel against its plain version on a replayed launch (for
    K3 also on rows its wrapper must pad, and as raw partials). No output
    of K2/K3 may hold NaN: only padding rows name pool slot 0. Returns
    the largest absolute error."""
    import torch
    kernel, plain, args, kw = rp["kernel"], rp["plain"], rp["args"], rp["kw"]
    cases = [(args, kw)]
    if key == "K3":
        chunk = args[4]
        cut = args[2].shape[0] - 1
        check(cut > 0 and cut % chunk, "K3: no rows left to pad")
        cases.append(((args[0], args[1][:cut], args[2][:cut], args[3],
                       chunk), dict(kw, valid=kw["valid"][:cut],
                                    slot_ids=kw["slot_ids"][:cut])))
        cases.append((args, dict(kw, merge=False)))
    err = 0.0
    for a, k in cases:
        out = kernel(*a, **k)
        if key != "K1":
            check(not any(bool(torch.isnan(v).any()) for v in out.values()),
                  f"{key}: a padding row read the NaN-poisoned pool slot 0")
        err = max(err, compare(out, plain(*a, **k), rp["scale"]))
    return err


def nan_check(dev, g) -> float:
    """K1 with NaN values: NaN wins min/max as jnp.minimum/maximum, and
    a NaN value poisons only its own segment's sum."""
    import torch
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    n = 5000
    v = torch.rand((n, 3), generator=g, device=dev) * 10.0 - 5.0
    v[7, 1] = float("nan")
    v[4000, 0] = float("nan")
    sid = torch.randint(0, 37, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    ok = torch.rand(n, generator=g, device=dev) > 0.2
    ok[7] = True
    ok[4000] = True
    return compare(sa.segment_aggregate_cuda(v, sid, 37, valid=ok),
                   sa.segment_aggregate_plain(v, sid, 37, valid=ok), 5.0)


def kernel_record(key: str, rec: dict, g, iters: int) -> dict:
    """Phase 3 for one kernel: replay its recorded launch, check it and
    time it beside its plain version, the yardstick and its bound."""
    rp = replay(key, rec, g)
    err = check_replay(key, rp)
    kernel, plain, args, kw = rp["kernel"], rp["plain"], rp["args"], rp["kw"]
    valid, slots, ids = kw["valid"], kw["slot_ids"], args[1]
    s_total = rec["num_slots"] * rec["num_segments"]
    comp = slots[:, None] * rec["num_segments"] + ids
    n_valid = int(valid.sum())
    bound, by = _bound(valid.numel(), n_valid, rp["read"].shape[2],
                       rec["rows"], s_total, rec["stats"])
    if key == "K1":
        b, cap, _ = rec["values"].shape
        shape = (f"stacked [{b}, {cap}, {rec['row_width']}] (column 0 "
                 f"read)")
    else:
        shape = (f"arena {list(args[0].shape)}, table [{rec['rows']}]"
                 f" ({int(valid.any(1).sum())} live rows), num_cols="
                 f"{rec['num_cols']}")
        if key == "K3":
            shape += (f", chunk_rows={rec['chunk_rows']}, "
                      f"{-(-rec['rows'] // rec['chunk_rows'])} partials")
    shape += (f", S={rec['num_segments']}, slots={rec['num_slots']}, "
              f"valid={n_valid}")
    name, line, _ = KERNELS[key]
    return dict(
        name=name, route="cuda", source=SOURCE,
        replaces=f"{JAX_FILE}:{line}", max_abs_err=err,
        ms=_sync_time_ms(lambda: kernel(*args, **kw), iters),
        plain_ms=_sync_time_ms(lambda: plain(*args, **kw),
                               max(iters // 4, 1)),
        bound_ms=bound, bound_by=by,
        library_ms=_library_sum_ms(rp["read"], comp, valid, s_total, iters),
        shape=shape)


# --------------------------------------------------------------- phases 1-2
def stock_oracle(keys, ts, price, window: float, num_keys: int) -> dict:
    """Per-window per-key mean / min / max over every event (float64)."""
    import numpy as np
    wstart = np.floor(ts / window) * window
    out = {}
    for s in np.unique(wstart):
        sel = wstart == s
        k = keys[sel] % num_keys
        p = price[sel].astype(np.float64)
        mn = np.full(num_keys, np.inf)
        mx = np.full(num_keys, -np.inf)
        sm = np.zeros(num_keys)
        ct = np.zeros(num_keys)
        np.minimum.at(mn, k, p)
        np.maximum.at(mx, k, p)
        np.add.at(sm, k, p)
        np.add.at(ct, k, 1.0)
        out[(float(s), float(s) + window)] = {
            "mean": sm / np.maximum(ct, 1.0), "min": mn, "max": mx,
            "count": ct}
    return out


def run_stream(device, *, windows: float, pool_slots: int, splitk: int,
               seed: int, spill_root: Path, rate: float = None,
               width: int = None, device_budget: int = 6 << 30,
               host_budget: int = 512 << 20, step_seconds: float = 1.0,
               late_horizon: float = 300.0,
               restore_at: float = None) -> dict:
    """Drive the port's ``StreamEngine`` with the stock-market deployment
    for ``windows`` windows of processing time, close out, and hold every
    window against the oracle. ``restore_at`` (a fraction of the stream)
    takes a manifest checkpoint there, closes the engine, and resumes in a
    new engine restored from it over the same log store. ``rate`` and
    ``width`` default to Table 1 (CPU rehearsals pass smaller ones).
    Returns the run's record."""
    import numpy as np
    from repro_torch.configs.base import AionConfig
    from repro_torch.configs.workloads import STOCK_MARKET, WorkloadConfig
    from repro_torch.core import PredictiveCleanup, StreamEngine, \
        TumblingWindows
    from repro_torch.core.batch_exec import BatchWorkItem
    from repro_torch.core.operators import make_operator
    from repro_torch.data.generators import make_generator

    wl = STOCK_MARKET
    if width is not None:
        wl = WorkloadConfig(**{**wl.__dict__, "value_width": width})
    rate = rate or wl.max_ingestion_rate
    gen = make_generator(wl, seed=seed)
    w = gen.width
    wd = wl.window_duration

    class KeepAll(PredictiveCleanup):
        # the oracle keeps every event: no window is ever purged
        def should_purge(self, window_end, watermark):
            return False

    aion = AionConfig(pool_slots=pool_slots, splitk_chunk_rows=splitk)
    per_step = int(round(rate * step_seconds))
    steps = int(round(windows * wd / step_seconds))
    spill = Path(tempfile.mkdtemp(prefix="store_", dir=spill_root))
    counted = ("ingested", "ingested_late", "live_executions",
               "late_executions", "batch_executions", "batched_windows",
               "pooled_rows", "fallback_rows", "demand_pool_fills",
               "splitk_launches", "dropped", "purged_windows")
    counts = dict.fromkeys(counted, 0)

    def make():
        return StreamEngine(
            assigner=TumblingWindows(wd),
            operator=make_operator("stock", aion.block_size, w,
                                   num_keys=wl.num_keys, device=device),
            aion=aion, value_width=w,
            cleanup=KeepAll(coverage=aion.cleanup_coverage,
                            confidence=aion.cleanup_confidence),
            device_budget_bytes=device_budget,
            host_budget_bytes=host_budget, spill_dir=spill, device=device)

    def absorb(e):
        for k in counted:
            counts[k] += getattr(e.metrics, k)

    t_build = time.perf_counter()
    eng = make()
    secs = {"build": time.perf_counter() - t_build, "generate": 0.0,
            "ingest": 0.0, "advance_watermark": 0.0, "poll": 0.0}
    restore_step = -1 if restore_at is None else int(restore_at * steps)
    ledger_k, ledger_t, ledger_p = [], [], []
    now = 0.0
    t_stream = time.perf_counter()
    for i in range(steps):
        t0 = time.perf_counter()
        batch = gen.batch(per_step, now)
        ledger_k.append(batch.keys)
        ledger_t.append(batch.timestamps)
        ledger_p.append(batch.values[:, 0].copy())
        t1 = time.perf_counter()
        eng.ingest(batch, now)
        t2 = time.perf_counter()
        eng.advance_watermark(now, now)
        t3 = time.perf_counter()
        eng.poll(now)
        t4 = time.perf_counter()
        secs["generate"] += t1 - t0
        secs["ingest"] += t2 - t1
        secs["advance_watermark"] += t3 - t2
        secs["poll"] += t4 - t3
        now += step_seconds
        if i + 1 == restore_step:
            t0 = time.perf_counter()
            snap = eng.checkpoint_state(include_stored_data=False)
            absorb(eng)
            eng.close(drain_timeout=600)
            eng = make()
            eng.restore_state(snap)
            blocks = [b for win in snap["windows"] for b in win["blocks"]]
            secs["checkpoint_restore"] = time.perf_counter() - t0
            log(f"  t={now:6.1f}s checkpoint -> restore: "
                f"{len(snap['windows'])} windows, {len(blocks)} blocks "
                f"({sum(1 for b in blocks if b.get('stored'))} as store "
                f"references) in {secs['checkpoint_restore']:.2f} s")
            del snap, blocks
        if (i + 1) % max(steps // 6, 1) == 0:
            m = eng.metrics
            log(f"  t={now:6.1f}s windows={len(eng.windows)} "
                f"live={m.live_executions} late={m.late_executions} "
                f"pooled_rows={m.pooled_rows} "
                f"fallback_rows={m.fallback_rows} "
                f"device={eng.device_bytes() / 2**30:.2f}GiB "
                f"host={eng.host_bytes() / 2**30:.2f}GiB "
                f"elapsed={time.perf_counter() - t_stream:.1f}s")
    stream_s = (time.perf_counter() - t_stream - secs["generate"]
                - secs.get("checkpoint_restore", 0.0))

    # close out as the soak does: watermark past every lateness, the
    # remaining plans fire, then one batched sweep of every window
    t0 = time.perf_counter()
    end = now
    eng.advance_watermark(end + late_horizon, end)
    for t in np.linspace(end, end + 70.0, 6):
        eng.poll(float(t))
    check(eng.io.drain(timeout=600), "I/O executor did not drain")
    items = [BatchWorkItem(wid, eng.windows[wid], True)
             for wid in sorted(eng.windows, key=lambda x: x.start)]
    eng.batch_exec.execute(items, end + 70.0)
    secs["close_out"] = time.perf_counter() - t0
    results = {(wid.start, wid.end): r for wid, r in eng.results.items()}
    absorb(eng)
    obs = eng.observability()
    arena_bytes = eng.pool.arena_bytes if eng.pool is not None else 0
    eng.close(drain_timeout=600)
    shutil.rmtree(spill, ignore_errors=True)

    t0 = time.perf_counter()
    keys = np.concatenate(ledger_k)
    want = stock_oracle(keys, np.concatenate(ledger_t),
                        np.concatenate(ledger_p), wd, wl.num_keys)
    check(set(results) == set(want),
          f"windows {sorted(results)} != oracle {sorted(want)}")
    worst = 0.0
    for wid, ref in want.items():
        got = results[wid]
        for k in ("min", "max"):
            a = np.asarray(got[k], np.float32)
            check(a.shape == (wl.num_keys,), f"{wid} {k} shape {a.shape}")
            check(np.array_equal(a, ref[k].astype(np.float32)),
                  f"{wid} {k} differs from the oracle")
        mean = np.asarray(got["mean"], np.float64)
        check(mean.shape == (wl.num_keys,) and np.isfinite(mean).all(),
              f"{wid} mean not finite / wrong shape")
        err = np.abs(mean - ref["mean"])
        # mean = sum / count: the sum tolerance divided by the count
        tol = SUM_RTOL * np.abs(ref["mean"]) + SUM_ATOL * 500.0
        check(bool((err <= tol).all()),
              f"{wid} mean max error {err.max()} beyond tolerance")
        worst = max(worst, float(err.max()))
    secs["oracle"] = time.perf_counter() - t0
    return {
        "events": int(keys.shape[0]), "windows": len(want),
        "events_per_s": keys.shape[0] / stream_s, "stream_s": stream_s,
        "seconds": secs, "counts": counts, "arena_bytes": arena_bytes,
        "max_mean_abs_err": worst, "observability": obs,
        "width": w, "rate": rate,
    }


def _print_run(tag: str, rec: dict) -> None:
    log(f"  {tag}: {rec['events']} events, {rec['windows']} windows, "
        f"{rec['events_per_s']:.1f} events/s over {rec['stream_s']:.2f} s "
        f"of ingest/watermark/poll; max |mean - oracle| "
        f"{rec['max_mean_abs_err']:.3g}")
    log(f"  {tag} seconds: " + json.dumps(
        {k: round(v, 3) for k, v in rec["seconds"].items()}))
    log(f"  {tag} counts: " + json.dumps(rec["counts"]))
    obs = rec["observability"]
    summary = {k: obs.get(k) for k in ("pool", "fold", "store")}
    summary["io"] = {k: v for k, v in obs.get("io", {}).items()
                     if isinstance(v, (int, float))}
    log(f"  {tag} observability: " + json.dumps(summary, default=str))


# --------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=float, default=6.0,
                    help="windows of processing time streamed in phase 1")
    ap.add_argument("--splitk-windows", type=float, default=2.0,
                    help="windows of processing time streamed in phase 2")
    ap.add_argument("--out", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the GPU",
              file=sys.stderr)
        return 2
    import numpy as np  # noqa: F401  (fail early where numpy is missing)
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = gpu_line()
    log(f"phase 0: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x{count}")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")

    report = {"gpu": card, "kind": kind}
    spill_root = ROOT / "build" / "smoke"
    spill_root.mkdir(parents=True, exist_ok=True)
    wrappers = dict(zip(KERNELS, sa.KERNEL_WRAPPERS))
    runs, recorded = {}, {}
    try:
        # the data seeds of these runs stay those of the earlier phase
        # numbering (2 and 3), so the streams match the recorded runs
        for phase, tag, seed, kw, need in (
                (1, "main", SEED + 2, dict(windows=args.windows,
                                           pool_slots=3072, splitk=0),
                 ("K2",)),
                (2, "splitk", SEED + 3, dict(windows=args.splitk_windows,
                                             pool_slots=1024, splitk=64,
                                             restore_at=0.75), ("K3",))):
            for fn in wrappers.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with LaunchRecorder() as recorder:
                rec = run_stream(dev, seed=seed, spill_root=spill_root, **kw)
            torch.cuda.synchronize()
            rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
            rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            rec["wall_s"] = time.perf_counter() - t0
            runs[tag] = rec
            recorded[tag] = recorder.largest
            log(f"phase {phase}: {tag} run in {rec['wall_s']:.1f} s, kernel "
                f"launches {rec['launches']}, max_memory_allocated "
                f"{rec['max_memory_allocated'] / 1e9:.3f} GB (arena "
                f"{rec['arena_bytes'] / 1e9:.3f} GB)")
            _print_run(tag, rec)
            c = rec["counts"]
            check(c["late_executions"] > 0, f"{tag}: no late executions")
            check(c["pooled_rows"] > 0, f"{tag}: no pooled rows")
            check(rec["max_memory_allocated"] >= rec["arena_bytes"] > 0,
                  f"{tag}: the arena is not on the card")
            for k in need:
                check(rec["launches"][k] > 0, f"{tag}: {k} never launched")
            for k, n in rec["launches"].items():
                check(n == 0 or k in recorder.largest,
                      f"{tag}: {k} launched outside the recorded entry "
                      f"points")
            if tag == "splitk":
                check(c["splitk_launches"] > 0, "splitk: no split-K launch")
    finally:
        shutil.rmtree(spill_root, ignore_errors=True)
    fallback = sum(r["counts"]["fallback_rows"] for r in runs.values())
    check(fallback > 0, "no fallback rows in phases 1-2")

    # phase 3: each kernel replays its largest launch of the first run
    # (main, then split-K) in which it launched
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    kernels, shapes = [], []
    for key in KERNELS:
        by_run = {tag: r["launches"][key] for tag, r in runs.items()}
        path = next((t for t, n in by_run.items() if n > 0), None)
        check(path is not None, f"{key} was never launched on the main path")
        rec = recorded[path][key]
        r = kernel_record(key, rec, g, iters=50)
        if key == "K1":
            r["max_abs_err"] = max(r["max_abs_err"], nan_check(dev, g))
        log(f"phase 3: {key} {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
            f"(count/min/max exact, sum rtol {SUM_RTOL} + atol {SUM_ATOL} x "
            f"max|v| x events/segment) | kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) | the "
            f"largest launch of the {path} run ({by_run}): {r['shape']}")
        shapes.append(r.pop("shape"))
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": by_run[path],
            "path": path, "launches_by_run": by_run,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        torch.cuda.synchronize()
        del rec
        torch.cuda.empty_cache()
    log(f"phase 3: {time.perf_counter() - t0:.1f} s")

    if args.out is not None:
        report["kernels"] = [dict(x, shape=s)
                             for x, s in zip(kernels, shapes)]
        report["runs"] = runs
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1, default=str))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
