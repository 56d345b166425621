#!/usr/bin/env python3
"""Where the time of one K3 call goes: host against device.

    PYTHONPATH=src python benchmarks/torch_splitk_host.py [--iters 2000]

K3 (the split-K block-table fold, ``segment_aggregate_block_table_
splitk_cuda`` on its shared-memory design) folds 262,144 events in a few
microseconds of device time, so a call is bound by the host: the
wrapper's Python, its allocation and views, and the launch. On inputs of
the shape of the stock fold's split-K launch in ``chip_smoke.py`` phase 2
(arena [1024, 512, 416] float32, 512 rows of 512 events, 97.7% valid,
128 keys, 2 window slots, chunks of 64 rows, all four stats of column 0;
made from a seed on the card), this prints one JSON object: the host
microseconds per call, back to back, of the wrapper, of its preparation
alone (``splitk_smem_launch``: checks, the one allocation, the output
views, the C arguments), of the C call alone, of one ``torch.empty`` and
of one ``torch.cuda.current_stream`` (each also with the synchronise at
the end, ``*_sync``), and the device microseconds per call of each CUDA
kernel and memset of the C call from ``torch.profiler``. It needs one
CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_splitk_host: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
    from repro_torch.kernels._build import library

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    arena = torch.rand((1024, 512, 416), generator=g, device=dev) * 490 + 10
    table = torch.randperm(1024, generator=g, device=dev)[:512].to(
        torch.int32)
    ids = torch.randint(0, 128, (512, 512), generator=g, device=dev,
                        dtype=torch.int32)
    valid = torch.rand((512, 512), generator=g, device=dev) < 0.977
    slots = torch.randint(0, 2, (512,), generator=g, device=dev,
                          dtype=torch.int32)
    stats = sa.norm_stats(sa.ALL_STATS)
    fold = (arena, ids, table, 128, 64)
    kw = dict(valid=valid, slot_ids=slots, num_slots=2, stats=stats,
              num_cols=1)
    launch, outs, keep = sa.splitk_smem_launch(*fold, valid, slots, 2,
                                               stats, 1, True)
    lib = library("segment_splitk.cu")

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t1 - t0) / args.iters * 1e6, (t2 - t0) / args.iters * 1e6

    cases = {
        "wrapper": lambda: sa.segment_aggregate_block_table_splitk_cuda(
            *fold, **kw),
        "preparation": lambda: sa.splitk_smem_launch(
            *fold, valid, slots, 2, stats, 1, True),
        "c_call": lambda: lib.call("seg_agg_splitk_smem", *launch),
        "torch_empty": lambda: torch.empty(1024, device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev),
    }
    out = {"gpu": torch.cuda.get_device_name(0)}
    for name, fn in cases.items():
        out[name], out[name + "_sync"] = host_us(fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            lib.call("seg_agg_splitk_smem", *launch)
        torch.cuda.synchronize()
    out["device_us"] = {
        e.key: e.device_time_total / e.count
        for e in prof.key_averages() if e.device_time_total > 0}
    del outs, keep
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
