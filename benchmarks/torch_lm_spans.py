#!/usr/bin/env python3
"""The port's LM spans (``repro_torch.obs.lm``) read on a cell of the
benchmark under ``bench/``.

    python3 benchmarks/torch_lm_spans.py --workload <cell> --seed <n> \
        --seconds <s> [--order off,on] [--out <file.json>]

From the root of a checkout, on a CUDA device (it exits 2 without one).
It runs the cell (``bench/drivers/``) as ``bench/run.py --trace 1`` does (the
probes, the profiled segment, the check), twice: with the program's
tracer off and on (every span sampled, the device clock), in ``--order``.
Then, with ``torch.cuda.set_sync_debug_mode("warn")``, it runs the first
steps of the training cell or one batch of the serving cell at the
cycle's middle length with the tracer on, and counts the program's
synchronising calls beside its ``host_syncs``. It prints one JSON
object (and writes it to ``--out``):

- ``off``, ``on``: each run's end-to-end and per-layer metrics, read by
  the cell's readers from its record, and its profiled segment's idle
  gaps by benchmark span (``idle_gaps``) and, the tracer on, by the
  innermost ``repro:`` span open on the host at each gap's middle, else
  the innermost ``bench:`` one (``idle_gaps_program``);
- ``spans``: the span table of the window (its steps, or its prefills);
- ``read``: what the spans give for the window: ``head_ms.train``
  (``model.head``'s device time, forward and backward, a step),
  ``prefill_attn_ms.serve`` and ``prefill_mlp_ms.serve`` (``model.attn``
  and ``model.mlp`` under ``serve.prefill``, a prefill), and the twins of
  the probes' metrics (``train.fwd``, ``train.bwd``, ``train.opt`` ms a
  step; ``kernel.k5``/``kernel.k6`` calls);
- ``syncs``: the synchronising calls made from the program's files and
  its ``host_syncs``, over the same steps.

A bridge: ``program_gaps`` repeats ``harness.read_trace``'s gap logic and
``run_once`` its cell context. Once the benchmark's drivers record the
spans, their readings belong under ``bench/metrics/``, the span labels in
``read_trace`` as an option, and this script goes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def program_gaps(events: list) -> list:
    """The profiled segment's idle gaps (``harness.read_trace``'s) summed
    by the innermost ``repro:`` span open on the host at each gap's
    middle, else the innermost ``bench:`` one; the fifteen largest."""
    from bench.harness import DEVICE_CATS
    seg = [e for e in events if e.get("ph") == "X"
           and e.get("name") == "bench:segment"]
    w0 = float(seg[0]["ts"])
    w1 = w0 + float(seg[0]["dur"])
    merged: list = []
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    for t, d in sorted((float(e["ts"]), float(e.get("dur", 0)))
                       for e in dev):
        a, b = max(t, w0), min(t + d, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    host = {"repro:": [], "bench:": []}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and name[:6] in host and name != "bench:segment":
            t = float(e["ts"])
            host[name[:6]].append((t, t + float(e["dur"]), name))
    gaps: dict = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = "host outside the spans"
        for kind in ("repro:", "bench:"):
            open_ = [(h1 - h0, name) for h0, h1, name in host[kind]
                     if h0 <= mid <= h1]
            if open_:
                label = min(open_)[1]
                break
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:15]


def run_once(spec, cell, seed, seconds, traced: bool, device="cuda"):
    """The cell run once with ``--trace 1``'s probes; with ``traced``
    the program's tracer on throughout. Returns (its output, the metrics,
    the profiled segment's trace events, the tracer's records)."""
    from bench import harness
    from repro_torch.obs import lm
    seen = {}
    real = harness.read_trace

    def keep(events):
        seen["events"] = events
        return real(events)
    ctx = {"config": cell["config"], "traffic": cell["traffic"],
           "seed": seed, "seconds": seconds, "trace": True,
           "device": device, "t0": time.perf_counter(), "cell": cell["cell"]}
    harness.read_trace = keep
    try:
        if traced:
            with lm.tracing(device) as tr:
                out = cell["driver"].run(ctx)
                records = tr.records()
        else:
            out, records = cell["driver"].run(ctx), []
    finally:
        harness.read_trace = real
    name = cell["cell"]["name"]
    metrics = harness.read_metrics(
        harness.metrics_for(spec, name, False)
        + harness.metrics_for(spec, name, True), out["record"])
    return out, {k: v["value"] for k, v in metrics.items()}, \
        seen["events"], records


def window(records: list, root: str, count: int, after: int) -> list:
    """The records of the ``count`` traces whose root is ``root`` before
    the last ``after`` of them (the profiled segment's; counted from the
    end, as the ring drops the oldest)."""
    roots = [r["trace"] for r in records
             if r["parent"] is None and r["name"] == root]
    keep = set(roots[len(roots) - count - after:len(roots) - after])
    return [r for r in records if r["trace"] in keep]


def readings(kind: str, table: dict, record: dict, n: int) -> dict:
    """What the window's spans give, a step (training) or a prefill."""
    def dev(name, key="device_s"):
        return 1e3 * table.get(name, {}).get(key, 0.0) / n

    def calls(name):
        return sum(row["calls"] for k, row in table.items()
                   if k.split(" ")[0] == name)
    if kind == "train":
        return {"head_ms.train": dev("model.head")
                + dev("model.head", "device_bwd_s"),
                "train.fwd_ms": dev("train.fwd"),
                "train.bwd_ms": dev("train.bwd"),
                "train.opt_ms": dev("train.opt"),
                "kernel.k5_calls": calls("kernel.k5"),
                "kernel.k6_calls": calls("kernel.k6"),
                "probe_k5_calls": record["k5"]["calls"],
                "probe_k6_calls": record["k6"]["calls"]}
    return {"prefill_attn_ms.serve": dev("model.attn"),
            "prefill_mlp_ms.serve": dev("model.mlp"),
            "prefill_head_ms": dev("model.head"),
            "prefill_cache_ms": dev("model.cache"),
            "serve.prefill_ms": dev("serve.prefill"),
            "kernel.k5_calls": calls("kernel.k5"),
            "probe_k5_calls": record["k5"]["calls"]}


def sync_check(cell: dict, seed: int) -> dict:
    """The program's synchronising calls (``set_sync_debug_mode``'s
    warnings raised from ``src/repro_torch``) beside its ``host_syncs``,
    over the training cell's first steps or one serving batch."""
    import torch
    from bench import program, weights
    from bench.drivers import serve, train
    from repro_torch.obs import lm
    cfg, traffic = cell["config"]["model"], cell["traffic"]
    dev = torch.device("cuda")
    src = str(ROOT / "src" / "repro_torch")
    with lm.tracing(dev) as tr, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if traffic["driver"] == "train":
                held = train.program_first_steps(cfg, traffic, seed, dev)
                root = "train.step"
            else:
                model = program.build_model(cfg, dev)
                with torch.no_grad():
                    params = weights.make(cfg, seed, dev)
                clients = serve.Clients(cfg, traffic, seed, dev)
                length, outputs = clients.middle()
                held = serve.serve_batch(
                    model, params, program.decode_step(model),
                    clients.prompts(length), outputs, clients.capacity)
                root = None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        records = tr.records()
    del held
    train.free()
    where: dict = {}
    for w in caught:
        if str(w.filename).startswith(src):
            at = f"{Path(w.filename).relative_to(ROOT)}:{w.lineno}"
            where[at] = where.get(at, 0) + 1
    roots = [r for r in records if r["parent"] is None
             and (root is None or r["name"] == root)]
    return {"program_sync_warnings": sum(where.values()), "at": where,
            "host_syncs": sum(r["attrs"].get("host_syncs", 0)
                              for r in roots),
            "roots": {n: sum(r["name"] == n for r in roots)
                      for n in sorted({r["name"] for r in roots})}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--order", default="off,on", choices=("off,on",
                                                          "on,off"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from bench import harness
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("torch_lm_spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from bench import program
    program.build_kernels()
    from repro_torch.obs import lm
    spec = harness.load_spec()
    cell = harness.resolve(spec, args.workload)
    traffic = cell["traffic"]
    result = {"workload": args.workload, "seed": args.seed,
              "card": harness.card_line()}
    for side in args.order.split(","):
        out, metrics, events, records = run_once(
            spec, cell, args.seed, args.seconds, side == "on")
        prof = out["profile"]
        result[side] = {"metrics": metrics, "correct": out["correct"],
                        "busy_s": prof["busy_s"],
                        "window_s": prof["window_s"],
                        "idle_gaps": prof["idle_gaps"]}
        if side == "off":
            continue
        result["on"]["idle_gaps_program"] = program_gaps(events)
        result["on"]["spans_dropped"] = lm.TRACER.stats()["spans_dropped"]
        rec = out["record"]
        if traffic["driver"] == "train":
            n = rec["steps"]
            win = window(records, "train.step", n, 2)
        else:
            n = out["attempted"] // traffic["batch"]
            win = window(records, "serve.prefill", n, 1)
        result["spans"] = lm.span_table(win)
        result["read"] = {"per": n, **readings(traffic["driver"],
                                               result["spans"], rec, n)}
        del records, win
    result["syncs"] = sync_check(cell, args.seed)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
