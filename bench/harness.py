"""The harness: one cell of ``BENCHMARK.json`` run once, driven by data.

A cell names a configuration (``bench/configs/<file>``, the sizes as run;
its block family's plain reference is ``bench/reference/<family>.py``)
and a traffic mix (``bench/traffic/<traffic>.json``, its parameters and
the name of the driver that runs it, ``bench/drivers/<driver>.py``).
Every metric is a reader of its own, ``bench/metrics/<metric>.py``,
whose ``read(record)`` takes the driver's record of the run and returns
the number, or None where it finds nothing to read. A later cell, mix,
metric or block family is new files and an entry in ``BENCHMARK.json``;
nothing here names one.

Also here: the probes that time the program's entry points on CUDA
events from outside it (``Probe``), the profiled segment and its reading
(``profile_segment``), and the check that nothing of JAX was loaded.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class UnknownName(KeyError):
    """A cell, configuration, traffic mix, driver or metric that the
    benchmark does not define."""


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_module(path: Path, what: str, name: str):
    if not path.is_file():
        raise UnknownName(f"no {what} {name!r} ({path} is missing)")
    mod_name = "bench_" + what + "_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` with its configuration file, its traffic
    file and its driver module, found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise UnknownName(f"unknown workload {workload!r}; known: "
                          f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if cell["config"] not in configs:
        raise UnknownName(f"unknown config {cell['config']!r}")
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    family = config["model"]["family"]
    if not (root / "bench" / "reference" / f"{family}.py").is_file():
        raise UnknownName(f"no reference for the {family!r} family")
    traffic_path = root / "bench" / "traffic" / f"{cell['traffic']}.json"
    if not traffic_path.is_file():
        raise UnknownName(f"unknown traffic {cell['traffic']!r}")
    with open(traffic_path) as f:
        traffic = json.load(f)
    driver = _load_module(root / "bench" / "drivers" /
                          f"{traffic['driver']}.py", "driver",
                          traffic["driver"])
    return {"cell": cell, "config": config, "traffic": traffic,
            "driver": driver}


def metrics_for(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` list only in those cells."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def read_metrics(metrics: List[dict], record: dict,
                 root: Path = ROOT) -> Dict[str, dict]:
    """Each metric's reader over the run's record; a reader that finds
    nothing returns None and its metric is left out."""
    out = {}
    for m in metrics:
        reader = _load_module(root / "bench" / "metrics" /
                              f"{m['name']}.py", "metric", m["name"])
        value = reader.read(record)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN``, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the port's nvcc libraries are at ``build/kernels`` by
    its own code)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else out.stderr.strip()


# ------------------------------------------------------------- timing
class Clock:
    """Stamps on the device's clock (CUDA events) for a CUDA device, on
    the host's for the CPU (rehearsals only)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def seconds(self, a, b) -> float:
        return (b - a) if not self.cuda else a.elapsed_time(b) / 1e3

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()


class Probe:
    """While entered, wraps callables of the program (``targets``: name ->
    (object, attribute)) so that each call is stamped before and after on
    the device's clock and opens a host span ``bench:<name>`` that the
    profiler sees. ``stamps[name]`` holds each call's pair of stamps,
    ``seconds(name)`` sums them."""

    def __init__(self, clock: Clock, targets: Dict[str, tuple]):
        self.clock = clock
        self.targets = targets
        self.stamps: Dict[str, list] = {n: [] for n in targets}
        self._saved = {}

    def __enter__(self):
        for name, (obj, attr) in self.targets.items():
            real = getattr(obj, attr)
            self._saved[name] = (obj, attr, real, attr in vars(obj))
            setattr(obj, attr, self._wrap(name, real))
        return self

    def __exit__(self, *exc):
        for obj, attr, real, own in self._saved.values():
            if own:
                setattr(obj, attr, real)
            else:
                delattr(obj, attr)
        return False

    def _wrap(self, name: str, real: Callable):
        import torch
        stamps = self.stamps[name]

        def probed(*a, **kw):
            with torch.profiler.record_function("bench:" + name):
                start = self.clock.stamp()
                out = real(*a, **kw)
                stamps.append((start, self.clock.stamp()))
            return out
        return probed

    def seconds(self, name: str) -> float:
        return sum(self.clock.seconds(a, b) for a, b in self.stamps[name])

    def calls(self, name: str) -> int:
        return len(self.stamps[name])


@contextmanager
def span(name: str):
    """A host span of the benchmark's own, seen by the profiler."""
    import torch
    with torch.profiler.record_function("bench:" + name):
        yield


def profile_segment(fn: Callable[[], None], device) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA) and read the
    trace: the device's busy seconds (the union of its kernels, copies and
    sets) within the segment's host span, the span's length, the ten
    device ops that took most time and the idle gaps summed by the
    benchmark span (``bench:*``) open on the host at each gap's middle."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("bench:segment"):
            fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return read_trace(trace.get("traceEvents", trace))


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(events: list) -> dict:
    """``profile_segment``'s reading of chrome-trace events (times in
    microseconds)."""
    seg = [e for e in events if e.get("ph") == "X"
           and e.get("name") == "bench:segment"
           and e.get("cat") == "user_annotation"]
    if not seg:
        raise ValueError("the profiled segment's span is not in the trace")
    w0 = float(seg[0]["ts"])
    w1 = w0 + float(seg[0]["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e.get("name", "?"))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in DEVICE_CATS)
    ops: Dict[str, float] = {}
    merged: List[list] = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ops[name] = ops.get(name, 0.0) + (b - a)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"][len("bench:"):])
                  for e in events if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("bench:")
                  and e.get("name") != "bench:segment"
                  and e.get("cat") == "user_annotation")
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label, best = "host outside the benchmark's spans", None
        for h0, h1, name in host:
            if h0 <= mid <= h1 and (best is None or h1 - h0 < best):
                label, best = name, h1 - h0
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n[:200], s / 1e6] for n, s in top],
            "idle_gaps": [[n[:200], s / 1e6] for n, s in top_gaps]}


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks, over every value."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run_cell(spec: dict, workload: str, *, seed: int, seconds: float,
             trace: bool, device, t0: float, root: Path = ROOT,
             config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> dict:
    """One run of ``workload``: its driver, then its metrics' readers over
    the driver's record. Returns the result line's object, the numbers
    compared (``checks``) last. ``config`` and ``traffic`` stand in for
    the cell's files (the tests' small sizes)."""
    cell = resolve(spec, workload, root)
    ctx = {"config": config or cell["config"],
           "traffic": traffic or cell["traffic"], "seed": int(seed),
           "seconds": float(seconds), "trace": bool(trace),
           "device": device, "t0": t0, "cell": cell["cell"]}
    out = cell["driver"].run(ctx)
    metrics = read_metrics(metrics_for(spec, workload, trace), out["record"],
                           root)
    import torch
    dev = torch.device(device)
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda"
                         else dev.type,
                         "kind": torch.cuda.get_device_name(0)
                         if dev.type == "cuda" else "cpu",
                         "count": int(cell["cell"]["chips"]),
                         "memory_peak_bytes": int(out["memory_peak_bytes"])}}
    if trace:
        prof = out["profile"]
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = out["checks"]
    result["_where"] = {**out.get("where", {}), **out.get("phases", {})}
    return result


def finish(result: dict) -> tuple:
    """(the result line, the lines for standard error): the run's notes,
    then each number compared beside its limit, last."""
    result = dict(result)
    notes = [f"where: {json.dumps(result.pop('_where', {}))}"]
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        notes.append(f"check {name} {c['value']!r} limit {c['limit']!r} "
                     f"{verdict}")
    return json.dumps(result), notes
