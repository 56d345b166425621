"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size. Not run by the benchmark's own runs.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3]

One JSON line a seed: the program's readings against the float32
reference (its lower readings); on ``--control-seeds`` the control's, the
reference itself computed with every product's inputs rounded to fp8
(the precision below the configuration's bf16) in the program's place;
on ``--fault-seeds`` the program with a planted fault (training: half the
batch; serving: every served token altered). Training reads the first
steps, as a run's set-up does; serving one cycle of its traffic at the
cell's load, as a window does, through the same sample and reference.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench import compare, faults, harness, program, weights  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def train_line(cell, seed, control, fault, dev) -> dict:
    from bench.drivers import train as tr
    cfg, traffic = cell["config"]["model"], cell["traffic"]
    t = time.perf_counter()
    prog, batches = tr.program_first_steps(cfg, traffic, seed, dev)[4:]
    tr.free()
    line = {"seed": seed, "program_s": time.perf_counter() - t}
    t = time.perf_counter()
    ref32 = tr.reference_steps(cfg, traffic, seed, batches, dev)
    line["reference_s"] = time.perf_counter() - t
    line["program"] = compare.train_readings(prog, ref32)
    if control:
        ref8 = tr.reference_steps(cfg, traffic, seed, batches, dev, "fp8")
        line["control"] = compare.train_readings(ref8, ref32)
    if fault:
        with faults.half_batch():
            half = tr.program_first_steps(cfg, traffic, seed, dev)[4]
        tr.free()
        line["half_batch"] = compare.train_readings(half, ref32)
    return line


def serve_line(cell, seed, control, fault, dev) -> dict:
    from bench.drivers import serve as sv
    cfg, traffic = cell["config"]["model"], cell["traffic"]
    model = program.build_model(cfg, dev)
    params = weights.make(cfg, seed, dev)
    decode = program.decode_step(model)
    clients = sv.Clients(cfg, traffic, seed, dev)

    def cycle():
        return sv.serve_cycle(model, params, decode, clients)

    t = time.perf_counter()
    batches = cycle()
    line = {"seed": seed, "program_s": time.perf_counter() - t}
    bad = None
    if fault:
        with faults.token_altered(cfg["vocab_size"]):
            bad = cycle()
    del model, params, decode
    sv.free()
    t = time.perf_counter()
    picks = sv.sample(batches, traffic["check_requests"], seed)
    ref = sv.reference_gaps(cfg, seed, batches, picks, dev,
                            judge="fp8" if control else "")
    line["reference_s"] = time.perf_counter() - t
    line["program"] = {"gap": ref["gap"], "tokens": ref["tokens"]}
    if control:
        line["control"] = {"gap": ref["control_gap"]}
    if bad is not None:
        picks = sv.sample(bad, traffic["check_requests"], seed)
        line["token_altered"] = {"gap": sv.reference_gaps(
            cfg, seed, bad, picks, dev)["gap"]}
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args()
    harness.set_cache_dirs()
    cell = harness.resolve(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    program.build_kernels()
    dev = torch.device("cuda")
    control, fault = set(seeds(args.control_seeds)), set(
        seeds(args.fault_seeds))
    line_of = serve_line if cell["traffic"]["driver"] == "serve" \
        else train_line
    for seed in seeds(args.seeds):
        line = line_of(cell, seed, seed in control, seed in fault, dev)
        line["workload"] = args.workload
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
