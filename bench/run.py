"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: the cell, its configuration, traffic mix,
driver and metrics are found by name from ``BENCHMARK.json`` (see
``bench/harness.py``). The program is ``src/repro_torch``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit); the last lines
of standard error repeat the checks. Without a card, or with fewer than
the cell asks for, it prints no result and exits 2; if JAX or the JAX
package was loaded, it exits 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    spec = harness.load_spec()
    cell = harness.resolve(spec, args.workload)["cell"]
    import torch
    torch.set_num_threads(4)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"no result: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s), found {found}", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr)
    t = time.perf_counter()
    from bench import program
    built = program.build_kernels()
    print(f"kernels built or loaded in {built:.3f} s (import and set-up "
          f"before: {t - T0:.3f} s)", file=sys.stderr)
    result = harness.run_cell(spec, args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line, notes = harness.finish(result)
    print("\n".join(notes), file=sys.stderr)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
