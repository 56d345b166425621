"""The paper's three mechanisms, end to end, on one stream, on the
PyTorch/CUDA port.

1. predictive cleanup — the engine learns the lateness distribution and
   tightens the purge bound from the conservative default;
2. staleness trigger — minimum re-executions to meet the staleness SLA,
   compared against the deltat/deltaev baselines (Fig. 9);
3. proactive caching — fetch-stall with and without pre-staging, on the
   card's block pool.

The lines printed are ``examples/late_event_stream.py``'s. The
pre-staging demo keeps its own copy of the Fig. 8 ablation's run
(``benchmarks/q3_ablation.py: run_one``) for its ``aion-full`` and
``no-pre-stgng`` variants, on the port's ``StreamEngine``.

    PYTHONPATH=src python examples/torch_late_event_stream.py
"""
import time

import numpy as np

from repro_torch.configs.base import AionConfig
from repro_torch.configs.workloads import AVERAGE
from repro_torch.core import StreamEngine, TumblingWindows
from repro_torch.core.cleanup import PredictiveCleanup
from repro_torch.core.operators import make_operator
from repro_torch.core.staleness import (
    deltaev_times, deltat_times, executions_for_bound, max_staleness_of,
    minimize_max_staleness,
)
from repro_torch.core.triggers import DeltaTTrigger
from repro_torch.data.generators import lateness_delays, make_generator

T = 100.0
#: the ablation's variants this demo runs (``q3_ablation.VARIANTS``)
VARIANTS = {
    "aion-full": dict(prestage_enabled=True, chunk_blocks=4,
                      sequential_io=True),
    "no-pre-stgng": dict(prestage_enabled=False, chunk_blocks=4,
                         sequential_io=True),
}


def cleanup_demo(rng):
    print("== predictive cleanup: adaptive max-allowed-lateness bound")
    c = PredictiveCleanup(coverage=0.99, confidence=0.95,
                          initial_bound=3600.0, min_history=100)
    for n in (100, 1000, 20000):
        c.observe(lateness_delays("lnorm", n, T, rng))
        print(f"  after {c.hist.total:6d} observations: "
              f"bound = {c.current_bound():9.2f}s "
              f"(conservative start was 3600s)")


def trigger_demo(rng):
    print("\n== staleness trigger vs deltat/deltaev (paper Fig. 9)")
    delays = lateness_delays("lnorm", 20000, T, rng)
    print(f"  {'K':>3s} {'aion':>9s} {'deltat':>9s} {'deltaev':>9s}")
    for k in (4, 8, 16):
        a = minimize_max_staleness(delays, T, k).max_staleness
        d = max_staleness_of(deltat_times(T, k), delays, T)
        e = max_staleness_of(deltaev_times(delays, T, k), delays, T)
        print(f"  {k:3d} {a:9.4f} {d:9.4f} {e:9.4f}")
    for bound in (0.1, 0.05, 0.01):
        ka = executions_for_bound(
            lambda k: minimize_max_staleness(delays, T, k).times,
            delays, T, bound)
        kt = executions_for_bound(lambda k: deltat_times(T, k), delays, T,
                                  bound)
        ke = executions_for_bound(lambda k: deltaev_times(delays, T, k),
                                  delays, T, bound)
        print(f"  bound {bound}: aion needs K={ka}, deltat K={kt}, "
              f"deltaev K={ke}")


def run_one(variant: str, past_windows: int = 4, device=None) -> dict:
    """One ablation run on ``average`` under a late-heavy phase with a
    simulated persistent tier (``q3_ablation.run_one``'s loop)."""
    kw = VARIANTS[variant]
    gen = make_generator(AVERAGE, seed=7)
    aion = AionConfig(block_size=128)
    op = make_operator("average", aion.block_size, gen.width, device=device)
    eng = StreamEngine(
        assigner=TumblingWindows(AVERAGE.window_duration),
        operator=op, aion=aion, value_width=gen.width,
        device_budget_bytes=64 << 20,
        trigger=DeltaTTrigger(executions=2),
        simulated_seconds_per_byte=1e-8,       # ~100 MB/s persistent tier
        device=device, **kw,
    )
    wd = AVERAGE.window_duration
    # prime the lateness estimator so the re-execution horizon is short and
    # late re-executions actually fire within the measured run
    eng.cleanup.min_history = 10
    eng.cleanup.coverage = 0.9
    eng.cleanup.observe(np.random.default_rng(0).uniform(0.5, 1.5 * wd,
                                                         2000))
    now = past_windows * wd
    t0 = time.time()
    events = 0
    for _ in range(10):
        batch = gen.batch(1500, now)
        batch.timestamps = np.maximum(batch.timestamps,
                                      now - past_windows * wd)
        eng.ingest(batch, now)
        events += len(batch)
        eng.advance_watermark(now, now)
        # drive late re-executions inside the horizon; pace the polls in
        # wall time (~100x faster than real time) so the persistent-tier
        # channel has wall-clock room to work ahead
        for t in np.linspace(now + wd / 4, now + wd, 4):
            eng.poll(t)
            time.sleep(0.05)
        now += wd
    eng.io.drain()
    dt = time.time() - t0
    obs = eng.observability()
    out = {
        "variant": variant,
        "events_per_sec": events / dt,
        "late_execs": obs["engine"]["late_executions"],
        "fetch_stall_s": round(obs["engine"]["fetch_stall_seconds"], 4),
        "staged_blocks": obs["io"]["staged_blocks"],
    }
    eng.close()
    return out


def prestage_demo(device=None):
    print("\n== proactive caching: fetch stall with/without pre-staging")
    for variant in VARIANTS:
        r = run_one(variant, device=device)
        print(f"  {variant:14s} fetch_stall={r['fetch_stall_s']:.3f}s "
              f"late_execs={r['late_execs']}")


def main(device=None):
    """The three demos; the pre-staging runs on ``device`` (``None``: the
    card)."""
    rng = np.random.default_rng(0)
    cleanup_demo(rng)
    trigger_demo(rng)
    prestage_demo(device)


if __name__ == "__main__":
    main()
