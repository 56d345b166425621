"""Quickstart on the PyTorch/CUDA port: AION in ~60 lines, on the card.

An event-time stream with heavy lateness flows through a tumbling-window
average. Watch: (1) results are amended as late events arrive, (2) device
memory stays bounded because past-window state lives in the p-bucket,
(3) the staleness trigger schedules the minimum re-executions. The flow
and the lines printed are ``examples/quickstart.py``'s; the window state
lives in the card's block pool and every fold is a CUDA kernel.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
import numpy as np

from repro_torch.configs.base import AionConfig
from repro_torch.configs.workloads import AVERAGE
from repro_torch.core import (
    PeriodicWatermarkGenerator, StreamEngine, TumblingWindows,
)
from repro_torch.core.operators import make_operator
from repro_torch.data.generators import make_generator


def main(device=None):
    """Run the stream on ``device`` (``None``: the card)."""
    gen = make_generator(AVERAGE, seed=0)
    aion = AionConfig(block_size=512, max_staleness=0.05)
    engine = StreamEngine(
        assigner=TumblingWindows(AVERAGE.window_duration),
        operator=make_operator("average", aion.block_size, gen.width,
                               device=device),
        aion=aion,
        value_width=gen.width,
        watermark_gen=PeriodicWatermarkGenerator(AVERAGE.window_duration),
        device_budget_bytes=64 << 20,          # the m-bucket tier budget
        device=device,
    )
    # teach the lateness estimator quickly (normally learned online)
    engine.cleanup.min_history = 50
    engine.cleanup.coverage = 0.9

    wd = AVERAGE.window_duration
    now = 4 * wd
    for step in range(12):
        batch = gen.batch(3000, now)           # lognormal lateness (paper)
        engine.ingest(batch, now)
        engine.advance_watermark(now, now)
        engine.poll(now)
        if step % 3 == 0:
            print(f"t={now:7.1f}s  windows={len(engine.windows):3d} "
                  f"device={engine.device_bytes() / 2**20:6.1f}MB "
                  f"host={engine.host_bytes() / 2**20:6.1f}MB "
                  f"late_events={engine.metrics.ingested_late}")
        now += wd

    # drive planned late re-executions to amend past results
    for t in np.linspace(now, now + engine.cleanup.current_bound(), 20):
        engine.poll(t)

    print(f"\nexecutions: live={engine.metrics.live_executions} "
          f"late={engine.metrics.late_executions} "
          f"purged={engine.metrics.purged_windows}")
    print(f"io: {engine.io.stats['staged_blocks']} staged / "
          f"{engine.io.stats['destaged_blocks']} destaged blocks, "
          f"{engine.io.stats['preemptions']} destage preemptions")
    some = sorted(engine.results)[:3]
    for wid in some:
        print(f"window [{wid.start:.0f},{wid.end:.0f}): "
              f"avg={engine.results[wid]:.2f}")
    engine.close()
    return engine


if __name__ == "__main__":
    main()
