"""``HeartbeatMonitor`` and ``EngineRecovery`` on the port:
``tests/test_fault_serve.py``'s cases of each through
``repro_torch.distributed`` on the CPU, the heartbeats beside the JAX
monitor on the same beats. (``BackupExecutor`` and ``RestartManager`` are
held in ``tests/test_torch_pipeline.py`` and ``tests/test_torch_train.py``.)
"""
import numpy as np
import pytest

from repro.distributed.fault import HeartbeatMonitor as JaxHeartbeatMonitor
from repro_torch.distributed import EngineRecovery, HeartbeatMonitor
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_heartbeat_detects_dead_worker():
    hb = HeartbeatMonitor(timeout=1.0)
    hb.beat("w0", now=0.0)
    hb.beat("w1", now=0.0)
    hb.beat("w0", now=5.0)
    assert hb.dead_workers(now=5.5) == ["w1"]
    assert hb.alive_workers(now=5.5) == ["w0"]


def test_heartbeat_timeout_edges():
    """Exactly-at-timeout is alive (strict >); just past it is dead; a
    fresh beat resurrects; an unknown worker is neither. The JAX monitor
    answers the same on the same beats."""
    for cls in (HeartbeatMonitor, JaxHeartbeatMonitor):
        hb = cls(timeout=1.0)
        hb.beat("w0", now=0.0)
        assert hb.dead_workers(now=1.0) == []
        assert hb.alive_workers(now=1.0) == ["w0"]
        assert hb.dead_workers(now=1.0 + 1e-9) == ["w0"]
        hb.beat("w0", now=2.0)
        assert hb.alive_workers(now=2.5) == ["w0"]
        assert hb.dead_workers(now=2.5) == []
        assert "ghost" not in hb.alive_workers(now=2.5) \
            and "ghost" not in hb.dead_workers(now=2.5)


def test_engine_recovery_checkpoint_restore_roundtrip(tmp_path):
    from repro_torch.configs.base import AionConfig
    from repro_torch.core import (
        EventBatch, StreamEngine, TumblingWindows, make_operator,
    )
    rng = np.random.default_rng(11)
    batch = EventBatch(rng.integers(0, 8, 96), rng.uniform(0.0, 10.0, 96),
                       rng.normal(size=(96, 1)).astype(np.float32))
    aion = AionConfig(block_size=32)

    def factory():
        # reopening the store directory IS the WAL replay
        return StreamEngine(
            assigner=TumblingWindows(10.0),
            operator=make_operator("average", aion.block_size, 1,
                                   device="cpu"),
            aion=aion, value_width=1, spill_dir=tmp_path, device="cpu")

    rec = EngineRecovery(factory, max_restarts=2)
    assert not rec.has_checkpoint
    eng = factory()
    eng.ingest(batch, now=1.0)
    rec.checkpoint(eng, token=96)
    assert rec.has_checkpoint
    eng.close()

    eng2, token = rec.restore()
    assert token == 96
    assert sum(s.total_events for s in eng2.windows.values()) == 96
    eng2.advance_watermark(10.0, now=2.0)
    result = next(iter(eng2.results.values()))
    assert result == pytest.approx(
        float(batch.values[:, 0].astype(np.float64).mean()), abs=1e-6)
    eng2.close()

    eng3, _ = rec.restore()
    eng3.close()
    with pytest.raises(RuntimeError, match="max_restarts"):
        rec.restore()


def test_engine_recovery_requires_checkpoint():
    rec = EngineRecovery(lambda: None, max_restarts=1)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        rec.restore()
