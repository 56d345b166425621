"""The I/O executor's failure contract on the port:
``tests/test_staging_failures.py``'s 12 cases through ``repro_torch`` on
the CPU. Errors land on the task's ``TaskHandle`` and re-raise for demand
waiters, ``drain`` reports a timeout as ``False``, the close and
checkpoint paths refuse to proceed past a failed drain, a failed demand
stage aborts the fold, and the weighted round robin keeps its order
within a priority class.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.configs.base import AionConfig
from repro_torch.core import (
    EventBatch, StreamEngine, TumblingWindows, make_operator,
)
from repro_torch.core.buckets import MemoryBudget
from repro_torch.core.staging import (
    IOScheduler, PRIO_DEMAND_STAGE, PRIO_STAGE, StagingError, TaskHandle,
    TransferExecutor,
)
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


def _batch(n, width=1, seed=0, lo=0.0, hi=10.0):
    rng = np.random.default_rng(seed)
    return EventBatch(rng.integers(0, 8, n), rng.uniform(lo, hi, n),
                      rng.normal(size=(n, width)).astype(np.float32))


# ------------------------------------------------------------ TaskHandle
def test_task_handle_check_raises_staging_error():
    h = TaskHandle()
    h.error = ValueError("disk on fire")
    h.set()
    with pytest.raises(StagingError, match="disk on fire"):
        h.check()
    with pytest.raises(StagingError):
        h.wait_checked(1.0)


def test_task_handle_clean_completion():
    h = TaskHandle()
    h.set()
    h.check()                              # no error -> no raise
    assert h.wait_checked(1.0) is True


# ------------------------------------------- executor error surfacing
def test_executor_records_task_exception_sequential():
    ex = TransferExecutor(sequential_io=True)
    try:
        def boom():
            raise IOError("short read")
        h = ex.submit(0, boom)
        assert h.wait(5.0)
        assert isinstance(h.error, IOError)
        with pytest.raises(StagingError, match="short read"):
            h.check()
        assert ex.stats["errors"] == 1
        assert "short read" in ex.stats["last_error"]
        # the worker thread survived the exception
        h2 = ex.submit(0, lambda: None)
        assert h2.wait_checked(5.0)
        assert ex.stats["executed"] == 2
    finally:
        ex.shutdown()


def test_executor_records_task_exception_pooled():
    # the no-sqntl-io ablation path must surface failures the same way
    ex = TransferExecutor(sequential_io=False, max_pool_workers=2)
    try:
        def boom():
            raise RuntimeError("pool boom")
        h = ex.submit(0, boom)
        assert h.wait(5.0)
        with pytest.raises(StagingError, match="pool boom"):
            h.check()
        assert ex.stats["errors"] == 1
    finally:
        ex.shutdown()


def test_executor_on_error_callback_feeds_scheduler_stats():
    budget = MemoryBudget(1 << 20)
    io = IOScheduler(budget, device="cpu")
    try:
        def boom():
            raise OSError("stage failed")
        h = io.submit(PRIO_STAGE, boom)
        assert h.wait(5.0)
        assert io.stats["errors"] == 1
        assert "stage failed" in io.last_error
        assert "stage failed" in io.executor.stats["last_error"]
    finally:
        io.shutdown()


def test_drain_returns_false_on_timeout_and_true_after():
    ex = TransferExecutor(sequential_io=True)
    try:
        release = threading.Event()
        ex.submit(0, lambda: release.wait(10.0))
        time.sleep(0.05)                   # let the worker pick it up
        assert ex.drain(timeout=0.2) is False
        release.set()
        assert ex.drain(timeout=5.0) is True
    finally:
        release.set()
        ex.shutdown()


def test_ioscheduler_drain_propagates_bool():
    budget = MemoryBudget(1 << 20)
    io = IOScheduler(budget, device="cpu")
    try:
        release = threading.Event()
        io.submit(PRIO_STAGE, lambda: release.wait(10.0))
        time.sleep(0.05)
        assert io.drain(timeout=0.2) is False
        release.set()
        assert io.drain(timeout=5.0) is True
    finally:
        release.set()
        io.shutdown()


# ------------------------------------------------- engine-level contract
def _small_engine(tmp_path, **aion_kw):
    aion = AionConfig(block_size=32, **aion_kw)
    return StreamEngine(
        assigner=TumblingWindows(10.0),
        operator=make_operator("average", aion.block_size, 1, device="cpu"),
        aion=aion, value_width=1, spill_dir=tmp_path, device="cpu")


def test_engine_close_raises_on_failed_drain(tmp_path):
    eng = _small_engine(tmp_path)
    eng.ingest(_batch(64), now=1.0)
    release = threading.Event()
    eng.io.submit(PRIO_STAGE, lambda: release.wait(10.0))
    time.sleep(0.05)
    with pytest.raises(RuntimeError, match="drain"):
        eng.close(drain_timeout=0.2)
    release.set()
    eng.close()                            # second attempt drains cleanly


def test_checkpoint_manifest_raises_on_failed_drain(tmp_path):
    eng = _small_engine(tmp_path)
    eng.ingest(_batch(64), now=1.0)
    release = threading.Event()
    eng.io.submit(PRIO_STAGE, lambda: release.wait(10.0))
    time.sleep(0.05)
    with pytest.raises(RuntimeError, match="drain"):
        eng.checkpoint_state(include_stored_data=False, drain_timeout=0.2)
    release.set()
    eng.close()


def test_demand_stage_failure_reaches_execute_window(tmp_path):
    """A stage task that raises mid-batch must abort the fold loudly,
    not emit a result computed from missing rows."""
    eng = _small_engine(tmp_path)
    eng.ingest(_batch(200, seed=3), now=1.0)
    wid, st = next(iter(eng.windows.items()))
    # destage everything so execution needs a real demand stage
    for blk in list(st.blocks):
        eng.io.destage_block_sync(blk)
    assert st.p_blocks()

    def failing_stage(block, *a, **kw):
        raise IOError("injected stage failure")
    eng.io.stage_block_sync = failing_stage
    with pytest.raises((StagingError, IOError)):
        eng.execute_window(wid, now=2.0, late=False)
    assert eng.io.stats["errors"] >= 1
    assert "injected stage failure" in eng.io.last_error
    del eng.io.stage_block_sync            # restore so close() can drain
    eng.close()


# ---------------------------------------------------- WRR fairness order
def test_weighted_round_robin_within_priority_class():
    ex = TransferExecutor(sequential_io=True)
    try:
        ex.set_weight("A", 2)
        ex.set_weight("B", 1)
        order = []
        gate = threading.Event()
        # hold the worker on a low-priority task while we enqueue the
        # contended class, so pops happen from a fully-loaded queue
        ex.submit(0, lambda: gate.wait(10.0))
        time.sleep(0.05)
        for i in range(4):
            ex.submit(5, lambda t="A": order.append(t), tenant="A")
            ex.submit(5, lambda t="B": order.append(t), tenant="B")
        gate.set()
        assert ex.drain(timeout=5.0)
        # weight-2 tenant gets two consecutive slots per cycle
        assert order[:6] == ["A", "A", "B", "A", "A", "B"]
        assert ex.stats["tenant_executed"]["A"] == 4
        assert ex.stats["tenant_executed"]["B"] == 4
    finally:
        ex.shutdown()


def test_priority_classes_still_dominate_fairness():
    """Cross-class the lattice rules: any lower-numbered class runs
    before WRR even looks at the higher-numbered one."""
    ex = TransferExecutor(sequential_io=True)
    try:
        order = []
        gate = threading.Event()
        ex.submit(0, lambda: gate.wait(10.0))
        time.sleep(0.05)
        ex.submit(5, lambda: order.append("low"), tenant="A")
        ex.submit(PRIO_DEMAND_STAGE,
                  lambda: order.append("demand"), tenant="B")
        gate.set()
        assert ex.drain(timeout=5.0)
        assert order == ["demand", "low"]
    finally:
        ex.shutdown()
