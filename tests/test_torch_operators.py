"""The port's five window operators against the JAX package's, on the
same numpy inputs: the per-window ``run``, the stacked ``run_batch``, the
block-table ``run_batch(table=)`` and the split-K ``run_batch(splitk=)``,
then engine-level batched-vs-JAX parity on the late-heavy case of
``tests/test_batch_exec.py``.

The port runs on the CPU here (``device="cpu"``), so its folds take the
kernels' plain torch versions. Tolerances: counts exact; min/max exact
(no arithmetic); sums and the values derived from them (means, averages,
percentiles) within rtol 1e-5 / atol 1e-5 x max|v| x rows, because the
summation order differs between the JAX scatters / one-hot matmuls and
torch's ``index_add_``.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import AionConfig as JAionConfig
from repro.core import StreamEngine as JStreamEngine
from repro.core import TumblingWindows as JTumbling
from repro.core.events import EventBatch as JEventBatch
from repro.core.operators import make_operator as j_make_operator
from repro.core.triggers import DeltaTTrigger as JDeltaT
from repro_torch.configs.base import AionConfig
from repro_torch.core import StreamEngine, TumblingWindows
from repro_torch.core.events import EventBatch
from repro_torch.core.operators import make_operator
from repro_torch.core.triggers import DeltaTTrigger

CAP, W, KEYS, B, P = 32, 3, 8, 7, 12
OPS = ("average", "bigrams", "stock", "lrb", "percentile")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(op_name):
    return {"stock": {"num_keys": KEYS}, "lrb": {"num_segments": KEYS},
            "bigrams": {"vocab": 16}}.get(op_name, {})


def _ops(op_name):
    return (j_make_operator(op_name, CAP, W, **_kw(op_name)),
            make_operator(op_name, CAP, W, device="cpu", **_kw(op_name)))


def _case(seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 3 * KEYS, (P, CAP)).astype(np.int32)
    values = rng.uniform(0.0, 20.0, (P, CAP, W)).astype(np.float32)
    values[:, ::5, 0] = 0.0                      # lrb's stopped vehicles
    table = rng.integers(0, P, B).astype(np.int32)
    fills = rng.integers(0, CAP + 1, B).astype(np.int32)
    slots = np.sort(rng.integers(0, 3, B)).astype(np.int32)
    return keys, values, table, fills, slots


def _close(got, want, scale, rows, what):
    """The stated tolerance, applied to a result of any operator."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], scale, rows, f"{what}[{k!r}]")
        return
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    np.testing.assert_allclose(g, w, rtol=1e-5,
                               atol=1e-5 * scale * max(rows, 1),
                               err_msg=what)


@pytest.mark.parametrize("op_name", OPS)
def test_run_matches_jax(op_name):
    """Per-window reference folds, block by block, on host arrays."""
    jop, top = _ops(op_name)
    keys, values, table, fills, _ = _case(1)
    blocks = [{"keys": keys[t], "values": values[t],
               "timestamps": np.zeros(CAP)} for t in table]
    want = jop.run(blocks, [int(f) for f in fills])
    got = top.run(blocks, [int(f) for f in fills])
    _close(got, want, 20.0, CAP * B, op_name)


@pytest.mark.parametrize("mode", ["stacked", "table", "splitk"])
@pytest.mark.parametrize("op_name", OPS)
def test_run_batch_matches_jax(op_name, mode):
    """One batched pass over three windows' rows: stacked rows, rows
    referenced out of the pool arenas, and split-K chunks of 2 rows."""
    jop, top = _ops(op_name)
    keys, values, table, fills, slots = _case(2)
    if mode == "stacked":
        data = {"keys": keys[table], "values": values[table]}
        kw = {}
    else:
        data = {"keys": keys, "values": values}
        kw = {"table": table, "splitk": 2 if mode == "splitk" else 0}
    want = jop.run_batch(data, fills, slots, 3, **kw)
    got = top.run_batch(
        {k: torch.from_numpy(v) for k, v in data.items()},
        torch.from_numpy(fills), torch.from_numpy(slots), 3,
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 20.0, CAP * B, f"{op_name} {mode} slot {i}")


def test_fold_batch_counts_launch_shapes():
    """``launch_shapes`` stands where the JAX package read its jit cache
    size: one entry per distinct (rows, slots, split-K, layout)."""
    _, top = _ops("stock")
    keys, values, table, fills, slots = _case(3)
    data = {"keys": torch.from_numpy(keys),
            "values": torch.from_numpy(values)}
    for _ in range(2):
        top.fold_batch(data, fills, slots, 3, table=table)
    top.fold_batch(data, fills, slots, 3, table=table, splitk=2)
    assert len(top.fold_batch.launch_shapes) == 2
    # a slot mesh that the 3 rows and slots do not divide
    from repro_torch.distributed.sharding import make_slot_mesh
    with pytest.raises(ValueError, match="divide"):
        top.fold_batch(data, fills, slots, 3, table=table,
                       mesh=make_slot_mesh(devices=["cpu"] * 2))


def test_operator_defaults_to_the_card():
    """No device given means CUDA; without CUDA that is an error, never a
    quiet fall back to the CPU."""
    if torch.cuda.is_available():
        assert make_operator("stock", CAP, W).init_acc()["sum"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_operator("stock", CAP, W)


# ------------------------------------------------ engine-level batched path
WINDOW = 10.0
N_WINDOWS = 8


def _engine(pkg, op_name, pooled):
    if pkg == "jax":
        aion = JAionConfig(block_size=CAP, block_pool=pooled)
        return JStreamEngine(
            assigner=JTumbling(WINDOW),
            operator=j_make_operator(op_name, CAP, 2, **_kw(op_name)),
            aion=aion, value_width=2, device_budget_bytes=64 << 20,
            trigger=JDeltaT(executions=2))
    aion = AionConfig(block_size=CAP, block_pool=pooled)
    return StreamEngine(
        assigner=TumblingWindows(WINDOW),
        operator=make_operator(op_name, CAP, 2, device="cpu",
                               **_kw(op_name)),
        aion=aion, value_width=2, device_budget_bytes=64 << 20,
        trigger=DeltaTTrigger(executions=2), device="cpu")


def _late_heavy(pkg, op_name, pooled, seed=7):
    """The late-heavy scenario of ``test_batch_exec``: every window
    expires at once, then a late wave lands in most of them."""
    eb = JEventBatch if pkg == "jax" else EventBatch
    eng = _engine(pkg, op_name, pooled)
    rng = np.random.default_rng(seed)
    horizon = N_WINDOWS * WINDOW
    n, nl = 1200, 400
    eng.ingest(eb(rng.integers(0, KEYS, n), rng.uniform(0, horizon, n),
                  rng.uniform(0, 20, (n, 2)).astype(np.float32)), now=0.0)
    eng.advance_watermark(horizon, now=horizon)
    eng.ingest(eb(rng.integers(0, KEYS, nl),
                  rng.uniform(0, horizon - WINDOW, nl),
                  rng.uniform(0, 20, (nl, 2)).astype(np.float32)),
               now=horizon + 1.0)
    for t in np.linspace(horizon + 1,
                         horizon + 1 + 2 * eng.cleanup.current_bound(), 12):
        eng.poll(t)
    # WindowId is a class of each package: key results by (start, end)
    results = {(w.start, w.end): r for w, r in eng.results.items()}
    metrics = (eng.metrics.batch_executions, eng.metrics.pooled_rows)
    eng.close()
    return results, metrics


@pytest.mark.parametrize("op_name,pooled", [
    ("stock", True), ("stock", False), ("average", True), ("lrb", True),
    ("bigrams", True), ("percentile", True)])
def test_engine_batched_matches_jax(op_name, pooled):
    want, _ = _late_heavy("jax", op_name, pooled)
    got, (batches, pooled_rows) = _late_heavy("torch", op_name, pooled)
    assert batches > 0
    assert (pooled_rows > 0) == pooled
    assert set(got) == set(want)
    for wid in want:
        _close(got[wid], want[wid], 20.0, 1600, f"{op_name} {wid}")
