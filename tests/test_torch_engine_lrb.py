"""Linear Road through both engines, and the CPU rehearsal of
``chip_smoke.py``'s phase 12.

One small Linear Road stream (a few 10 s windows, 4 road segments, width
2: speed and lane, heavy lateness, spill pressure onto the log store)
goes through the JAX package's ``StreamEngine`` and the port's
(``device="cpu"``), with the block pool on (the operator gathers the
table's rows, then folds through K1) and off (the stacked fold). Every
window of both agrees with the other engine and with the numpy oracle of
``chip_smoke.lrb_oracle``. Tolerances: count, accident and toll exact;
avg_speed within rtol 1e-5 and atol 1e-5 x the largest speed (the sum's
order differs).

The rehearsal runs phase 12 itself at a small rate and width on the CPU,
under the smoke's ``LaunchRecorder``, and replays K1's largest launch as
phase 3 does: a stacked [B, cap, 2] launch whose two columns are read.
On the CPU both sides of the replay take the plain version, so only the
set-up and the checks are tested."""
import numpy as np
import pytest
import torch

import chip_smoke
import repro.configs.base as jcfg
import repro.core as jcore
import repro.core.batch_exec as jbx
import repro.core.cleanup as jcleanup
import repro.core.events as jev
import repro.core.operators as jops
import repro_torch.configs.base as tcfg
import repro_torch.core as tcore
import repro_torch.core.batch_exec as tbx
import repro_torch.core.cleanup as tcleanup
import repro_torch.core.events as tev
import repro_torch.core.operators as tops

WINDOW = 10.0
CAP, WIDTH, SEGMENTS = 32, 2, 4
N_EVENTS, CHUNK = 2400, 120
MAX_LATE = 30.0
SEED = 4321
PKGS = {"jax": (jcfg, jcore, jbx, jcleanup, jev, jops),
        "torch": (tcfg, tcore, tbx, tcleanup, tev, tops)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedule():
    """(now, keys, timestamps, values, watermark or None) steps from the
    seed: speeds ~ N(55, 20) clipped at 0 with 1.5% stopped (0), lanes
    0-3, most events late by up to MAX_LATE. About 120 events fall on a
    segment of a window: enough for tolls (past 50) and for about half of
    them to see 2 stopped vehicles (an accident)."""
    rng = np.random.default_rng(SEED)
    steps, now, wm = [], 0.0, 0.0
    for _ in range(N_EVENTS // CHUNK):
        delay = np.where(rng.random(CHUNK) < 0.4,
                         rng.uniform(0.0, 2.0, CHUNK),
                         rng.uniform(0.0, MAX_LATE, CHUNK))
        ts = np.maximum(now - delay, 0.0)
        keys = rng.integers(0, SEGMENTS, CHUNK)
        vals = np.zeros((CHUNK, WIDTH), np.float32)
        vals[:, 0] = np.maximum(rng.normal(55, 20, CHUNK), 0)
        vals[rng.random(CHUNK) < 0.015, 0] = 0.0
        vals[:, 1] = rng.integers(0, 4, CHUNK)
        adv = None
        if rng.random() < 0.7:
            wm = max(wm, now - rng.uniform(0.0, 5.0))
            adv = wm
        steps.append((now, keys, ts, vals, adv))
        now += rng.uniform(1.0, 4.0)
    return steps, now


STEPS, END = _schedule()


def _run(pkg, spill_dir, pooled):
    cfg, core, bx, cleanup, ev, ops = PKGS[pkg]

    class NoPurge(cleanup.PredictiveCleanup):
        # the oracle keeps every event: no window is ever purged
        def should_purge(self, window_end, watermark):
            return False

    dev = {} if pkg == "jax" else {"device": "cpu"}
    eng = core.StreamEngine(
        assigner=core.TumblingWindows(WINDOW),
        operator=ops.make_operator("lrb", CAP, WIDTH,
                                   num_segments=SEGMENTS, **dev),
        aion=cfg.AionConfig(block_size=CAP, block_pool=pooled, pool_slots=12,
                            store_segment_bytes=32 << 10),
        value_width=WIDTH,
        cleanup=NoPurge(initial_bound=60.0, min_history=1 << 62),
        device_budget_bytes=1 << 15, host_budget_bytes=1 << 13,
        spill_dir=spill_dir, **dev)
    for now, keys, ts, vals, adv in STEPS:
        eng.ingest(ev.EventBatch(keys, ts, vals), now)
        if adv is not None:
            eng.advance_watermark(adv, now)
        eng.poll(now)
        if pkg == "jax":
            # the reference steps with its I/O thread idle: the JAX engine
            # loses events that ingest appends while that thread spills or
            # stages the same block (ROADMAP Queue 3, item 18)
            assert eng.io.drain()
    # close out: expire everything, then re-execute every window once
    eng.advance_watermark(END + MAX_LATE, END)
    for t in np.linspace(END, END + 70.0, 6):
        eng.poll(t)
    assert eng.io.drain()
    eng.batch_exec.execute([bx.BatchWorkItem(w, eng.windows[w], True)
                            for w in sorted(eng.windows)], END + 70.0)
    results = {(w.start, w.end): r for w, r in eng.results.items()}
    m = eng.metrics
    counts = (m.late_executions, m.pooled_rows)
    eng.close()
    return results, counts


def _oracle():
    return chip_smoke.lrb_oracle(
        np.concatenate([s[1] for s in STEPS]),
        np.concatenate([s[2] for s in STEPS]),
        np.concatenate([s[3] for s in STEPS])[:, 0], WINDOW, SEGMENTS)


def _agree(got, want):
    """Every window: count, accident and toll exact, avg_speed within
    the stated tolerance (``chip_smoke.hold_lrb``)."""
    assert set(got) == set(want)
    max_v = float(max(s[3][:, 0].max() for s in STEPS))
    for wid in want:
        ref = {k: np.asarray(v) for k, v in want[wid].items()}
        chip_smoke.hold_lrb(wid, got[wid], ref, SEGMENTS, max_v)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return {pooled: _run("jax", tmp_path_factory.mktemp(f"jax{pooled}"),
                         pooled) for pooled in (True, False)}


@pytest.mark.parametrize("pooled", [True, False])
def test_lrb_engines_agree_with_each_other_and_the_oracle(jax_runs, tmp_path,
                                                          pooled):
    want, (jlate, jpooled) = jax_runs[pooled]
    got, (late, pooled_rows) = _run("torch", tmp_path, pooled)
    oracle = _oracle()
    assert len(oracle) >= 4
    _agree(got, oracle)
    _agree(want, oracle)
    _agree(got, want)
    assert late > 0 and jlate > 0
    assert (pooled_rows > 0) == pooled and (jpooled > 0) == pooled


def test_the_oracle_sees_accidents_and_tolls():
    """The stream exercises every field the check holds exactly: some
    segments with an accident, some with a toll."""
    oracle = _oracle()
    assert any(r["accident"].any() for r in oracle.values())
    assert any((r["toll"] > 0).any() for r in oracle.values())
    assert not all(r["accident"].all() for r in oracle.values())


# ------------------------------------------------ phase 12's CPU rehearsal
def test_phase12_rehearsal_records_and_replays_two_columns(tmp_path):
    """Phase 12 small on the CPU: the Linear Road deployment's run holds
    every window to the oracle inside ``run_stream``; the recorder keeps a
    stacked K1 launch that reads both columns of [speed, stopped], whose
    partial fits shared memory; its replay passes phase 3's checks on both
    designs; its bound counts 4 bytes a row."""
    with chip_smoke.LaunchRecorder() as rec:
        run = chip_smoke.run_stream(
            torch.device("cpu"), operator="lrb", windows=3, rate=200,
            width=8, pool_slots=32, splitk=0, seed=12, spill_root=tmp_path,
            host_budget=1 << 20, step_seconds=3.0, profile=True)
    assert run["operator"] == "lrb" and run["windows"] >= 3
    c = run["counts"]
    assert c["late_executions"] > 0 and c["pooled_rows"] > 0
    assert c["fallback_rows"] > 0
    assert chip_smoke.fold_profile(run) is None     # no device time here
    k1 = rec.largest["K1"]
    b, cap, w = k1["values"].shape
    assert (cap, w, k1["row_width"]) == (512, 2, 2)
    assert k1["stats"] == ("sum", "count") and k1["num_segments"] == 256
    assert rec.fits["K1"] > 0 and not rec.fits["K2"]
    rp = chip_smoke.replay("K1", k1, torch.Generator().manual_seed(0))
    assert rp["read"].shape == (b, cap, 2)
    assert torch.equal(rp["read"], k1["values"])
    assert chip_smoke.check_replay("K1", rp) < 1e-3
    valid = k1["valid"]
    n_valid = int(valid.sum())
    bound, by = chip_smoke._bound(valid.numel(), n_valid, 2, b,
                                  k1["num_slots"] * 256, k1["stats"], 4)
    nbytes = (valid.numel() + n_valid * 12 + 4 * b
              + k1["num_slots"] * 256 * 12)
    assert by == "bytes"
    assert bound == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
