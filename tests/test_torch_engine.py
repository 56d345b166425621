"""One event stream through both engines: the JAX package's
``StreamEngine`` and the port's, with the stock operator at small width,
heavy lateness, random watermark advances, polls, and spill pressure onto
the log store (tiny device and host budgets, a pool smaller than the live
state). Both must agree with each other and with a never-spilling numpy
oracle (``tests/test_soak_differential.py``'s ``_oracle_stock``, with its
close-out). Further runs: split-K on; and a JAX checkpoint taken
mid-stream, carried into the port through ``engine_state_from_jax`` and
resumed, against the JAX engine resumed from the same checkpoint.

The port runs on the CPU here (``device="cpu"``). Tolerances: min, max,
the per-key event counts and the alert flags exact; means within rtol
1e-5 and atol 1e-5 x max|v| (summation order differs).
"""
import shutil

import numpy as np
import pytest
import torch

import repro.configs.base as jcfg
import repro.core as jcore
import repro.core.batch_exec as jbx
import repro.core.cleanup as jcleanup
import repro.core.events as jev
import repro.core.operators as jops
import repro.core.triggers as jtrig
import repro_torch.configs.base as tcfg
import repro_torch.core as tcore
import repro_torch.core.batch_exec as tbx
import repro_torch.core.cleanup as tcleanup
import repro_torch.core.events as tev
import repro_torch.core.operators as tops
import repro_torch.core.triggers as ttrig
from repro_torch.convert import engine_state_from_jax

WINDOW = 10.0
CAP, WIDTH, KEYS = 32, 4, 8
N_EVENTS, CHUNK = 3000, 150
MAX_LATE = 25.0
MAX_VALUE = 20.0
SEED = 1234
PKGS = {
    "jax": (jcfg, jcore, jbx, jcleanup, jev, jops, jtrig),
    "torch": (tcfg, tcore, tbx, tcleanup, tev, tops, ttrig),
}


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
    """The stream: (now, keys, timestamps, values, watermark or None)
    steps, made once from the seed so both engines see the same one."""
    rng = np.random.default_rng(SEED)
    steps, now, wm = [], 0.0, 0.0
    for _ in range(N_EVENTS // CHUNK):
        u = rng.random(CHUNK)
        delay = np.where(u < 0.65, rng.uniform(0.0, 2.0, CHUNK),
                         rng.uniform(0.0, MAX_LATE, CHUNK))
        ts = np.maximum(now - delay, 0.0)
        keys = rng.integers(0, 3 * KEYS, CHUNK)
        vals = rng.uniform(1.0, MAX_VALUE,
                           (CHUNK, WIDTH)).astype(np.float32)
        adv = None
        if rng.random() < 0.7:
            wm = max(wm, now - rng.uniform(0.0, 5.0))
            adv = wm
        steps.append((now, keys, ts, vals, adv))
        now += rng.uniform(1.0, 4.0)
    return steps, now


STEPS, END = _schedule()


def _engine(pkg, spill_dir, pool_slots=12, splitk=0):
    cfg, core, _, cleanup, _, ops, trig = PKGS[pkg]

    class NoPurge(cleanup.PredictiveCleanup):
        # the oracle keeps every event forever: no purging
        def should_purge(self, window_end, watermark):
            return False

    aion = cfg.AionConfig(block_size=CAP, pool_slots=pool_slots,
                          splitk_chunk_rows=splitk,
                          store_segment_bytes=32 << 10)
    dev = {} if pkg == "jax" else {"device": "cpu"}
    return core.StreamEngine(
        assigner=core.TumblingWindows(WINDOW),
        operator=ops.make_operator("stock", CAP, WIDTH, num_keys=KEYS,
                                   **dev),
        aion=aion, value_width=WIDTH,
        cleanup=NoPurge(initial_bound=60.0, min_history=1 << 62),
        trigger=trig.DeltaTTrigger(executions=2),
        device_budget_bytes=1 << 16, host_budget_bytes=1 << 14,
        spill_dir=spill_dir, **dev)


def _feed(pkg, eng, steps):
    ev = PKGS[pkg][4]
    for now, keys, ts, vals, adv in steps:
        eng.ingest(ev.EventBatch(keys, ts, vals), now)
        if adv is not None:
            eng.advance_watermark(adv, now)
        eng.poll(now)


def _held_counts(pkg, eng):
    """Per-window per-key event counts over the blocks the engine holds
    (each block read once, wherever it lives)."""
    bx = PKGS[pkg][2]
    out = {}
    for w, state in eng.windows.items():
        ct = np.zeros(KEYS)
        for blk in sum(bx.snapshot_block_partition(state), []):
            arrs = eng.io.fetch_block_arrays(blk)
            np.add.at(ct, np.asarray(arrs["keys"])[:blk.fill] % KEYS, 1.0)
        out[(w.start, w.end)] = ct
    return out


def _close_out(pkg, eng):
    """Expire everything, fire the remaining plans, then re-execute every
    window once through the engine's own batched path."""
    bx = PKGS[pkg][2]
    eng.advance_watermark(END + MAX_LATE, END)
    for t in np.linspace(END, END + 70.0, 6):
        eng.poll(t)
    assert eng.io.drain()
    items = [bx.BatchWorkItem(w, eng.windows[w], True)
             for w in sorted(eng.windows)]
    eng.batch_exec.execute(items, END + 70.0)
    held = _held_counts(pkg, eng)
    results = {(w.start, w.end): dict(r, count=held[(w.start, w.end)])
               for w, r in eng.results.items()}
    m = eng.metrics
    counts = {k: getattr(m, k) for k in (
        "pooled_rows", "fallback_rows", "splitk_launches", "late_executions",
        "batch_executions")}
    eng.close()
    return results, counts


def _run(pkg, tmp_path, **kw):
    eng = _engine(pkg, tmp_path / pkg, **kw)
    _feed(pkg, eng, STEPS)
    return _close_out(pkg, eng)


def _oracle():
    keys = np.concatenate([s[1] for s in STEPS]) % KEYS
    ts = np.concatenate([s[2] for s in STEPS])
    p = np.concatenate([s[3] for s in STEPS])[:, 0].astype(np.float64)
    wstart = np.floor(ts / WINDOW) * WINDOW
    out = {}
    for s in np.unique(wstart):
        sel = wstart == s
        k = keys[sel]
        mn = np.full(KEYS, np.inf)
        mx = np.full(KEYS, -np.inf)
        sm = np.zeros(KEYS)
        ct = np.zeros(KEYS)
        np.minimum.at(mn, k, p[sel])
        np.maximum.at(mx, k, p[sel])
        np.add.at(sm, k, p[sel])
        np.add.at(ct, k, 1.0)
        out[(float(s), float(s) + WINDOW)] = {
            "mean": sm / np.maximum(ct, 1.0), "min": mn, "max": mx,
            "count": ct}
    return out


def _agree(got, want, alerts=True):
    """min, max and the per-key event counts exact; the mean within
    rtol 1e-5 and atol 1e-5 x max|v| (the sum's bound of 1e-5 x max|v| x
    rows, divided by the segment's count of rows)."""
    assert set(got) == set(want)
    for wid in want:
        g, w = got[wid], want[wid]
        for k in ("min", "max", "count"):
            np.testing.assert_array_equal(
                np.asarray(g[k], np.float32), np.asarray(w[k], np.float32),
                err_msg=f"{wid} {k}")
        np.testing.assert_allclose(g["mean"], w["mean"], rtol=1e-5,
                                   atol=1e-5 * MAX_VALUE,
                                   err_msg=f"{wid} mean")
        if alerts:
            np.testing.assert_array_equal(g["alerts"], w["alerts"])


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _run("jax", tmp_path_factory.mktemp("jax"))


def test_engines_agree_with_each_other_and_the_oracle(jax_run, tmp_path):
    want, jcounts = jax_run
    got, counts = _run("torch", tmp_path)
    _agree(got, want)
    _agree(want, _oracle(), alerts=False)
    _agree(got, _oracle(), alerts=False)
    assert counts["late_executions"] > 0
    assert counts["pooled_rows"] > 0
    # the pool is smaller than the live state: rows without a slot take
    # the stacked fallback (the flat kernel on the card)
    assert counts["fallback_rows"] > 0
    assert jcounts["pooled_rows"] > 0


def test_splitk_run_agrees(jax_run, tmp_path):
    want, _ = jax_run
    got, counts = _run("torch", tmp_path, pool_slots=64, splitk=2)
    assert counts["splitk_launches"] > 0
    _agree(got, want)
    _agree(got, _oracle(), alerts=False)


def test_jax_checkpoint_resumes_in_the_port(jax_run, tmp_path):
    """A manifest checkpoint of the JAX engine (inline blocks plus
    references into the log it wrote) restores into the port through
    ``engine_state_from_jax`` and finishes the stream with the same
    results as the JAX engine resumed from the same checkpoint."""
    half = len(STEPS) // 2
    eng = _engine("jax", tmp_path / "a")
    _feed("jax", eng, STEPS[:half])
    snap = eng.checkpoint_state(include_stored_data=False)
    eng.close()
    blocks = [b for w in snap["windows"] for b in w["blocks"]]
    assert any(b.get("stored") for b in blocks)         # manifest refs
    assert any(b.get("data") for b in blocks)           # inline data
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    resumed = {}
    for pkg, d, state in (("jax", "a", snap),
                          ("torch", "b", engine_state_from_jax(snap))):
        eng = _engine(pkg, tmp_path / d)
        eng.restore_state(state)
        _feed(pkg, eng, STEPS[half:])
        resumed[pkg], _ = _close_out(pkg, eng)
    _agree(resumed["torch"], resumed["jax"])
    _agree(resumed["torch"], jax_run[0])


def test_engine_state_from_jax_validates():
    snap = {"watermark": 5.0, "hist_counts": [0.0] * 256, "hist_total": 0,
            "windows": [{"start": 0.0, "end": 10.0, "total_events": 2,
                         "late_events": 0, "expired": False, "blocks": [
                             {"fill": 2, "block_id": 7, "tier": "host",
                              "persisted": False,
                              "data": {"keys": [1, 2],
                                       "timestamps": [1.0, 2.0],
                                       "values": [[1.0], [2.0]]}}]}]}
    out = engine_state_from_jax(snap)
    assert out["windows"][0]["blocks"][0]["data"]["values"].dtype \
        == np.float32
    bad_hist = dict(snap, hist_counts=[0.0] * 8)
    bad_fill = {**snap, "windows": [dict(snap["windows"][0],
                                         total_events=3)]}
    dup = {**snap, "windows": [snap["windows"][0], dict(
        snap["windows"][0], start=10.0, end=20.0)]}
    for bad in (bad_hist, bad_fill, dup):
        with pytest.raises(ValueError):
            engine_state_from_jax(bad)


def test_engine_defaults_to_the_card(tmp_path):
    """No device given: the engine resolves CUDA, and raises where CUDA
    is missing; the pipelined engine and the learned prefetch backend
    build on ``device="cpu"`` and resolve the device the same way; slot
    sharding on one CPU builds no mesh and folds unsharded."""
    op = tops.make_operator("stock", CAP, WIDTH, device="cpu")
    kw = dict(assigner=tcore.TumblingWindows(WINDOW), operator=op,
              value_width=WIDTH)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcore.StreamEngine(**kw)
    for ported in ({"pipelined_execution": True},
                   {"prefetch_backend": "learned"}):
        aion = tcfg.AionConfig(**ported)
        eng = tcore.StreamEngine(aion=aion, device="cpu", **kw)
        assert (eng.pipeline is not None) == aion.pipelined_execution
        assert type(eng.prestage).__name__ == (
            "LearnedPrestageScheduler" if aion.prefetch_backend == "learned"
            else "PrestageScheduler")
        eng.close()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                tcore.StreamEngine(aion=aion, **kw)
    # slot sharding on one CPU with no slot devices: no mesh, an unsharded
    # pool, and batched folds that do not shard (the JAX package's no-op
    # on one device)
    eng = tcore.StreamEngine(aion=tcfg.AionConfig(slot_sharding=True),
                             device="cpu", **kw)
    assert eng.slot_mesh is None and eng.pool.num_shards == 1
    rng = np.random.default_rng(0)
    eng.ingest(tev.EventBatch(rng.integers(0, KEYS, 400),
                              rng.uniform(0.0, 40.0, 400),
                              rng.uniform(1.0, MAX_VALUE, (400, WIDTH))
                              .astype(np.float32)), 0.0)
    eng.advance_watermark(40.0, 40.0)
    assert eng.metrics.batch_executions > 0
    assert eng.metrics.sharded_batch_executions == 0
    assert len(eng.results) == 4
    eng.close()
