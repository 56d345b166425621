"""K1's shared-memory design on the CPU: its design rule on the shapes the
engine gives it, and a numpy emulation of its order of work held against
the JAX package's batched fold on the same inputs.

The emulation follows ``seg_agg_flat_smem`` of ``csrc/segment_splitk.cu``
(K2's fold and flush, with the strided-row source): event ``e`` of the
B x N stacked events reads its values at ``values + e * ld`` out of one
flat buffer whose rows are wider than the columns the fold reads, and its
composite segment ``slots[e // N] * S + ids[e]`` (with no slots, as the
flat ``segment_aggregate_cuda`` passes, ``ids[e]`` itself). The events
are cut into blocks of SPLITK_EVENTS_PER_BLOCK; each block folds its live
events into a private partial that starts as zero words (sum and count as
floats, min and max as unsigned keys under which 0 is the identity and
NaN the largest); each block adds its touched words into the zeroed
output (sums and counts added, keys maxed, in block order here and in any
order on the card); last, the keys become floats again (+inf / -inf where
nothing landed). SPLITK_EVENTS_PER_BLOCK is set small here so that the
fold takes several blocks and blocks end inside rows.

References: ``repro.kernels.ref.ref_segment_aggregate_batched`` and
``ref_segment_aggregate``, and the JAX Pallas kernels
(``segment_aggregate_batched_pallas``, ``segment_aggregate_pallas``) in
interpret mode. Tolerances as ``tests/test_torch_kernels.py``: count, min
and max exact; sums within rtol 1e-5 (``SUM_RTOL``) and atol 1e-5
(``SUM_ATOL``) x max|v| x rows (another order). The kernel itself is held
against the plain version on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` phase 3)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.segment_aggregate import (
    segment_aggregate_batched_pallas as j_batched_pallas,
    segment_aggregate_pallas as j_pallas)

sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
SUM_RTOL = 1e-5
SUM_ATOL = 1e-5
SIGN = np.uint32(0x80000000)
ALL_ONES = np.uint32(0xFFFFFFFF)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while a test runs: the suite's
    workers share the cores, and torch's own threads would oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------- the keys of min and max
def ordered(x: np.ndarray) -> np.ndarray:
    u = np.asarray(x, np.float32).view(np.uint32)
    return np.where(u & SIGN, ~u, u | SIGN).astype(np.uint32)


def min_key(x):
    return np.where(np.isnan(x), ALL_ONES, ~ordered(x)).astype(np.uint32)


def max_key(x):
    return np.where(np.isnan(x), ALL_ONES, ordered(x)).astype(np.uint32)


def from_key(stat: str, k: np.ndarray) -> np.ndarray:
    k = np.asarray(k, np.uint32)
    o = ~k if stat == "min" else k
    f = np.where(o & SIGN, o & ~SIGN, ~o).astype(np.uint32).view(np.float32)
    empty = np.float32(np.inf if stat == "min" else -np.inf)
    return np.where(k == 0, empty, np.where(k == ALL_ONES, np.nan, f))


# ------------------------------------------------------------ the design
@pytest.mark.parametrize("slots,stats,w,want", [
    # Linear Road: 256 segments, [speed, stopped] summed and counted,
    # 3 KB of partial a slot
    (16, ("sum", "count"), 2, "smem"),
    (17, ("sum", "count"), 2, "global"),
    # the stock fallback: 128 keys, one column, four stats, 2 KB a slot
    (24, sa.ALL_STATS, 1, "smem"),
    (25, sa.ALL_STATS, 1, "global"),
])
def test_design_rule_on_the_engine_shapes(slots, stats, w, want):
    """K1 takes K3's rule: a block's partial of splitk_partial_bytes
    within SPLITK_SMEM_BYTES goes to shared memory, the rest to the
    global-atomic kernel; forcing smem past the rule raises."""
    keys = 256 if w == 2 else 128
    stats = sa.norm_stats(stats)
    nbytes = sa.splitk_partial_bytes(stats, slots * keys, w)
    assert nbytes == slots * keys * 4 * (w * len(stats) - (w - 1)
                                         * ("count" in stats))
    assert sa.splitk_design(stats, slots * keys, w) == want
    assert sa.splitk_design(stats, slots * keys, w, "global") == "global"
    if want == "global":
        with pytest.raises(ValueError, match="smem design keeps"):
            sa.splitk_design(stats, slots * keys, w, "smem")


# --------------------------------------------------------- the emulation
def emulate(flat, ld, rows, n, w, ids, valid, slots, s, s_total, stats):
    """K1's smem order of work in numpy float32 over ``flat``, the buffer
    the events' rows lie in (event e's values at flat[e * ld:][:w])."""
    per_block = sa.SPLITK_EVENTS_PER_BLOCK
    events = rows * n
    ids, valid = ids.reshape(-1), valid.reshape(-1)

    def zeros(st):
        shape = (s_total,) if st == "count" else (s_total, w)
        return np.zeros(shape, np.uint32 if st in ("min", "max")
                        else np.float32)

    out = {st: zeros(st) for st in stats}
    for e0 in range(0, events, per_block):
        part = {st: zeros(st) for st in stats}
        for e in range(e0, min(e0 + per_block, events)):
            comp = ids[e] if slots is None else slots[e // n] * s + ids[e]
            if not valid[e] or not 0 <= comp < s_total:
                continue
            v = flat[e * ld:e * ld + w]
            for st in stats:
                if st == "count":
                    part[st][comp] += 1
                elif st == "sum":
                    part[st][comp] += v
                elif st == "min":
                    part[st][comp] = np.maximum(part[st][comp], min_key(v))
                else:
                    part[st][comp] = np.maximum(part[st][comp], max_key(v))
        for st in stats:
            touched = part[st].view(np.uint32) != 0
            if st in ("min", "max"):
                out[st] = np.where(touched, np.maximum(out[st], part[st]),
                                   out[st])
            else:
                out[st] = np.where(touched, out[st] + part[st], out[st])
    return {st: from_key(st, v) if st in ("min", "max") else v
            for st, v in out.items()}


def _case(b=9, n=40, w=2, ld=5, s=6, ns=4, seed=23):
    """Stacked events [b, n] whose rows lie ``ld`` floats apart in one flat
    buffer (the unread columns random), ragged fills, a few ids out of
    range (negative, and past the last slot's segments)."""
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=b * n * ld).astype(np.float32)
    ids = rng.integers(0, s, (b, n)).astype(np.int32)
    ids[1, 3] = -1
    ids[2, 7] = s * ns + 3
    fills = rng.integers(0, n + 1, b)
    valid = np.arange(n)[None, :] < fills[:, None]
    valid[1, 3] = valid[2, 7] = True
    slots = rng.integers(0, ns, b).astype(np.int32)
    values = flat.reshape(b, n, ld)[:, :, :w]
    return flat, values, ids, valid, slots, s, ns


def _assert_aggs(out, ref, rows, scale):
    assert set(out) == set(ref)
    for k in out:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k == "sum":
            np.testing.assert_allclose(a, b, rtol=SUM_RTOL,
                                       atol=SUM_ATOL * scale * max(rows, 1),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _shaped(out, prefix, w):
    return {k: v.reshape(prefix if k == "count" else (*prefix, w))
            for k, v in out.items()}


@pytest.mark.parametrize("per_block,w,stats", [
    (48, 2, ("sum", "count")),     # blocks end inside rows: LRB's fold
    (48, 1, sa.ALL_STATS),         # the stock fallback's one column
    (40, 2, sa.ALL_STATS),         # one row a block
    (1000, 1, ("min", "max")),     # one block
])
def test_stacked_order_of_work_matches_jax(monkeypatch, per_block, w, stats):
    """The stacked fold (slots given) against the JAX reference, the
    Pallas kernel in interpret mode and the port's plain version."""
    monkeypatch.setattr(sa, "SPLITK_EVENTS_PER_BLOCK", per_block)
    flat, values, ids, valid, slots, s, ns = _case(w=w)
    b, n, _ = values.shape
    stats = sa.norm_stats(stats)
    got = _shaped(emulate(flat, 5, b, n, w, ids, valid, slots, s, ns * s,
                          stats), (ns, s), w)
    args = (jnp.asarray(values), jnp.asarray(ids), s)
    kw = dict(valid=jnp.asarray(valid), slot_ids=jnp.asarray(slots),
              num_slots=ns)
    scale = float(np.abs(values).max())
    ref = JR.ref_segment_aggregate_batched(*args, **kw)
    _assert_aggs(got, {k: ref[k] for k in stats}, ids.size, scale)
    _assert_aggs(got, j_batched_pallas(*args, interpret=True, stats=stats,
                                       **kw), ids.size, scale)
    plain = sa.segment_aggregate_batched_plain(
        torch.from_numpy(values), torch.from_numpy(ids), s,
        valid=torch.from_numpy(valid), slot_ids=torch.from_numpy(slots),
        num_slots=ns, stats=stats)
    _assert_aggs(got, {k: v.numpy() for k, v in plain.items()}, ids.size,
                 scale)


@pytest.mark.parametrize("w", [1, 2])
def test_flat_null_slots_matches_jax(monkeypatch, w):
    """With no slots the ids are the segments (the flat
    ``segment_aggregate_cuda``): one row of N events."""
    monkeypatch.setattr(sa, "SPLITK_EVENTS_PER_BLOCK", 64)
    flat, values, ids, valid, _, s, ns = _case(w=w)
    vals = values.reshape(-1, w)
    comp, ok = ids.reshape(-1), valid.reshape(-1)
    got = emulate(flat, 5, 1, comp.size, w, comp, ok, None, s * ns, s * ns,
                  sa.ALL_STATS)
    scale = float(np.abs(vals).max())
    args = (jnp.asarray(vals), jnp.asarray(comp), s * ns)
    _assert_aggs(got, JR.ref_segment_aggregate(*args,
                                               valid=jnp.asarray(ok)),
                 comp.size, scale)
    _assert_aggs(got, j_pallas(*args, valid=jnp.asarray(ok),
                               interpret=True), comp.size, scale)


@pytest.mark.parametrize("w", [1, 2])
def test_nan_invalid_and_out_of_range_match_pallas(monkeypatch, w):
    """NaN values of live events win min and max and poison their own
    sums only; invalid events (a NaN among them) and out-of-range ids stay
    inert; a slot no row names holds the identities. Count, min and max
    against the Pallas kernel in interpret mode; the sums against the
    oracle, since the Pallas one-hot product spreads a NaN to every sum of
    its tile (ROADMAP Queue 3, item 1)."""
    monkeypatch.setattr(sa, "SPLITK_EVENTS_PER_BLOCK", 48)
    flat, values, ids, valid, slots, s, ns = _case(w=w, ns=5)
    b, n, _ = values.shape
    slots[slots == 4] = 3                      # slot 4: no row
    values[3, 5, 0] = np.nan                   # writes through to flat
    valid[3, 5] = True
    values[4, 6, w - 1] = np.nan               # an invalid NaN: inert
    valid[4, 6] = False
    got = _shaped(emulate(flat, 5, b, n, w, ids, valid, slots, s, ns * s,
                          sa.ALL_STATS), (ns, s), w)
    assert float(np.abs(got["count"][4]).sum()) == 0.0
    assert np.isposinf(got["min"][4]).all()
    assert np.isneginf(got["max"][4]).all()
    nan = np.isnan(got["sum"])
    assert nan.sum() == 1
    assert np.array_equal(np.isnan(got["min"]), nan)
    assert np.array_equal(np.isnan(got["max"]), nan)
    args = (jnp.asarray(values), jnp.asarray(ids), s)
    kw = dict(valid=jnp.asarray(valid), slot_ids=jnp.asarray(slots),
              num_slots=ns)
    ref = j_batched_pallas(*args, interpret=True, **kw)
    _assert_aggs({k: got[k] for k in ("count", "min", "max")},
                 {k: np.asarray(ref[k]) for k in ("count", "min", "max")},
                 ids.size, 1.0)
    oracle = JR.ref_segment_aggregate_batched(*args, **kw)
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(oracle["sum"])))
    _assert_aggs({"sum": np.nan_to_num(got["sum"])},
                 {"sum": np.nan_to_num(np.asarray(oracle["sum"]))},
                 ids.size, float(np.nanmax(np.abs(values))))


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On the CPU both K1 wrappers take the plain version, whatever
    ``design`` asks, and count no launch."""
    flat, values, ids, valid, slots, s, ns = _case()
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in dict(
        values=values, ids=ids, valid=valid, slots=slots).items()}
    before = (sa.segment_aggregate_cuda.launches,
              dict(sa.segment_aggregate_cuda.launches_by_design))
    for design in (None, "smem", "global"):
        got = sa.segment_aggregate_batched_cuda(
            t["values"], t["ids"], s, valid=t["valid"], slot_ids=t["slots"],
            num_slots=ns, design=design)
        want = sa.segment_aggregate_batched_plain(
            t["values"], t["ids"], s, valid=t["valid"],
            slot_ids=t["slots"], num_slots=ns)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                       equal_nan=True)
        flat_got = sa.segment_aggregate_cuda(
            t["values"].reshape(-1, 2), t["ids"].reshape(-1), s * ns,
            valid=t["valid"].reshape(-1), design=design)
        assert flat_got["count"].shape == (s * ns,)
    assert (sa.segment_aggregate_cuda.launches,
            dict(sa.segment_aggregate_cuda.launches_by_design)) == before
