"""K2's shared-memory design on the CPU: its design rule, the order-keeping
keys that carry min and max, and a numpy emulation of its order of work
held against the JAX package's block-table fold on the same inputs.

The emulation follows ``seg_agg_block_table_smem`` of
``csrc/segment_splitk.cu``: the R x cap events, flattened, are cut into
blocks of SPLITK_EVENTS_PER_BLOCK; each block folds its live events into a
private partial that starts as zero words (sum and count as floats, min
and max as unsigned keys under which 0 is the identity and NaN the
largest); each block then adds its touched words into the zeroed output
(sums and counts added, keys maxed, in block order here and in any order
on the card); last, the keys become floats again (+inf / -inf where
nothing landed). SPLITK_EVENTS_PER_BLOCK is set small here so that the
fold takes several blocks and blocks end inside rows.

References: ``repro.kernels.ref.ref_segment_aggregate_block_table`` and
the JAX block-table fold (``segment_aggregate_block_table_pallas`` in
interpret mode, and its dense twin). Tolerances as
``tests/test_torch_kernels.py``: count, min and max exact; sums within
rtol 1e-5 and atol 1e-5 x max|v| x rows (another order). The kernel
itself is held against the plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 3)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.segment_aggregate import (
    segment_aggregate_block_table_dense as j_dense,
    segment_aggregate_block_table_pallas as j_pallas)

sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
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


def test_keys_keep_the_order_and_let_nan_win():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=500) * 10.0 ** rng.integers(
        -30, 30, 500), [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                        3.4e38, -3.4e38]]).astype(np.float32)
    for stat, key in (("min", min_key), ("max", max_key)):
        k = key(x)
        assert (k != 0).all() and (k != ALL_ONES).all()
        np.testing.assert_array_equal(from_key(stat, k), x)
        # a larger key is the smaller float (min) or the larger (max)
        i, j = rng.integers(0, x.size, (2, 2000))
        keep = x[i] != x[j]
        want = (x[i] < x[j]) if stat == "min" else (x[i] > x[j])
        assert np.array_equal((k[i] > k[j])[keep], want[keep])
        assert key(np.float32(np.nan)) == ALL_ONES
        assert np.isnan(from_key(stat, ALL_ONES))
    assert from_key("min", 0) == np.inf and from_key("max", 0) == -np.inf


# ------------------------------------------------------------ the design
@pytest.mark.parametrize("slots,stats,want", [
    (24, sa.ALL_STATS, "smem"),         # the stock fold: 128 keys, 48 KB
    (25, sa.ALL_STATS, "global"),
    (6, ("sum", "count"), "smem"),      # the average fold
    (48, ("sum", "count"), "smem"),
    (49, ("sum", "count"), "global"),
])
def test_design_rule_for_the_stock_fold(slots, stats, want):
    """K2 takes K3's rule for one result: a block's partial of
    splitk_partial_bytes within SPLITK_SMEM_BYTES goes to shared memory.
    The stock fold (128 keys, num_cols=1) fits up to 24 slots at four
    stats."""
    s_total = slots * 128
    assert sa.splitk_design(sa.norm_stats(stats), s_total, 1) == want
    assert (sa.splitk_partial_bytes(sa.norm_stats(stats), s_total, 1)
            <= sa.SPLITK_SMEM_BYTES) == (want == "smem")


# --------------------------------------------------------- the emulation
def emulate(arena, ids, table, valid, slots, s, ns, stats, num_cols):
    """K2's smem order of work in numpy float32."""
    p, cap, w = arena.shape
    w_out = num_cols or w
    r = table.shape[0]
    s_total = ns * s
    per_block = sa.SPLITK_EVENTS_PER_BLOCK

    def zeros(st):
        shape = (s_total,) if st == "count" else (s_total, w_out)
        return np.zeros(shape, np.uint32 if st in ("min", "max")
                        else np.float32)

    out = {st: zeros(st) for st in stats}
    for e0 in range(0, r * cap, per_block):
        part = {st: zeros(st) for st in stats}
        for e in range(e0, min(e0 + per_block, r * cap)):
            row, col = divmod(e, cap)
            comp = slots[row] * s + ids[row, col]
            if not valid[row, col] or not 0 <= comp < s_total \
                    or not 0 <= table[row] < p:
                continue
            v = arena[table[row], col, :w_out]
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
    res = {}
    for st in stats:
        v = from_key(st, out[st]) if st in ("min", "max") else out[st]
        res[st] = v.reshape((ns, s) if st == "count" else (ns, s, w_out))
    return res


def _case(p=16, cap=48, w=2, s=5, r=11, ns=4, seed=17):
    rng = np.random.default_rng(seed)
    arena = rng.normal(size=(p, cap, w)).astype(np.float32)
    ids = rng.integers(0, s, (r, cap)).astype(np.int32)
    table = rng.integers(1, p, r).astype(np.int32)
    fills = rng.integers(0, cap + 1, r)
    valid = np.arange(cap)[None, :] < fills[:, None]
    slots = rng.integers(0, ns, r).astype(np.int32)
    return arena, ids, table, valid, slots, s, ns


def _assert_aggs(out, ref, rows, scale):
    assert set(out) == set(ref)
    for k in out:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k == "sum":
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * scale * max(rows, 1),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("per_block,r,num_cols", [
    (40, 11, None),     # blocks end inside rows
    (48, 9, 1),         # one row a block, the engine's one column
    (1000, 7, None),    # one block
])
def test_order_of_work_matches_jax(monkeypatch, per_block, r, num_cols):
    monkeypatch.setattr(sa, "SPLITK_EVENTS_PER_BLOCK", per_block)
    arena, ids, table, valid, slots, s, ns = _case(r=r)
    got = emulate(arena, ids, table, valid, slots, s, ns, sa.ALL_STATS,
                  num_cols)
    args = (jnp.asarray(arena), jnp.asarray(ids), jnp.asarray(table), s)
    kw = dict(valid=jnp.asarray(valid), slot_ids=jnp.asarray(slots),
              num_slots=ns, num_cols=num_cols)
    scale = np.abs(arena).max()
    _assert_aggs(got, JR.ref_segment_aggregate_block_table(*args, **kw),
                 ids.size, scale)
    _assert_aggs(got, j_dense(*args, **kw), ids.size, scale)
    plain = sa.segment_aggregate_block_table_plain(
        *(torch.from_numpy(x) for x in (arena, ids, table)), s,
        valid=torch.from_numpy(valid), slot_ids=torch.from_numpy(slots),
        num_slots=ns, num_cols=num_cols)
    _assert_aggs(got, {k: v.numpy() for k, v in plain.items()}, ids.size,
                 scale)


def test_nan_and_pool_slot_zero_match_pallas(monkeypatch):
    """NaN values of live events win min and max and poison their own
    sums; padding rows (valid 0) name pool slot 0, which holds NaN, and
    stay inert; a slot no row names holds the identities. Count, min and
    max against the Pallas kernel in interpret mode; the sums against the
    oracle, since the Pallas one-hot product spreads a NaN to every sum of
    its tile (ROADMAP Queue 3, item 1)."""
    monkeypatch.setattr(sa, "SPLITK_EVENTS_PER_BLOCK", 40)
    arena, ids, table, valid, slots, s, ns = _case(r=14, ns=5)
    arena[0] = np.nan
    table[11:] = 0                       # padding rows
    valid[11:] = False
    slots[slots == 4] = 3                # slot 4: no row
    arena[table[2], 5, 0] = np.nan
    valid[2, 5] = True
    got = emulate(arena, ids, table, valid, slots, s, ns, sa.ALL_STATS, 1)
    assert float(np.abs(got["count"][4]).sum()) == 0.0
    assert np.isposinf(got["min"][4]).all()
    assert np.isneginf(got["max"][4]).all()
    nan = np.isnan(got["sum"])
    assert nan.sum() == 1
    assert np.array_equal(np.isnan(got["min"]), nan)
    assert np.array_equal(np.isnan(got["max"]), nan)
    args = (jnp.asarray(arena), jnp.asarray(ids), jnp.asarray(table), s)
    kw = dict(valid=jnp.asarray(valid), slot_ids=jnp.asarray(slots),
              num_slots=ns, num_cols=1)
    ref = j_pallas(*args, interpret=True, **kw)
    _assert_aggs({k: got[k] for k in ("count", "min", "max")},
                 {k: np.asarray(ref[k]) for k in ("count", "min", "max")},
                 ids.size, 1.0)
    oracle = JR.ref_segment_aggregate_block_table(*args, **kw)
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(oracle["sum"])))
    _assert_aggs({"sum": np.nan_to_num(got["sum"])},
                 {"sum": np.nan_to_num(np.asarray(oracle["sum"]))},
                 ids.size, np.nanmax(np.abs(arena)))
