"""The CUDA kernels (K1 flat and stacked, K2 block table and K3 split-K,
each on both of its designs) against their plain torch versions on the
card. Marked
``gpu``: they build the kernels with nvcc and skip where there is no CUDA
device. Run them on a GPU
machine with ``PYTHONPATH=src python -m pytest -m gpu tests/``.

Tolerances: count, min and max exact (float atomics add whole ones below
2^24; min/max do no arithmetic); sums within rtol 1e-5 and atol 1e-5 x
max|v| x rows (atomics add in a run-dependent order)."""
import importlib

import numpy as np
import pytest
import torch

# the module, not the ``repro_torch.kernels.segment_aggregate`` entry point
# that the package re-exports under the same name
sa = importlib.import_module("repro_torch.kernels.segment_aggregate")

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(out, ref, rows, scale):
    assert set(out) == set(ref)
    for k in out:
        a, b = out[k].cpu().numpy(), ref[k].cpu().numpy()
        if k == "sum":
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * scale * rows, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _case(dev, p=64, cap=512, w=8, s=16, r=96, slots=6, seed=0):
    g = np.random.default_rng(seed)
    arena = torch.tensor(g.normal(size=(p, cap, w)), dtype=torch.float32,
                         device=dev)
    ids = torch.tensor(g.integers(0, s, (r, cap)), dtype=torch.int32,
                       device=dev)
    table = torch.tensor(g.integers(1, p, r), dtype=torch.int32, device=dev)
    fills = g.integers(0, cap + 1, r)
    valid = torch.tensor(np.arange(cap)[None] < fills[:, None], device=dev)
    sl = torch.tensor(g.integers(0, slots, r), dtype=torch.int32, device=dev)
    return arena, ids, table, valid, sl, s, slots


@pytest.mark.parametrize("stats", [sa.ALL_STATS, ("sum", "count"),
                                   ("min", "max")])
def test_flat_kernel_matches_plain(dev, stats):
    g = np.random.default_rng(1)
    n, w, s = 5000, 3, 37
    vals = torch.tensor(g.normal(size=(n, w)), dtype=torch.float32,
                        device=dev)
    vals[7, 1] = float("nan")
    ids = torch.tensor(g.integers(0, s, n), dtype=torch.int32, device=dev)
    valid = torch.tensor(g.random(n) > 0.2, device=dev)
    before = sa.segment_aggregate_cuda.launches
    out = sa.segment_aggregate_cuda(vals, ids, s, valid=valid, stats=stats)
    torch.cuda.synchronize()
    assert sa.segment_aggregate_cuda.launches == before + 1
    ref = sa.segment_aggregate_plain(vals, ids, s, valid=valid, stats=stats)
    if "sum" in stats:        # a NaN row poisons its own sums only
        out["sum"] = torch.nan_to_num(out["sum"])
        ref["sum"] = torch.nan_to_num(ref["sum"])
    _close(out, ref, n, 4.0)


@pytest.mark.parametrize("num_cols", [None, 1])
def test_block_table_kernel_matches_plain(dev, num_cols):
    arena, ids, table, valid, sl, s, ns = _case(dev)
    out = sa.segment_aggregate_block_table_cuda(
        arena, ids, table, s, valid=valid, slot_ids=sl, num_slots=ns,
        num_cols=num_cols)
    ref = sa.segment_aggregate_block_table_plain(
        arena, ids, table, s, valid=valid, slot_ids=sl, num_slots=ns,
        num_cols=num_cols)
    torch.cuda.synchronize()
    _close(out, ref, ids.numel(), 5.0)


@pytest.mark.parametrize("design", ["smem", "global"])
@pytest.mark.parametrize("chunk", [1, 7, 32, 64])
def test_splitk_kernel_matches_plain_and_pads_inert(dev, chunk, design):
    """Both designs (the smem one by the rule, the global one forced), on
    90 rows: ragged last chunks, merged and raw partials."""
    arena, ids, table, valid, sl, s, ns = _case(dev, r=90)
    arena[0] = 1e30                             # only padding reads slot 0
    counts = sa.segment_aggregate_block_table_splitk_cuda.launches_by_design
    for merge in (True, False):
        before = dict(counts)
        out = sa.segment_aggregate_block_table_splitk_cuda(
            arena, ids, table, s, chunk, valid=valid, slot_ids=sl,
            num_slots=ns, num_cols=1, merge=merge,
            design=None if design == "smem" else design)
        assert counts[design] == before[design] + 1
        ref = sa.segment_aggregate_block_table_splitk_plain(
            arena, ids, table, s, chunk, valid=valid, slot_ids=sl,
            num_slots=ns, num_cols=1, merge=merge)
        torch.cuda.synchronize()
        _close(out, ref, ids.numel(), 5.0)


@pytest.mark.parametrize("stats", [sa.ALL_STATS, ("sum", "count"),
                                   ("min", "max"), ("count",)])
def test_splitk_smem_nan_stats_and_empty_chunks(dev, stats):
    """NaN values win min/max and poison only their own sums; a chunk
    whose rows are all invalid holds the identities; every column (no
    num_cols), no valid mask given."""
    arena, ids, table, valid, sl, s, ns = _case(dev, r=40, w=3)
    arena[table[5], 3, 1] = float("nan")
    arena[table[17], 0, 0] = float("nan")
    valid[8:16] = False                          # chunk 1 of 8 rows empty
    valid[5, 3] = True
    valid[17, 0] = True
    for merge in (True, False):
        out = sa.segment_aggregate_block_table_splitk_cuda(
            arena, ids, table, s, 8, valid=valid, slot_ids=sl, num_slots=ns,
            stats=stats, merge=merge)
        ref = sa.segment_aggregate_block_table_splitk_plain(
            arena, ids, table, s, 8, valid=valid, slot_ids=sl, num_slots=ns,
            stats=stats, merge=merge)
        if not merge and "count" in stats:
            assert float(out["count"][1].abs().sum()) == 0.0
        if "sum" in stats:
            assert torch.equal(torch.isnan(out["sum"]),
                               torch.isnan(ref["sum"]))
            out["sum"] = torch.nan_to_num(out["sum"])
            ref["sum"] = torch.nan_to_num(ref["sum"])
        _close(out, ref, ids.numel(), 5.0)
    whole = sa.segment_aggregate_block_table_splitk_cuda(
        arena, ids, table, s, 8, slot_ids=sl, num_slots=ns, stats=stats)
    _close({k: torch.nan_to_num(v) for k, v in whole.items()},
           {k: torch.nan_to_num(v) for k, v in
            sa.segment_aggregate_block_table_splitk_plain(
                arena, ids, table, s, 8, slot_ids=sl, num_slots=ns,
                stats=stats).items()}, ids.numel(), 5.0)


def test_splitk_design_rule_sends_large_partials_to_global(dev):
    """A partial past SPLITK_SMEM_BYTES goes to the global design, by the
    rule and counted; forcing smem there raises before any launch."""
    arena, ids, table, valid, sl, s, ns = _case(dev, w=8, s=600, r=30)
    assert sa.splitk_design(sa.ALL_STATS, ns * s, 8) == "global"
    counts = sa.segment_aggregate_block_table_splitk_cuda.launches_by_design
    before = dict(counts)
    out = sa.segment_aggregate_block_table_splitk_cuda(
        arena, ids, table, s, 7, valid=valid, slot_ids=sl, num_slots=ns)
    assert counts["global"] == before["global"] + 1
    assert counts["smem"] == before["smem"]
    _close(out, sa.segment_aggregate_block_table_splitk_plain(
        arena, ids, table, s, 7, valid=valid, slot_ids=sl, num_slots=ns),
        ids.numel(), 5.0)
    launches = sa.segment_aggregate_block_table_splitk_cuda.launches
    with pytest.raises(ValueError, match="smem design keeps"):
        sa.segment_aggregate_block_table_splitk_cuda(
            arena, ids, table, s, 7, valid=valid, slot_ids=sl,
            num_slots=ns, design="smem")
    assert sa.segment_aggregate_block_table_splitk_cuda.launches == launches


@pytest.mark.parametrize("design", ["smem", "global"])
@pytest.mark.parametrize("stats", [sa.ALL_STATS, ("sum", "count"),
                                   ("min", "max"), ("count",)])
def test_block_table_designs_nan_and_pool_slot_zero(dev, stats, design):
    """K2 on both designs (the smem one by the rule, the global one
    forced): NaN values of live events win min/max and poison only their
    own sums; padding rows (valid 0) name pool slot 0, which holds NaN, and
    stay inert; a slot no row names holds the identities; counted by
    design."""
    arena, ids, table, valid, sl, s, ns = _case(dev, r=120, w=3, slots=8)
    arena[0] = float("nan")
    table[100:] = 0                              # padding rows
    valid[100:] = False
    sl[sl == 7] = 6                              # slot 7: no row
    arena[table[5], 3, 1] = float("nan")
    arena[table[17], 0, 0] = float("nan")
    valid[5, 3] = True
    valid[17, 0] = True
    assert sa.splitk_design(sa.norm_stats(stats), ns * s, 3) == "smem"
    counts = sa.segment_aggregate_block_table_cuda.launches_by_design
    for num_cols in (None, 1):
        before = dict(counts)
        out = sa.segment_aggregate_block_table_cuda(
            arena, ids, table, s, valid=valid, slot_ids=sl, num_slots=ns,
            stats=stats, num_cols=num_cols,
            design=None if design == "smem" else design)
        assert counts[design] == before[design] + 1
        ref = sa.segment_aggregate_block_table_plain(
            arena, ids, table, s, valid=valid, slot_ids=sl, num_slots=ns,
            stats=stats, num_cols=num_cols)
        torch.cuda.synchronize()
        for k in out:
            assert torch.equal(torch.isnan(out[k]), torch.isnan(ref[k])), k
        if "count" in stats:
            assert float(out["count"][7].abs().sum()) == 0.0
        if "min" in stats:
            assert bool(torch.isinf(out["min"][7]).all())
        if "sum" in stats:
            out["sum"] = torch.nan_to_num(out["sum"])
            ref["sum"] = torch.nan_to_num(ref["sum"])
        _close(out, ref, ids.numel(), 5.0)


def test_block_table_design_rule_sends_large_partials_to_global(dev):
    """K2: a partial past SPLITK_SMEM_BYTES goes to the global design, by
    the rule and counted; forcing smem there raises before any launch; the
    stock fold's 24 slots of 128 keys at four stats still fit."""
    assert sa.splitk_design(sa.ALL_STATS, 24 * 128, 1) == "smem"
    assert sa.splitk_design(sa.ALL_STATS, 25 * 128, 1) == "global"
    arena, ids, table, valid, sl, s, ns = _case(dev, w=8, s=600, r=30)
    counts = sa.segment_aggregate_block_table_cuda.launches_by_design
    before = dict(counts)
    out = sa.segment_aggregate_block_table_cuda(
        arena, ids, table, s, valid=valid, slot_ids=sl, num_slots=ns)
    assert counts == dict(before, **{"global": before["global"] + 1})
    _close(out, sa.segment_aggregate_block_table_plain(
        arena, ids, table, s, valid=valid, slot_ids=sl, num_slots=ns),
        ids.numel(), 5.0)
    launches = sa.segment_aggregate_block_table_cuda.launches
    with pytest.raises(ValueError, match="smem design keeps"):
        sa.segment_aggregate_block_table_cuda(
            arena, ids, table, s, valid=valid, slot_ids=sl, num_slots=ns,
            design="smem")
    assert sa.segment_aggregate_block_table_cuda.launches == launches


def test_wrappers_reject_bad_inputs(dev):
    arena, ids, table, valid, sl, s, ns = _case(dev, p=8, cap=32, r=4)
    with pytest.raises(ValueError):
        sa.segment_aggregate_block_table_cuda(
            arena.transpose(1, 2), ids, table, s, slot_ids=sl, num_slots=ns)
    with pytest.raises(ValueError):
        sa.segment_aggregate_block_table_cuda(
            arena, ids.cpu(), table, s, slot_ids=sl, num_slots=ns)
    with pytest.raises(ValueError):
        sa.segment_aggregate_block_table_cuda(
            arena, ids, table, s, slot_ids=sl, num_slots=ns, num_cols=99)


def _stacked(dev, b=48, n=512, w=2, ld=2, s=256, slots=4, seed=3,
             pad_rows=0):
    """K1's stacked launch: values [b, n, w] read out of rows ``ld`` floats
    apart (``pad_rows`` extra events a row break the uniform stride),
    ids [b, n] with two out of range, ragged fills, slots [b]."""
    g = np.random.default_rng(seed)
    full = torch.tensor(g.uniform(0.0, 120.0, (b, n + pad_rows, ld)),
                        dtype=torch.float32, device=dev)
    vals = full[:, :n, :w]
    ids = torch.tensor(g.integers(0, s, (b, n)), dtype=torch.int32,
                       device=dev)
    ids[1, 3], ids[2, 7] = -1, s * slots + 3
    fills = g.integers(0, n + 1, b)
    valid = torch.tensor(np.arange(n)[None] < fills[:, None], device=dev)
    valid[1, 3] = valid[2, 7] = True
    sl = torch.tensor(g.integers(0, slots, b), dtype=torch.int32,
                      device=dev)
    return vals, ids, valid, sl, s, slots


@pytest.mark.parametrize("design", ["smem", "global"])
@pytest.mark.parametrize("w,ld,pad_rows,stats", [
    (2, 2, 0, ("sum", "count")),       # Linear Road's [speed, stopped]
    (1, 416, 0, sa.ALL_STATS),         # the stock fallback's price column
    (2, 5, 3, sa.ALL_STATS),           # rows off the uniform stride
])
def test_flat_smem_stacked_matches_plain(dev, design, w, ld, pad_rows,
                                         stats):
    """K1's stacked fold on both designs (the smem one by the rule, the
    global one forced) against the plain version: strided rows, invalid
    rows and out-of-range ids inert; counted by design on K1's wrapper."""
    vals, ids, valid, sl, s, ns = _stacked(dev, w=w, ld=ld,
                                           pad_rows=pad_rows)
    assert sa.splitk_design(sa.norm_stats(stats), ns * s, w) == "smem"
    counts = sa.segment_aggregate_cuda.launches_by_design
    before = dict(counts)
    out = sa.segment_aggregate_batched_cuda(
        vals, ids, s, valid=valid, slot_ids=sl, num_slots=ns, stats=stats,
        design=None if design == "smem" else design)
    assert counts[design] == before[design] + 1
    ref = sa.segment_aggregate_batched_plain(
        vals, ids, s, valid=valid, slot_ids=sl, num_slots=ns, stats=stats)
    torch.cuda.synchronize()
    _close(out, ref, ids.numel(), 120.0)


@pytest.mark.parametrize("stats", [sa.ALL_STATS, ("sum", "count"),
                                   ("min", "max"), ("count",)])
def test_flat_smem_nan_and_empty_slot_on_both_designs(dev, stats):
    """NaN values of live events win min/max and poison only their own
    sums; an invalid NaN stays inert; a slot no row names holds the
    identities; the flat wrapper (no slots) and the stacked one agree
    with the plain version on both designs."""
    vals, ids, valid, sl, s, ns = _stacked(dev, b=40, w=3, ld=3, s=16,
                                           slots=8)
    sl[sl == 7] = 6                              # slot 7: no row
    vals[5, 3, 1] = float("nan")
    valid[5, 3] = True
    vals[6, 4, 0] = float("nan")
    valid[6, 4] = False
    ref = sa.segment_aggregate_batched_plain(
        vals, ids, s, valid=valid, slot_ids=sl, num_slots=ns, stats=stats)
    comp = (sl[:, None] * s + ids).reshape(-1)
    flat_ref = sa.segment_aggregate_plain(vals.reshape(-1, 3), comp, ns * s,
                                          valid=valid.reshape(-1),
                                          stats=stats)
    for design in sa.SPLITK_DESIGNS:
        outs = [(sa.segment_aggregate_batched_cuda(
            vals, ids, s, valid=valid, slot_ids=sl, num_slots=ns,
            stats=stats, design=design), ref),
            (sa.segment_aggregate_cuda(vals.reshape(-1, 3), comp, ns * s,
                                       valid=valid.reshape(-1), stats=stats,
                                       design=design), flat_ref)]
        torch.cuda.synchronize()
        for out, want in outs:
            for k in out:
                assert torch.equal(torch.isnan(out[k]),
                                   torch.isnan(want[k])), k
            if "count" in stats:
                assert float(outs[0][0]["count"][7].abs().sum()) == 0.0
            if "min" in stats:
                assert bool(torch.isinf(outs[0][0]["min"][7]).all())
            _close({k: torch.nan_to_num(v) for k, v in out.items()},
                   {k: torch.nan_to_num(v) for k, v in want.items()},
                   ids.numel(), 120.0)


def test_flat_design_rule_sends_large_partials_to_global(dev):
    """K1: a partial past SPLITK_SMEM_BYTES goes to the global design, by
    the rule and counted; forcing smem there raises before any launch;
    Linear Road's 16 slots of 256 segments still fit."""
    assert sa.splitk_design(("sum", "count"), 16 * 256, 2) == "smem"
    assert sa.splitk_design(("sum", "count"), 17 * 256, 2) == "global"
    vals, ids, valid, sl, s, ns = _stacked(dev, b=20, slots=17)
    counts = sa.segment_aggregate_cuda.launches_by_design
    before = dict(counts)
    out = sa.segment_aggregate_batched_cuda(
        vals, ids, s, valid=valid, slot_ids=sl, num_slots=ns,
        stats=("sum", "count"))
    assert counts == dict(before, **{"global": before["global"] + 1})
    _close(out, sa.segment_aggregate_batched_plain(
        vals, ids, s, valid=valid, slot_ids=sl, num_slots=ns,
        stats=("sum", "count")), ids.numel(), 120.0)
    launches = sa.segment_aggregate_cuda.launches
    with pytest.raises(ValueError, match="smem design keeps"):
        sa.segment_aggregate_batched_cuda(
            vals, ids, s, valid=valid, slot_ids=sl, num_slots=ns,
            stats=("sum", "count"), design="smem")
    assert sa.segment_aggregate_cuda.launches == launches
