"""The port's segment-aggregate entry points against the JAX package's,
replaying the segment-aggregate cases of ``tests/test_kernels.py``.

Here, on the CPU, every port call takes the kernels' plain torch versions
(the wrappers choose by the tensor's device); the JAX side runs as its
own tests run it (``ref``, ``dense`` or ``interpret``). The CUDA kernels
themselves are held against the plain versions on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Tolerances: ``count`` exact; ``min`` / ``max`` exact (no arithmetic, and
the same empty-segment identities); ``sum`` within rtol 1e-5 and atol
1e-5 x max|v| x rows, because the summation order differs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import (
    segment_aggregate as j_seg, segment_aggregate_batched as j_batched,
    segment_aggregate_block_table as j_bt,
    segment_aggregate_block_table_splitk as j_sk,
)
from repro.kernels import ref as JR
from repro.kernels.segment_aggregate import next_pow2 as j_next_pow2
from repro_torch.kernels import (
    segment_aggregate, segment_aggregate_batched,
    segment_aggregate_block_table, segment_aggregate_block_table_splitk,
)
from repro_torch.kernels.segment_aggregate import (
    ALL_STATS, merge_partials, next_pow2, norm_stats,
    segment_aggregate_block_table_splitk_plain, segment_aggregate_plain,
)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_aggs(out, ref, rows, scale, stats=ALL_STATS):
    """The stated tolerance: exact count/min/max, sum to the
    summation-order bound."""
    assert set(out) == set(stats)
    for k in stats:
        a = out[k].numpy() if isinstance(out[k], torch.Tensor) \
            else np.asarray(out[k])
        b = np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k == "sum":
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-5 * scale * max(rows, 1),
                err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _sel(out, stats):
    return {k: out[k] for k in stats}


# ------------------------------------------------------------ flat (K1)
@pytest.mark.parametrize("n,w,s", [(64, 1, 4), (1000, 8, 37),
                                   (4096, 16, 128), (130, 3, 5)])
def test_segment_aggregate_sweep(n, w, s):
    rng = np.random.default_rng(n)
    vals = rng.normal(size=(n, w)).astype(np.float32)
    ids = rng.integers(0, s, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    out = segment_aggregate(_t(vals), _t(ids), s, valid=_t(valid))
    ref = j_seg(jnp.asarray(vals), jnp.asarray(ids), s,
                valid=jnp.asarray(valid), backend="ref")
    _assert_aggs(out, ref, n, np.abs(vals).max())
    oracle = segment_aggregate_plain(_t(vals), _t(ids), s, valid=_t(valid))
    _assert_aggs(oracle, ref, n, np.abs(vals).max())


def test_segment_aggregate_all_invalid():
    out = segment_aggregate(torch.ones(64, 2),
                            torch.zeros(64, dtype=torch.int32),
                            4, valid=torch.zeros(64, dtype=torch.bool))
    assert float(out["count"].sum()) == 0.0
    assert float(out["sum"].sum()) == 0.0
    assert bool(torch.isposinf(out["min"]).all())
    assert bool(torch.isneginf(out["max"]).all())


def test_segment_aggregate_nan_min_max_matches_ref():
    """A NaN value wins min and max of its own segment only, as
    ``jnp.minimum``/``jnp.maximum`` in the JAX ref oracle; sums are not
    fed NaN (the JAX one-hot path would smear it over the tile)."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(96, 2)).astype(np.float32)
    vals[[3, 40], [0, 1]] = np.nan
    ids = rng.integers(0, 6, 96).astype(np.int32)
    out = segment_aggregate(_t(vals), _t(ids), 6, stats=("min", "max"))
    ref = j_seg(jnp.asarray(vals), jnp.asarray(ids), 6, backend="ref")
    for k in ("min", "max"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    assert np.isnan(out["min"].numpy()).sum() == 2


# ---------------------------------------------------- stacked batches (K1)
@pytest.mark.parametrize("b,n,w,s,num_slots", [
    (6, 64, 1, 4, 3), (8, 128, 4, 16, 8), (5, 100, 2, 7, 5)])
def test_segment_aggregate_batched_ragged_fills(b, n, w, s, num_slots):
    rng = np.random.default_rng(b * n)
    vals = rng.normal(size=(b, n, w)).astype(np.float32)
    ids = rng.integers(0, s, (b, n)).astype(np.int32)
    fills = rng.integers(1, n + 1, b)
    valid = np.arange(n)[None, :] < fills[:, None]
    slots = np.sort(rng.integers(0, num_slots, b)).astype(np.int32)
    out = segment_aggregate_batched(_t(vals), _t(ids), s, valid=_t(valid),
                                    slot_ids=_t(slots), num_slots=num_slots)
    ref = j_batched(jnp.asarray(vals), jnp.asarray(ids), s,
                    valid=jnp.asarray(valid), slot_ids=jnp.asarray(slots),
                    num_slots=num_slots, backend="interpret")
    assert out["sum"].shape == (num_slots, s, w)
    _assert_aggs(out, ref, b * n, np.abs(vals).max())


def test_segment_aggregate_batched_empty_batch_no_launch():
    out = segment_aggregate_batched(
        torch.zeros(0, 32, 3), torch.zeros(0, 32, dtype=torch.int32), 5,
        slot_ids=torch.zeros(0, dtype=torch.int32), num_slots=4)
    assert out["sum"].shape == (4, 5, 3)
    assert out["count"].shape == (4, 5)
    assert float(out["sum"].abs().sum()) == 0.0
    assert bool(torch.isposinf(out["min"]).all())
    assert bool(torch.isneginf(out["max"]).all())


def test_segment_aggregate_batched_equals_per_window_calls():
    rng = np.random.default_rng(11)
    b, n, w, s = 6, 64, 2, 5
    vals = _t(rng.normal(size=(b, n, w)).astype(np.float32))
    ids = _t(rng.integers(0, s, (b, n)).astype(np.int32))
    fills = rng.integers(1, n + 1, b)
    valid = _t(np.arange(n)[None, :] < fills[:, None])
    out = segment_aggregate_batched(vals, ids, s, valid=valid)
    for i in range(b):
        one = segment_aggregate(vals[i], ids[i], s, valid=valid[i])
        _assert_aggs({k: out[k][i] for k in ALL_STATS}, one, n, 5.0)


# ------------------------------------------------------- block table (K2)
@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("p,cap,w,s,r,num_slots", [
    (8, 32, 1, 4, 6, 4), (16, 64, 3, 7, 16, 8), (4, 128, 2, 16, 8, 2)])
def test_segment_aggregate_block_table_sweep(backend, p, cap, w, s, r,
                                             num_slots):
    rng = np.random.default_rng(p * cap + r)
    arena = rng.normal(size=(p, cap, w)).astype(np.float32)
    ids = rng.integers(0, s, (r, cap)).astype(np.int32)
    table = rng.integers(0, p, r).astype(np.int32)
    fills = rng.integers(0, cap + 1, r)
    valid = np.arange(cap)[None, :] < fills[:, None]
    slots = rng.integers(0, num_slots, r).astype(np.int32)
    out = segment_aggregate_block_table(
        _t(arena), _t(ids), _t(table), s, valid=_t(valid),
        slot_ids=_t(slots), num_slots=num_slots, backend=backend)
    ref = j_bt(jnp.asarray(arena), jnp.asarray(ids), jnp.asarray(table), s,
               valid=jnp.asarray(valid), slot_ids=jnp.asarray(slots),
               num_slots=num_slots, backend="dense")
    assert out["sum"].shape == (num_slots, s, w)
    _assert_aggs(out, ref, r * cap, np.abs(arena).max())


def test_segment_aggregate_block_table_num_cols_and_equals_stacked():
    """Referencing rows through the table == stacking the same rows; and
    ``num_cols`` keeps the leading value columns."""
    rng = np.random.default_rng(13)
    p, cap, w, s, r = 12, 48, 3, 5, 7
    arena = _t(rng.normal(size=(p, cap, w)).astype(np.float32))
    ids = _t(rng.integers(0, s, (r, cap)).astype(np.int32))
    table = _t(rng.integers(0, p, r).astype(np.int32))
    fills = rng.integers(1, cap + 1, r)
    valid = _t(np.arange(cap)[None, :] < fills[:, None])
    slots = _t(rng.integers(0, 4, r).astype(np.int32))
    bt = segment_aggregate_block_table(arena, ids, table, s, valid=valid,
                                       slot_ids=slots, num_slots=4,
                                       num_cols=1)
    stacked = segment_aggregate_batched(arena[table.long()][:, :, :1], ids,
                                        s, valid=valid, slot_ids=slots,
                                        num_slots=4)
    assert bt["sum"].shape == (4, s, 1)
    _assert_aggs(bt, stacked, r * cap, 5.0)


def test_segment_aggregate_block_table_empty_table():
    out = segment_aggregate_block_table(
        torch.zeros(4, 16, 2), torch.zeros(0, 16, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), 3,
        slot_ids=torch.zeros(0, dtype=torch.int32), num_slots=2)
    assert out["sum"].shape == (2, 3, 2)
    assert float(out["sum"].abs().sum()) == 0.0
    assert bool(torch.isposinf(out["min"]).all())


# ----------------------------------------------------------- split-K (K3)
def _splitk_case(p=16, cap=48, w=2, s=5, r=11, num_slots=4, seed=17):
    rng = np.random.default_rng(seed)
    arena = rng.normal(size=(p, cap, w)).astype(np.float32)
    ids = rng.integers(0, s, (r, cap)).astype(np.int32)
    table = rng.integers(1, p, r).astype(np.int32)        # never slot 0
    fills = rng.integers(0, cap + 1, r)
    valid = np.arange(cap)[None, :] < fills[:, None]
    slots = rng.integers(0, num_slots, r).astype(np.int32)
    return arena, ids, table, valid, slots, s, num_slots


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("chunk", [1, 3, 4, 11, 16])
def test_segment_aggregate_block_table_splitk_sweep(backend, chunk):
    arena, ids, table, valid, slots, s, ns = _splitk_case()
    out = segment_aggregate_block_table_splitk(
        _t(arena), _t(ids), _t(table), s, chunk, valid=_t(valid),
        slot_ids=_t(slots), num_slots=ns, backend=backend)
    for jbackend in ("dense", "ref"):
        ref = j_sk(jnp.asarray(arena), jnp.asarray(ids), jnp.asarray(table),
                   s, chunk, valid=jnp.asarray(valid),
                   slot_ids=jnp.asarray(slots), num_slots=ns,
                   backend=jbackend)
        _assert_aggs(out, ref, ids.size, np.abs(arena).max())


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("chunk", [3, 4])
def test_splitk_padding_rows_are_bit_exact_inert(backend, chunk):
    """Padding rows (masked invalid, aimed at a poisoned arena slot 0)
    change no stat, bit for bit: the pad-to-chunk rows the wrapper adds,
    and explicit all-invalid rows."""
    arena, ids, table, valid, slots, s, ns = _splitk_case(r=8)
    poisoned = arena.copy()
    poisoned[0] = 1e30
    kw = dict(num_slots=ns, backend=backend)
    out = segment_aggregate_block_table_splitk(
        _t(arena), _t(ids), _t(table), s, chunk, valid=_t(valid),
        slot_ids=_t(slots), **kw)
    pois = segment_aggregate_block_table_splitk(
        _t(poisoned), _t(ids), _t(table), s, chunk, valid=_t(valid),
        slot_ids=_t(slots), **kw)
    r_pad = 4
    pad = segment_aggregate_block_table_splitk(
        _t(poisoned),
        _t(np.concatenate([ids, np.zeros((r_pad, ids.shape[1]), np.int32)])),
        _t(np.concatenate([table, np.zeros(r_pad, np.int32)])), s, chunk,
        valid=_t(np.concatenate([valid, np.zeros((r_pad, valid.shape[1]),
                                                 bool)])),
        slot_ids=_t(np.concatenate([slots, np.zeros(r_pad, np.int32)])),
        **kw)
    for k in ALL_STATS:
        np.testing.assert_array_equal(out[k].numpy(), pois[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(out[k].numpy(), pad[k].numpy(),
                                      err_msg=k)
    ref = j_sk(jnp.asarray(poisoned), jnp.asarray(ids), jnp.asarray(table),
               s, chunk, valid=jnp.asarray(valid),
               slot_ids=jnp.asarray(slots), num_slots=ns, backend="dense")
    _assert_aggs(pad, ref, ids.size, np.abs(arena).max())


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_splitk_empty_and_zero_slot_guards(backend):
    arena = torch.zeros(4, 16, 2)
    out = segment_aggregate_block_table_splitk(
        arena, torch.zeros(0, 16, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), 3, 4,
        slot_ids=torch.zeros(0, dtype=torch.int32), num_slots=2,
        backend=backend)
    assert out["sum"].shape == (2, 3, 2)
    assert float(out["sum"].abs().sum()) == 0.0
    assert bool(torch.isposinf(out["min"]).all())
    assert bool(torch.isneginf(out["max"]).all())
    empty_slots = segment_aggregate_block_table_splitk(
        arena, torch.zeros(2, 16, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), 3, 4,
        slot_ids=torch.zeros(2, dtype=torch.int32), num_slots=0,
        backend=backend)
    assert empty_slots["sum"].shape == (0, 3, 2)
    with pytest.raises(ValueError):
        segment_aggregate_block_table_splitk(
            arena, torch.zeros(2, 16, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), 3, 0, num_slots=1,
            backend=backend)


def test_splitk_all_rows_invalid_yields_identity():
    arena, ids, table, valid, slots, s, ns = _splitk_case(r=6)
    for backend in ("auto", "ref"):
        out = segment_aggregate_block_table_splitk(
            _t(arena), _t(ids), _t(table), s, 4,
            valid=torch.zeros(valid.shape, dtype=torch.bool),
            slot_ids=_t(slots), num_slots=ns, backend=backend)
        assert float(out["sum"].abs().sum()) == 0.0
        assert int(out["count"].sum()) == 0
        assert bool(torch.isposinf(out["min"]).all())
        assert bool(torch.isneginf(out["max"]).all())


def test_merge_partials_identity_and_roundtrip():
    empty = merge_partials({
        "sum": torch.zeros(0, 2, 3, 1), "count": torch.zeros(0, 2, 3),
        "min": torch.zeros(0, 2, 3, 1), "max": torch.zeros(0, 2, 3, 1)})
    assert bool(torch.isposinf(empty["min"]).all())
    assert bool(torch.isneginf(empty["max"]).all())
    assert float(empty["sum"].abs().sum()) == 0.0
    arena, ids, table, valid, slots, s, ns = _splitk_case()
    parts = segment_aggregate_block_table_splitk_plain(
        _t(arena), _t(ids), _t(table), s, 4, valid=_t(valid),
        slot_ids=_t(slots), num_slots=ns, merge=False)
    assert parts["sum"].shape[0] == 3          # ceil(11 / 4) chunks
    merged = merge_partials(parts)
    whole = segment_aggregate_block_table_splitk(
        _t(arena), _t(ids), _t(table), s, 4, valid=_t(valid),
        slot_ids=_t(slots), num_slots=ns)
    for k in ALL_STATS:
        np.testing.assert_array_equal(merged[k].numpy(), whole[k].numpy(),
                                      err_msg=k)
    from repro.kernels.segment_aggregate import (
        segment_aggregate_block_table_splitk_pallas as j_pallas)
    jparts = j_pallas(jnp.asarray(arena), jnp.asarray(ids),
                      jnp.asarray(table), s, 4, valid=jnp.asarray(valid),
                      slot_ids=jnp.asarray(slots), num_slots=ns,
                      merge=False)
    for c in range(3):
        _assert_aggs({k: v[c] for k, v in parts.items()},
                     {k: v[c] for k, v in jparts.items()}, 4 * 48,
                     np.abs(arena).max())


def test_pack_rows_and_helpers():
    """The single-device helpers (the multi-device row packing,
    ``pack_rows_shard_major``, comes with the slot-sharded slice)."""
    assert [next_pow2(n) for n in (0, 1, 3, 8, 9)] == [1, 1, 4, 8, 16]
    assert [next_pow2(n) for n in (0, 1, 3, 8, 9)] == \
        [j_next_pow2(n) for n in (0, 1, 3, 8, 9)]
    assert norm_stats(("max", "sum", "max")) == ("sum", "max")
    for bad in ((), ("median",)):
        with pytest.raises(ValueError):
            norm_stats(bad)


@pytest.mark.parametrize("stats", [("sum", "count"), ("count",),
                                   ("min", "max"), ("sum",)])
def test_segment_aggregate_stats_selection(stats):
    """Only the requested aggregates come back, equal to the full-run
    values (single, batched and block-table entry points)."""
    rng = np.random.default_rng(len(stats))
    n, w, s = 96, 2, 6
    vals = _t(rng.normal(size=(n, w)).astype(np.float32))
    ids = _t(rng.integers(0, s, n).astype(np.int32))
    _assert_aggs(segment_aggregate(vals, ids, s, stats=stats),
                 _sel(segment_aggregate(vals, ids, s), stats), n, 5.0,
                 stats)
    b, cap = 4, 24
    bvals = _t(rng.normal(size=(b, cap, w)).astype(np.float32))
    bids = _t(rng.integers(0, s, (b, cap)).astype(np.int32))
    _assert_aggs(segment_aggregate_batched(bvals, bids, s, stats=stats),
                 _sel(segment_aggregate_batched(bvals, bids, s), stats),
                 b * cap, 5.0, stats)
    table = _t(rng.integers(0, b, 5).astype(np.int32))
    kw = dict(slot_ids=torch.zeros(5, dtype=torch.int32), num_slots=1)
    _assert_aggs(
        segment_aggregate_block_table(bvals, bids[table.long()], table, s,
                                      stats=stats, **kw),
        _sel(segment_aggregate_block_table(bvals, bids[table.long()], table,
                                           s, **kw), stats),
        5 * cap, 5.0, stats)


def test_mesh_and_unknown_backend_raise():
    with pytest.raises(NotImplementedError):
        segment_aggregate_batched(torch.zeros(2, 4, 1),
                                  torch.zeros(2, 4, dtype=torch.int32), 2,
                                  mesh=object())
    with pytest.raises(ValueError):
        segment_aggregate(torch.zeros(4, 1), torch.zeros(4), 2,
                          backend="interpret")


def test_array_inputs_default_to_the_card():
    """Array-likes go to ``device``, which defaults to the card; on a
    machine without CUDA that raises rather than running on the CPU."""
    vals = np.ones((4, 1), np.float32)
    ids = np.zeros(4, np.int32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            segment_aggregate(vals, ids, 2)
    out = segment_aggregate(vals, ids, 2, device="cpu")
    assert out["count"].tolist() == [4.0, 0.0]


def test_kernel_library_build_raises_without_nvcc(monkeypatch):
    """A CUDA tensor's wrapper launches the kernel or raises: building the
    library where no nvcc exists raises with the reason, never falls
    back."""
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "BUILD_DIR",
                        _build.BUILD_DIR.parent / "nonexistent-kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
