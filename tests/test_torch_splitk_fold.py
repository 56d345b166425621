"""K3's shared-memory design on the CPU: its host-side design rule and
block plan, and a numpy emulation of its order of work held against the
JAX package's split-K fold on the same inputs.

The emulation follows ``csrc/segment_splitk.cu``: each chunk of
``chunk_rows`` rows is cut into ``splitk_plan``'s blocks of consecutive
events (rows past R are never read), each block folds its events into a
private partial initialised to the identities, the last block of each
chunk folds the chunk's blocks in block order, and with ``merge=True``
the last chunk folds the chunks' partials in chunk order, min and max
letting NaN win. SPLITK_EVENTS_PER_BLOCK is
set small here so that a chunk takes several blocks and blocks end
inside rows, as the stock fold's chunks do on the card.

Tolerances as ``tests/test_torch_kernels.py``: count, min and max exact;
sums within rtol 1e-5 and atol 1e-5 x max|v| x rows (another order). The
kernel itself is held against the plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 3)."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.segment_aggregate import (
    segment_aggregate_block_table_splitk_dense as j_dense,
    segment_aggregate_block_table_splitk_pallas as j_pallas)

sa = importlib.import_module("repro_torch.kernels.segment_aggregate")
IDENT = {"sum": 0.0, "count": 0.0, "min": np.inf, "max": -np.inf}


def _emulate(arena, ids, table, valid, slots, s, chunk, ns, stats,
             num_cols, merge):
    """K3's smem order of work in numpy float32."""
    p, cap, w = arena.shape
    w_out = num_cols or w
    r = table.shape[0]
    s_total = ns * s
    k, per_chunk, per_block = sa.splitk_plan(r, cap, chunk)

    def fresh():
        return {st: np.full((s_total,) if st == "count" else
                            (s_total, w_out), IDENT[st], np.float32)
                for st in stats}

    blocks = []
    for c in range(k):
        chunk_end = min((c + 1) * chunk, r) * cap
        for j in range(per_chunk):
            part = fresh()
            e0 = c * chunk * cap + j * per_block
            for e in range(e0, min(e0 + per_block, chunk_end)):
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
                        part[st][comp] = np.minimum(part[st][comp], v)
                    else:
                        part[st][comp] = np.maximum(part[st][comp], v)
            blocks.append(part)

    def fold(group):
        out = fresh()
        for part in group:
            for st in stats:
                f = {"min": np.minimum, "max": np.maximum}.get(st, np.add)
                out[st] = f(out[st], part[st]).astype(np.float32)
        return out

    def shaped(x, lead):
        return {st: v.reshape(lead + ((ns, s) if st == "count"
                                      else (ns, s, w_out)))
                for st, v in x.items()}

    chunks = [fold(blocks[c * per_chunk:(c + 1) * per_chunk])
              for c in range(k)]
    if merge:
        return shaped(fold(chunks), ())
    return {st: np.stack([shaped(x, ())[st] for x in chunks])
            for st in stats}


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


@pytest.mark.parametrize("rows,cap,chunk,want", [
    (512, 512, 64, (8, 16, 2048)),  # the stock fold of phase 2: 128 blocks
    (90, 512, 7, (13, 2, 1792)),
    (10, 512, 1, (10, 1, 512)),
    (3, 3000, 1, (3, 2, 1500)),
    (5, 0, 2, (3, 1, 0)),
])
def test_splitk_plan(rows, cap, chunk, want):
    got = sa.splitk_plan(rows, cap, chunk)
    assert got == want
    k, per_chunk, per_block = got
    assert per_chunk * per_block >= chunk * cap
    assert per_block <= sa.SPLITK_EVENTS_PER_BLOCK


@pytest.mark.parametrize("stats,s_total,w_out,want", [
    (sa.ALL_STATS, 256, 1, "smem"),         # the stock fold: 4 KB
    (("sum", "count"), 2, 1, "smem"),       # the average fold
    (("count",), 12_288, 416, "smem"),      # counts ignore the width
    (sa.ALL_STATS, 1_024, 3, "smem"),       # 40,960 bytes
    (sa.ALL_STATS, 1_024, 4, "global"),     # 53,248 bytes
    (("sum",), 12_288, 1, "smem"),          # exactly 48 KB
    (("sum",), 12_289, 1, "global"),
    (sa.ALL_STATS, 2, 416, "smem"),
])
def test_splitk_design_rule(stats, s_total, w_out, want):
    nbytes = sa.splitk_partial_bytes(stats, s_total, w_out)
    assert (nbytes <= sa.SPLITK_SMEM_BYTES) == (want == "smem")
    assert sa.splitk_design(stats, s_total, w_out) == want
    assert sa.splitk_design(stats, s_total, w_out, "global") == "global"
    if want == "global":
        with pytest.raises(ValueError, match="smem design keeps"):
            sa.splitk_design(stats, s_total, w_out, "smem")
    with pytest.raises(ValueError, match="none of"):
        sa.splitk_design(stats, s_total, w_out, "shared")


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("chunk,per_block,r", [
    (4, 40, 11),        # 11 rows: a ragged last chunk, blocks inside rows
    (3, 48, 9),         # rows a multiple of the chunk, one row a block
    (1, 1000, 7),       # one block per chunk
    (16, 100, 11),      # one chunk longer than the rows
])
def test_splitk_order_of_work_matches_jax(monkeypatch, merge, chunk,
                                         per_block, r):
    monkeypatch.setattr(sa, "SPLITK_EVENTS_PER_BLOCK", per_block)
    arena, ids, table, valid, slots, s, ns = _case(r=r)
    got = _emulate(arena, ids, table, valid, slots, s, chunk, ns,
                   sa.ALL_STATS, None, merge)
    ref = j_dense(jnp.asarray(arena), jnp.asarray(ids), jnp.asarray(table),
                  s, chunk, valid=jnp.asarray(valid),
                  slot_ids=jnp.asarray(slots), num_slots=ns, merge=merge)
    _assert_aggs(got, ref, ids.size, np.abs(arena).max())
    plain = sa.segment_aggregate_block_table_splitk_plain(
        *(torch.from_numpy(x) for x in (arena, ids, table)), s, chunk,
        valid=torch.from_numpy(valid), slot_ids=torch.from_numpy(slots),
        num_slots=ns, merge=merge)
    _assert_aggs(got, {k: v.numpy() for k, v in plain.items()}, ids.size,
                 np.abs(arena).max())


def test_splitk_nan_and_empty_chunk_match_pallas(monkeypatch):
    """NaN wins min and max; a chunk whose rows are all invalid holds the
    identities. Raw partials, num_cols=1 as the engine folds: count, min
    and max against the Pallas kernel in interpret mode; the sums against
    the plain version, since the Pallas one-hot product spreads a NaN to
    every sum of its tile where ``ref`` keeps it in its own segment
    (ROADMAP Queue 3, item 1)."""
    monkeypatch.setattr(sa, "SPLITK_EVENTS_PER_BLOCK", 40)
    arena, ids, table, valid, slots, s, ns = _case(r=12)
    arena[table[2], 5, 0] = np.nan
    valid[2, 5] = True
    valid[4:8] = False                   # chunk 1 of 4 rows: empty
    got = _emulate(arena, ids, table, valid, slots, s, 4, ns, sa.ALL_STATS,
                   1, False)
    assert float(np.abs(got["count"][1]).sum()) == 0.0
    assert float(np.abs(got["sum"][1]).sum()) == 0.0
    assert np.isposinf(got["min"][1]).all()
    assert np.isneginf(got["max"][1]).all()
    nan = np.isnan(got["sum"])          # the rows that read the NaN
    assert nan.any() and not nan.all()
    assert np.array_equal(np.isnan(got["min"]), nan)
    assert np.array_equal(np.isnan(got["max"]), nan)
    ref = j_pallas(jnp.asarray(arena), jnp.asarray(ids), jnp.asarray(table),
                   s, 4, valid=jnp.asarray(valid),
                   slot_ids=jnp.asarray(slots), num_slots=ns, num_cols=1,
                   merge=False)
    _assert_aggs({k: got[k] for k in ("count", "min", "max")},
                 {k: np.asarray(ref[k]) for k in ("count", "min", "max")},
                 ids.size, 1.0)
    plain = sa.segment_aggregate_block_table_splitk_plain(
        *(torch.from_numpy(x) for x in (arena, ids, table)), s, 4,
        valid=torch.from_numpy(valid), slot_ids=torch.from_numpy(slots),
        num_slots=ns, num_cols=1, merge=False)["sum"].numpy()
    np.testing.assert_array_equal(np.isnan(got["sum"]), np.isnan(plain))
    _assert_aggs({"sum": np.nan_to_num(got["sum"])},
                 {"sum": np.nan_to_num(plain)}, ids.size,
                 np.nanmax(np.abs(arena)))
