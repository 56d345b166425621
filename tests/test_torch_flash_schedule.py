"""The host-built tile schedules of the tensor-core flash kernels
(``repro_torch.kernels.flash_tiles``) and the table that picks a flash
kernel's design, on the CPU.

A schedule gives each block of a launch its tile along one axis and the
range of tiles along the other that the masks leave; the kernels walk
exactly that range (K5's forward and K6's dq pass: per (b, h) block, the
key tiles of its query tile; K6's dk/dv pass: per (b, hkv) block, the
query tiles of its key tile, for each of the G heads of the group). Here
the launches are replayed at tile granularity against the element masks:
every (query, key) pair that the masks keep lies in a visited tile pair,
visited exactly once per head; no visited tile pair is empty; every tile
of the block axis has one block; and the blocks run longest first.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_tiles as T

# sq, sk, causal, window, h, hkv
CASES = [
    (4096, 4096, True, 0, 36, 4),        # starcoder2-7b: G = 9, causal
    (4096, 4096, True, 1024, 25, 5),     # hymba-1.5b: G = 5, window 1,024
    (600, 600, True, 0, 4, 2),           # ragged: S = 600
    (1000, 600, True, 0, 4, 1),          # Sq > Sk
    (600, 1000, True, 0, 4, 1),          # Sq < Sk
    (700, 700, False, 100, 2, 1),        # a window without causal
    (256, 64, True, 32, 2, 2),           # late rows see no key at all
    (128, 384, False, 0, 2, 2),          # cross-attention shape
]
PASSES = {"forward": (T.FWD_TILES, False), "dq": (T.DQ_TILES, False),
          "dkv": (T.DKV_TILES, True)}


def _mask(sq, sk, causal, window):
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    keep = np.ones((sq, sk), bool)
    if causal:
        keep &= q >= k
    if window > 0:
        keep &= q - k < window
    return keep


def _kept_per_tile(sq, sk, causal, window, tq, tk):
    """[ceil(sq / tq), ceil(sk / tk)]: kept pairs in each tile pair."""
    keep = _mask(sq, sk, causal, window)
    nq, nk = -(-sq // tq), -(-sk // tk)
    pad = np.zeros((nq * tq, nk * tk), bool)
    pad[:sq, :sk] = keep
    return pad.reshape(nq, tq, nk, tk).sum(axis=(1, 3))


def _launch(case, name):
    """(visits [H, query tiles, key tiles], the schedule, tile sizes) of
    one pass, replayed as its kernel walks it."""
    sq, sk, causal, window, h, hkv = case
    (rows, cols), by_keys = PASSES[name]
    sched = T.tile_schedule(sq, sk, causal, window, rows, cols, by_keys)
    tq, tk = (cols, rows) if by_keys else (rows, cols)
    visits = np.zeros((h, -(-sq // tq), -(-sk // tk)), np.int64)
    g = h // hkv
    for tile, lo, hi in sched:
        for other in range(lo, hi):
            qt, kt = (other, tile) if by_keys else (tile, other)
            if by_keys:                  # one block per KV head walks G heads
                for j in range(hkv):
                    visits[j * g:(j + 1) * g, qt, kt] += 1
            else:                        # one block per head
                visits[:, qt, kt] += 1
    return visits, sched, (tq, tk)


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_every_kept_pair_is_visited_exactly_once(case, name):
    sq, sk, causal, window, h, hkv = case
    visits, _, (tq, tk) = _launch(case, name)
    kept = _kept_per_tile(sq, sk, causal, window, tq, tk)
    assert kept.sum() == _mask(sq, sk, causal, window).sum()
    for head in range(h):
        assert np.array_equal(visits[head] == 1, kept > 0), head
        assert visits[head].max() <= 1


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_no_tile_the_mask_empties_is_visited(case, name):
    sq, sk, causal, window, h, hkv = case
    visits, _, (tq, tk) = _launch(case, name)
    kept = _kept_per_tile(sq, sk, causal, window, tq, tk)
    assert not ((visits > 0) & (kept == 0)[None]).any()


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_every_block_tile_has_one_block_longest_first(case, name):
    sq, sk, *_ = case
    (rows, _), by_keys = PASSES[name]
    _, sched, _ = _launch(case, name)
    n = -(-(sk if by_keys else sq) // rows)
    assert sched.dtype == np.int32 and sched.shape == (n, 3)
    assert sorted(sched[:, 0].tolist()) == list(range(n))
    lengths = (sched[:, 2] - sched[:, 1]).tolist()
    assert lengths == sorted(lengths, reverse=True)
    assert not sched.flags.writeable


def test_causal_dkv_schedule_starts_with_the_key_tile_at_zero():
    """starcoder2-7b's training shape: the key tile at position 0 walks
    all 64 query tiles of 64 and starts first; the last walks two."""
    sched = T.tile_schedule(4096, 4096, True, 0, *T.DKV_TILES, True)
    assert sched[0].tolist() == [0, 0, 64]
    assert sched[-1].tolist() == [31, 62, 64]


def test_schedule_tensor_is_cached_per_shape_and_device():
    a = T.schedule_tensor(600, 600, True, 0, 128, 64, False,
                          torch.device("cpu"))
    b = T.schedule_tensor(600, 600, True, 0, 128, 64, False,
                          torch.device("cpu"))
    assert a is b and a.dtype == torch.int32
    assert np.array_equal(a.numpy(),
                          T.tile_schedule(600, 600, True, 0, 128, 64))


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "cuda_core"), (torch.bfloat16, 256, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 128, "cuda_core"),
])
def test_design_table(dtype, d, want):
    assert T.design(dtype, d) == want
    assert T.design(dtype, d, "cuda_core") == "cuda_core"
    if want == "wgmma":
        assert T.design(dtype, d, "wgmma") == "wgmma"
    else:
        with pytest.raises(ValueError, match="wgmma design takes"):
            T.design(dtype, d, "wgmma")
    with pytest.raises(ValueError, match="none of"):
        T.design(dtype, d, "tf32")
