"""Which design runs a flash kernel (K5, K6), and the tile schedules of the
tensor-core design.

The wrappers (``flash_attention_cuda``, ``flash_attention_bwd_cuda``) pick
the design by the inputs' type and head dim, from this table, and never
on a failure:

    ==========  ===========  =============  =================================
    dtype       head dim     design         sources
    ==========  ===========  =============  =================================
    bfloat16    64, 128      ``wgmma``      ``csrc/flash_fwd_hopper.cu``,
                                            ``csrc/flash_bwd_hopper.cu``
    bfloat16    32, 256      ``cuda_core``  ``csrc/attention.cu``,
                                            ``csrc/flash_attention_bwd.cu``
    float32     any          ``cuda_core``  the same
    ==========  ===========  =============  =================================

``wgmma`` is bf16 on the tensor cores, with P (and in the backward dS)
rounded to bf16 before its product, as the Pallas kernels round them.
``cuda_core`` is the fp32 CUDA-core design of PRs 12 and 13: fp32 stays
exact there (no TF32), so float32 runs remain the exact baseline.

A tile schedule lists, for each block of a launch, its tile along one axis
and the range of tiles along the other that the masks leave (a causal
and/or sliding window, positions of q and k counted from 0), longest range
first: CUDA starts blocks in about the order of their index, so the
long blocks of the causal diagonal start first and the short ones fill
the tail. Every tile of the block axis appears once, an empty range
included (its block writes NaN or zeros). The kernels read it as an int32
[n, 3] tensor: (tile, first partner tile, end partner tile).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

DESIGNS = ("wgmma", "cuda_core")
WGMMA_HEAD_DIMS = (64, 128)
#: (block tile, partner tile) of each wgmma pass: K5 blocks of 128 query
#: rows walk tiles of 128 keys; K6's dq pass 128 query rows by 64 keys,
#: its dk/dv pass 128 keys by 64 query rows
FWD_TILES = (128, 128)
DQ_TILES = (128, 64)
DKV_TILES = (128, 64)
#: K6's per-row scratch (lse, D) is padded to a multiple of this
ROW_PAD = 128


def design(dtype: torch.dtype, head_dim: int, forced: str | None = None
           ) -> str:
    """The design the table gives (dtype, head_dim), or ``forced`` (a
    measurement's choice), which must take these inputs."""
    table = "wgmma" if dtype == torch.bfloat16 \
        and head_dim in WGMMA_HEAD_DIMS else "cuda_core"
    if forced is None:
        return table
    if forced not in DESIGNS:
        raise ValueError(f"design {forced!r} is none of {DESIGNS}")
    if forced == "wgmma" and table != "wgmma":
        raise ValueError(f"the wgmma design takes bfloat16 at head dims "
                         f"{WGMMA_HEAD_DIMS}, got {dtype} at {head_dim}")
    return forced


def _key_range(q_first: int, q_last: int, sk: int, causal: bool,
               window: int) -> tuple:
    """[lo, hi): the keys that some query in [q_first, q_last] attends
    (every key in it is attended by one of them)."""
    hi = min(sk, q_last + 1) if causal else sk
    lo = max(0, q_first - window + 1) if window > 0 else 0
    return lo, hi


def _query_range(k_first: int, k_last: int, sq: int, causal: bool,
                 window: int) -> tuple:
    """[lo, hi): the queries that attend some key in [k_first, k_last]."""
    lo = k_first if causal else 0
    hi = min(sq, k_last + window) if window > 0 else sq
    return lo, hi


@functools.lru_cache(maxsize=256)
def tile_schedule(sq: int, sk: int, causal: bool, window: int, rows: int,
                  cols: int, by_keys: bool = False) -> np.ndarray:
    """int32 [n, 3], read-only: one entry per tile of ``rows`` queries
    (``by_keys``: keys), with the range of tiles of ``cols`` keys (queries)
    that the masks leave it, longest range first (ties by tile)."""
    n = sk if by_keys else sq
    out = []
    for t in range(-(-n // rows)):
        first, last = t * rows, min((t + 1) * rows, n) - 1
        lo, hi = (_query_range(first, last, sq, causal, window) if by_keys
                  else _key_range(first, last, sk, causal, window))
        out.append((t, lo // cols, -(-hi // cols)) if hi > lo else (t, 0, 0))
    out.sort(key=lambda e: (e[1] - e[2], e[0]))
    arr = np.asarray(out, dtype=np.int32).reshape(-1, 3)
    arr.flags.writeable = False
    return arr


@functools.lru_cache(maxsize=256)
def schedule_tensor(sq: int, sk: int, causal: bool, window: int, rows: int,
                    cols: int, by_keys: bool, device: torch.device
                    ) -> torch.Tensor:
    """``tile_schedule`` on ``device``, copied there once per shape and
    shared by every launch of that shape: read it, never write it."""
    return torch.from_numpy(tile_schedule(sq, sk, causal, window, rows, cols,
                                          by_keys).copy()).to(device)


def check_tma(**tensors: torch.Tensor) -> None:
    """TMA reads from 16-byte aligned addresses: raise on any other."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             "the TMA loads of the wgmma design")
