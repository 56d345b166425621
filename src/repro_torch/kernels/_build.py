"""Build and bind the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface,
which is loaded with ``ctypes``. A library lands in ``build/kernels/`` at
the root of the checkout, named by the source's stem and a hash of its
text, the shared headers' (``csrc/*.cuh``) and the flags, so an edit to a
source rebuilds that library only and an unchanged one is loaded as it
is. ``build_all`` starts one ``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module of
the package on machines with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# source -> {C entry point -> argument types} (every pointer and the
# stream as c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "segment_aggregate.cu": {
        "seg_agg_flat": [_P, _L, _I, _P, _P, _L, _I, _P, _P, _P, _P, _P],
        "seg_agg_block_table": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _I,
                                _P, _P, _P, _P, _P],
        "seg_agg_block_table_splitk": [_P, _I, _I, _I, _I, _P, _I, _P, _P,
                                       _I, _I, _P, _P, _P, _P, _P],
    },
    "segment_splitk.cu": {
        # arena, pool_slots, cap, W, w_out, table, R, ids, slots, valid
        # (may be null), S, S_total, chunk_rows, k, blocks_per_chunk,
        # events_per_block, stats, merge, scratch, sum, count, min, max
        # (each may be null), stream
        "seg_agg_splitk_smem": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _P]
        + [_I] * 8 + [_P] * 6,
        # arena, pool_slots, cap, W, w_out, table, R, ids, slots, valid
        # (may be null), S, S_total, events_per_block, stats, out, stream
        "seg_agg_block_table_smem": [_P, _I, _I, _I, _I, _P, _I, _P, _P,
                                     _P, _I, _I, _I, _I, _P, _P],
        # values, ld, N, rows, w_out, ids, slots (may be null), valid (may
        # be null), S, S_total, events_per_block, stats, out, stream
        "seg_agg_flat_smem": [_P, _L, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                              _I, _P, _P],
    },
    "attention.cu": {
        # q, k_pages, v_pages, table, lens, out, B, H, Hkv, D, P, page,
        # pages_per_seq, dtype, stream
        "decode_attention_paged": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _P],
        # q, k, v, o, lse (may be null), B, Sq, Sk, H, Hkv, D, causal,
        # window, dtype, stream
        "flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P],
    },
    "decode_hopper.cu": {
        # q, k_pages, v_pages, table, lens, scratch, out, B, H, Hkv, D, P,
        # page, pages_per_seq, pages_per_split, n_split, stream
        "decode_split_kv": [_P] * 7 + [_I] * 9 + [_P],
    },
    "flash_attention_bwd.cu": {
        # q, k, v, o, dO, lse, delta (scratch), dq, dk, dv, B, Sq, Sk, H,
        # Hkv, D, causal, window, dtype, stream
        "flash_attention_bwd": [_P] * 10 + [_I] * 9 + [_P],
    },
    "flash_fwd_hopper.cu": {
        # q, k, v, o, lse (may be null), sched, n_sched, B, Sq, Sk, H, Hkv,
        # D, causal, window, stream
        "flash_fwd_wgmma": [_P] * 6 + [_I] * 9 + [_P],
    },
    "flash_bwd_hopper.cu": {
        # q, k, v, o, dO, lse, scratch, dq, dk, dv, sched_q, n_q, sched_k,
        # n_k, B, Sq, Sk, H, Hkv, D, causal, window, stream
        "flash_bwd_wgmma": [_P] * 11 + [_I, _P] + [_I] * 9 + [_P],
    },
    "ssd_scan.cu": {
        # xdt, a, B, C, init_state (may be null), y, final_state, b, s, h,
        # p, n, dtype, stream
        "ssd_scan": [_P] * 7 + [_I] * 6 + [_P],
    },
    "ssd_hopper.cu": {
        # xdt, a, B, C, init_state (may be null), y, final_state,
        # workspace, b, s, h, p, n, chunk, heads per block, stream
        "ssd_tensor": [_P] * 8 + [_I] * 7 + [_P],
    },
}


class KernelLibrary:
    """One compiled source: its ctypes handle, the seconds its build took
    (0.0 when an earlier build was reused) and the compiler's report
    (``-Xptxas -v``: registers, spills)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log

    def call(self, name: str, *args) -> None:
        """Launch through C entry point ``name``; raise on a non-zero
        ``cudaGetLastError()`` (a refused launch never runs, and a later
        synchronise would not report it)."""
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                               f"cudaError {rc}")


_LOCKS = {source: threading.Lock() for source in SIGNATURES}
_LIBS: Dict[str, KernelLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are built from source at first use "
        "and need the CUDA toolkit")


def build(source: str = "segment_aggregate.cu") -> KernelLibrary:
    """Compile (or reuse) the library of ``source`` and bind its entry
    points."""
    if source not in SIGNATURES:
        raise ValueError(f"unknown kernel source {source!r} (of "
                         f"{sorted(SIGNATURES)})")
    src = CSRC / source
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{tag}.so"
    t0 = time.time()
    log = ""
    seconds = 0.0
    if not out.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
        os.replace(tmp, out)
        seconds = time.time() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, out, seconds, log)


def library(source: str = "segment_aggregate.cu") -> KernelLibrary:
    """The process-wide library of ``source``, built on first call."""
    if source not in _LOCKS:
        raise ValueError(f"unknown kernel source {source!r} (of "
                         f"{sorted(SIGNATURES)})")
    with _LOCKS[source]:
        if source not in _LIBS:
            _LIBS[source] = build(source)
        return _LIBS[source]


def build_all() -> Dict[str, KernelLibrary]:
    """Every source's library, the missing ones compiled at once (one
    ``nvcc`` per source, all started together)."""
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        libs = dict(zip(SIGNATURES, pool.map(library, SIGNATURES)))
    return libs
