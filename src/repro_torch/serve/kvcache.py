"""Tiered paged KV cache: Aion's m-bucket/p-bucket applied to serving.

Long-lived decode sessions are exactly "window state that must outlive the
memory horizon": each session's KV is block-granular **pages**; hot pages
live in the device pool (m-bucket) read by the ``decode_attention_paged``
kernel via the block table; cold pages are offloaded to a host pool
(p-bucket). The three paper mechanisms map one-to-one:

* proactive caching   — sessions predicted to decode soon (inter-arrival
                        EWMA per session) get their pages staged ahead of
                        the predicted time.
* predictive cleanup  — the distribution of session inter-arrival gaps
                        yields an adaptive idle bound (coverage quantile
                        with a DKW band); sessions idle past it are evicted
                        entirely.
* staleness trigger   — (engine-side) governs re-scoring of session
                        aggregates; not needed per token.

The policy code is the JAX package's (``repro/serve/kvcache.py``), line
for line, so that the two caches keep identical bookkeeping on the same
calls. What differs is the storage: ``k_pool`` / ``v_pool``
``[L, P, page, Hkv, D]`` are device tensors written in place (JAX rebuilt
them on every ``.at[].set``), and host pages are CPU tensors of the
pool's dtype (numpy has no bfloat16). Every pool write, host copy and
kernel launch runs on the device's current stream, and the copies to and
from host memory are blocking, so a destaged page is on the host before
its device page is reused.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.cleanup import PredictiveCleanup


@dataclass
class Session:
    session_id: int
    length: int = 0                       # valid tokens
    pages: List[int] = field(default_factory=list)      # device page ids
    host_pages: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = \
        field(default_factory=dict)       # logical page -> (k, v) host copies
    last_arrival: float = 0.0
    gap_ewma: float = 1.0
    finished: bool = False

    def predicted_next(self) -> float:
        return self.last_arrival + self.gap_ewma


class TieredKVCache:
    """Page pool: device tier (fixed pages) + host tier (unbounded)."""

    def __init__(self, *, num_device_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, num_layers: int,
                 dtype: torch.dtype = torch.bfloat16,
                 cleanup: Optional[PredictiveCleanup] = None, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.page_size = page_size
        self.num_device_pages = num_device_pages
        self.shape = (num_layers, num_device_pages, page_size,
                      num_kv_heads, head_dim)
        self.k_pool = torch.zeros(self.shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(self.shape, dtype=dtype, device=self.device)
        self.free_pages: List[int] = list(range(num_device_pages))
        self.sessions: Dict[int, Session] = {}
        # page ownership: device page -> (session, logical page idx)
        self.owner: Dict[int, Tuple[int, int]] = {}
        self.cleanup = cleanup or PredictiveCleanup(
            coverage=0.95, confidence=0.9, initial_bound=600.0,
            min_history=50)
        self.stats = {"staged": 0, "destaged": 0, "evicted_sessions": 0,
                      "alloc_fail": 0}

    def _to_pool(self, x) -> torch.Tensor:
        """A token's or page's K/V (numpy or tensor) as a tensor to write
        into the pool. Numpy float64 is taken to float32 first, as JAX
        canonicalises it, so a bf16 pool rounds the same value."""
        if isinstance(x, torch.Tensor):
            return x
        x = np.asarray(x)
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(x))

    # ------------------------------------------------------------ sessions
    def open_session(self, session_id: int, now: float) -> Session:
        s = Session(session_id=session_id, last_arrival=now)
        self.sessions[session_id] = s
        return s

    def observe_arrival(self, session_id: int, now: float) -> None:
        s = self.sessions[session_id]
        gap = max(now - s.last_arrival, 1e-6)
        if s.length:
            s.gap_ewma = 0.7 * s.gap_ewma + 0.3 * gap
            self.cleanup.observe(np.asarray([gap]))
        s.last_arrival = now

    # --------------------------------------------------------------- pages
    def _alloc_page(self, now: float) -> Optional[int]:
        if self.free_pages:
            return self.free_pages.pop()
        victim = self._pick_victim(now)
        if victim is None:
            self.stats["alloc_fail"] += 1
            return None
        self._destage_page(*victim)
        return self.free_pages.pop()

    def _pick_victim(self, now: float) -> Optional[Tuple[int, int]]:
        """Evict from the session with the largest predicted time until
        next decode (proactive: keep imminent sessions resident)."""
        best, best_score = None, -np.inf
        for sid, s in self.sessions.items():
            if not s.pages or s.finished:
                continue
            score = s.predicted_next() - now
            if s.finished:
                score = np.inf
            if score > best_score:
                # prefer the session's oldest page (front of the context)
                for li, pg in enumerate(s.pages):
                    if pg >= 0:
                        best, best_score = (sid, li), score
                        break
        return best

    def _destage_page(self, session_id: int, logical_idx: int) -> None:
        s = self.sessions[session_id]
        pg = s.pages[logical_idx]
        # blocking copies into host memory: the host copy is complete
        # before the page goes back on the free list and a later write,
        # enqueued after it, reuses the page
        k = self.k_pool[:, pg].to("cpu", copy=True)
        v = self.v_pool[:, pg].to("cpu", copy=True)
        s.host_pages[logical_idx] = (k, v)
        s.pages[logical_idx] = -1
        self.owner.pop(pg, None)
        self.free_pages.append(pg)
        self.stats["destaged"] += 1

    def _stage_page(self, session_id: int, logical_idx: int,
                    now: float) -> bool:
        s = self.sessions[session_id]
        if s.pages[logical_idx] >= 0:
            return True
        pg = self._alloc_page(now)
        if pg is None:
            return False
        k, v = s.host_pages.pop(logical_idx)
        # in place; a copy from pageable host memory is blocking
        self.k_pool[:, pg] = k
        self.v_pool[:, pg] = v
        s.pages[logical_idx] = pg
        self.owner[pg] = (session_id, logical_idx)
        self.stats["staged"] += 1
        return True

    # ------------------------------------------------------------- appends
    def append_token_kv(self, session_id: int, k_token, v_token,
                        now: float) -> bool:
        """k/v_token: [num_layers, num_kv_heads, head_dim] (numpy or
        tensor)."""
        s = self.sessions[session_id]
        slot = s.length % self.page_size
        logical = s.length // self.page_size
        if logical >= len(s.pages):
            pg = self._alloc_page(now)
            if pg is None:
                return False
            s.pages.append(pg)
            self.owner[pg] = (session_id, logical)
        elif s.pages[logical] < 0:
            if not self._stage_page(session_id, logical, now):
                return False
        pg = s.pages[logical]
        self.k_pool[:, pg, slot] = self._to_pool(k_token)
        self.v_pool[:, pg, slot] = self._to_pool(v_token)
        s.length += 1
        return True

    # ----------------------------------------------------------- proactive
    def prestage_due(self, now: float, horizon: float = 0.5) -> int:
        """Stage pages of sessions predicted to decode within ``horizon``
        seconds (proactive caching). Returns pages staged."""
        staged = 0
        order = sorted(self.sessions.values(),
                       key=lambda s: s.predicted_next())
        for s in order:
            if s.finished or s.predicted_next() - now > horizon:
                continue
            for li in list(s.host_pages.keys()):
                if self._stage_page(s.session_id, li, now):
                    staged += 1
        return staged

    # ------------------------------------------------------------- cleanup
    def cleanup_idle(self, now: float) -> int:
        """Predictive cleanup: evict sessions idle past the adaptive bound."""
        bound = self.cleanup.current_bound()
        evicted = 0
        for sid in list(self.sessions):
            s = self.sessions[sid]
            if s.finished or now - s.last_arrival > bound:
                for li, pg in enumerate(s.pages):
                    if pg >= 0:
                        self.owner.pop(pg, None)
                        self.free_pages.append(pg)
                s.pages.clear()
                s.host_pages.clear()
                del self.sessions[sid]
                evicted += 1
        self.stats["evicted_sessions"] += evicted
        return evicted

    # -------------------------------------------------------------- lookup
    def block_table(self, session_ids: List[int], pages_per_seq: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
        """(block_table [B, pages_per_seq], seq_lens [B], missing_pages):
        int32 tensors on the pool's device, and the (session, logical
        page) pairs that are host-resident, reported so the caller can
        stage them before launching the kernel (staging has max
        priority)."""
        table = np.full((len(session_ids), pages_per_seq), -1, np.int32)
        lens = np.zeros((len(session_ids),), np.int32)
        missing = []
        for i, sid in enumerate(session_ids):
            s = self.sessions[sid]
            lens[i] = s.length
            for li, pg in enumerate(s.pages[:pages_per_seq]):
                if pg < 0:
                    missing.append((sid, li))
                else:
                    table[i, li] = pg
        return (torch.from_numpy(table).to(self.device),
                torch.from_numpy(lens).to(self.device), missing)

    def device_pages_used(self) -> int:
        return self.num_device_pages - len(self.free_pages)
