"""Continuous-batching request scheduler over the tiered KV cache.

Decode-centric loop (vLLM-style): a fixed decode batch of sessions steps
one token at a time through ``decode_attention_paged`` (K4); sessions join
as pages allow and leave on completion. Before each step the scheduler
(a) stages any host-resident pages of scheduled sessions (staging = max
priority), (b) pre-stages sessions predicted to arrive within the horizon
(proactive caching), (c) evicts idle sessions past the adaptive bound
(predictive cleanup).

The JAX package's scheduler (``repro/serve/scheduler.py``), line for line;
``step`` reaches the kernel through ``repro_torch.kernels.ops``, looked up
at each call.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.serve.kvcache import TieredKVCache


@dataclass
class Request:
    request_id: int
    session_id: int
    prompt_len: int
    max_new_tokens: int
    arrived_at: float
    generated: int = 0
    done: bool = False
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class ContinuousBatcher:
    def __init__(self, cache: TieredKVCache, *, max_batch: int = 8,
                 pages_per_seq: int = 64, prestage_horizon: float = 0.5):
        self.cache = cache
        self.max_batch = max_batch
        self.pages_per_seq = pages_per_seq
        self.prestage_horizon = prestage_horizon
        self.waiting: Deque[Request] = deque()
        self.active: List[Request] = []
        self.completed: List[Request] = []
        self.steps = 0

    def submit(self, req: Request, k_prompt, v_prompt, now: float) -> None:
        """k/v_prompt: [L, prompt_len, Hkv, D] precomputed prompt KV
        (prefill output), numpy or tensor."""
        self.cache.open_session(req.session_id, now)
        for t in range(req.prompt_len):
            ok = self.cache.append_token_kv(
                req.session_id, k_prompt[:, t], v_prompt[:, t], now)
            if not ok:
                break
        self.waiting.append(req)

    def _admit(self, now: float) -> None:
        while self.waiting and len(self.active) < self.max_batch:
            self.active.append(self.waiting.popleft())

    def step(self, q_fn: Callable[[List[int]], torch.Tensor],
             kv_fn: Callable[[List[int]], tuple], now: float
             ) -> Optional[torch.Tensor]:
        """One decode step for the active batch.

        q_fn(session_ids)  -> [B, H, D] per-session query vectors
        kv_fn(session_ids) -> ([B, L, Hkv, D], same) new-token K/V to append
        Returns attention outputs [B, H, D] (or None if batch empty).
        """
        self._admit(now)
        if not self.active:
            self.cache.prestage_due(now, self.prestage_horizon)
            self.cache.cleanup_idle(now)
            return None
        sids = [r.session_id for r in self.active]
        for sid in sids:
            self.cache.observe_arrival(sid, now)

        table, lens, missing = self.cache.block_table(sids,
                                                      self.pages_per_seq)
        # staging has max priority: bring any cold pages in before compute
        for sid, li in missing:
            self.cache._stage_page(sid, li, now)
        if missing:
            table, lens, _ = self.cache.block_table(sids, self.pages_per_seq)

        q = q_fn(sids)
        # the scheduler drives attention layer-by-layer; layer 0 shown here
        # (a model's serving loop runs every layer over the same table)
        out = ops.decode_attention_paged(q, self.cache.k_pool[0],
                                         self.cache.v_pool[0], table, lens,
                                         device=self.cache.device)

        k_new, v_new = kv_fn(sids)
        for i, req in enumerate(self.active):
            self.cache.append_token_kv(req.session_id, k_new[i], v_new[i],
                                       now)
            req.generated += 1
            if req.first_token_at is None:
                req.first_token_at = now
            if req.generated >= req.max_new_tokens:
                req.done = True
                req.finished_at = now
                self.cache.sessions[req.session_id].finished = True
        self.completed.extend(r for r in self.active if r.done)
        self.active = [r for r in self.active if not r.done]

        # background work (low priority): proactive staging + cleanup
        self.cache.prestage_due(now, self.prestage_horizon)
        self.cache.cleanup_idle(now)
        self.steps += 1
        return out
