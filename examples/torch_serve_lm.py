"""End-to-end serving driver on the PyTorch/CUDA port: batched requests
through the AION-tiered paged KV cache and the paged decode attention
kernel (K4) on the card.

A small device page pool forces cold sessions to offload host-side
(p-bucket) and restage (proactive caching) — the serving realization of
the paper's technique. The sizes, the float32 pages, the cleanup
settings and the lines printed are ``examples/serve_lm.py``'s.

    PYTHONPATH=src python examples/torch_serve_lm.py
"""
import time

import numpy as np
import torch

from repro_torch.core.cleanup import PredictiveCleanup
from repro_torch.serve.kvcache import TieredKVCache
from repro_torch.serve.scheduler import ContinuousBatcher, Request

HKV, D, PAGE = 4, 64, 16


def main(device=None):
    """Serve the 8 requests on ``device`` (``None``: the card)."""
    rng = np.random.default_rng(0)
    cache = TieredKVCache(
        num_device_pages=24, page_size=PAGE, num_kv_heads=HKV, head_dim=D,
        num_layers=1, dtype=torch.float32,
        cleanup=PredictiveCleanup(coverage=0.9, confidence=0.9,
                                  min_history=20, initial_bound=30.0),
        device=device)
    sched = ContinuousBatcher(cache, max_batch=4, pages_per_seq=16)

    # 8 requests with prompts of varying length
    n_req = 8
    for rid in range(n_req):
        plen = int(rng.integers(20, 60))
        req = Request(request_id=rid, session_id=rid, prompt_len=plen,
                      max_new_tokens=24, arrived_at=0.0)
        kp = rng.normal(size=(1, plen, HKV, D)).astype(np.float32)
        vp = rng.normal(size=(1, plen, HKV, D)).astype(np.float32)
        sched.submit(req, kp, vp, now=0.0)

    def q_fn(sids):
        return torch.as_tensor(rng.normal(size=(len(sids), HKV * 2, D)),
                               dtype=torch.float32, device=cache.device)

    def kv_fn(sids):
        return (rng.normal(size=(len(sids), 1, HKV, D)).astype(np.float32),
                rng.normal(size=(len(sids), 1, HKV, D)).astype(np.float32))

    t0 = time.time()
    now, steps = 1.0, 0
    while len(sched.completed) < n_req and steps < 200:
        sched.step(q_fn, kv_fn, now=now)
        now += 0.05
        steps += 1
    dt = time.time() - t0

    tok = sum(r.generated for r in sched.completed)
    print(f"completed {len(sched.completed)}/{n_req} requests, "
          f"{tok} tokens in {dt:.2f}s ({tok / dt:.0f} tok/s)")
    print(f"tiering: {cache.stats['staged']} pages staged, "
          f"{cache.stats['destaged']} destaged, "
          f"{cache.stats['evicted_sessions']} sessions cleaned up; "
          f"device pages in use: {cache.device_pages_used()}"
          f"/{cache.num_device_pages}")
    return sched


if __name__ == "__main__":
    main()
