"""Serving entry point: batched prefill + decode with the model-level
cache; the JAX package's ``launch/serve.py`` with the same flags, loop and
output, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --smoke --batch 4 --prompt-len 64 --new-tokens 32

Runs greedy decoding for a batch of synthetic prompts (``default_rng(0)``)
and reports tokens/sec. ``--smoke`` is a ``store_true`` flag whose default
is True, as in the JAX entry point, so the command line always serves the
reduced same-family config (``reduced(cfg)``). The tiered paged-KV path
is ``serve.ContinuousBatcher``; this entry point is the plain model-level
loop. ``serve`` is the loop itself, for callers that hand it a config and
a device; it returns the generated ids.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.serve import make_decode_step


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 64,
          new_tokens: int = 32, device=None) -> np.ndarray:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, decode
    ``new_tokens`` greedily, print the JAX entry point's two lines, and
    return the generated ids [batch, new_tokens]. Weights from a generator
    seeded with 0 on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.int32, device=dev)
    max_len = prompt_len + new_tokens + cfg.frontend_tokens
    decode = make_decode_step(model)

    t0 = time.time()
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  max_len=max_len)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    generated = [next_tok.cpu().numpy()]
    prefill_s = time.time() - t0

    t1 = time.time()
    for _ in range(new_tokens - 1):
        next_tok, cache = decode(params, next_tok, cache)
        generated.append(next_tok.cpu().numpy())
    decode_s = time.time() - t1

    total_new = batch * new_tokens
    print(f"[serve] {cfg.name}: prefill {batch}x{prompt_len} in "
          f"{prefill_s:.2f}s; decoded {total_new} tokens in {decode_s:.2f}s "
          f"({total_new / max(decode_s, 1e-9):.1f} tok/s)")
    ids = np.concatenate(generated, axis=1)
    print(f"[serve] sample continuation ids: {ids[0][:16].tolist()}")
    return ids


def main(argv: Optional[list] = None, device=None) -> np.ndarray:
    """The command line; ``device`` (``None``: the card) is for callers
    that run it elsewhere, as the tests do on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 new_tokens=args.new_tokens, device=device)


if __name__ == "__main__":
    main()
