"""End-to-end training driver on the PyTorch/CUDA port: a small LM trained
for a few hundred steps with the production substrate (prefetch
pipeline, async checkpoints) on the card, its attention through the
flash kernels (K5 forward, K6 backward). The flags, their defaults and
the lines printed are ``examples/train_lm.py``'s; the checkpoints go to
``build/torch_train_lm`` by default.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200

By default trains a ~10M-param starcoder2-family model (a 100M model is
a flag away: --dmodel 768 --layers 12).
"""
import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.generators import token_batches
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.models import build_model
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.checkpoint import AsyncCheckpointer
from repro_torch.train.train_step import init_train_state

DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / \
    "torch_train_lm"


def main(argv=None, device=None):
    """The command line; ``device`` (``None``: the card) is for callers
    that run it elsewhere, as the tests do on the CPU. Returns the loss
    of every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dmodel", type=int, default=384)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--ckpt-dir", type=Path, default=DEFAULT_CKPT)
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        reduced(ARCHS["starcoder2-7b"]),
        d_model=args.dmodel, num_layers=args.layers,
        d_ff=args.dmodel * 4, num_heads=max(args.dmodel // 64, 1),
        num_kv_heads=max(args.dmodel // 256, 1), vocab_size=8192,
    )
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    print(f"training {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens")

    state = init_train_state(model, torch.Generator(dev).manual_seed(0))
    step_fn = make_train_step(model, OptConfig(
        lr=1e-3, warmup_steps=20, total_steps=args.steps))
    data = PrefetchPipeline(
        token_batches(cfg.vocab_size, args.batch, args.seq), depth=2,
        device=dev)
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=2)

    t0 = time.time()
    losses = []
    try:
        for step in range(args.steps):
            state, metrics = step_fn(state, next(data))
            losses.append(float(metrics["loss"]))
            if (step + 1) % 20 == 0:
                rate = args.batch * args.seq * (step + 1) / (time.time() - t0)
                print(f"step {step + 1:4d} loss={losses[-1]:.4f} "
                      f"({rate:,.0f} tok/s)")
            if (step + 1) % 100 == 0:
                ckpt.save(state, step + 1)
        ckpt.wait()
    finally:
        data.close()
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(random = {np.log(cfg.vocab_size):.3f}) in "
          f"{time.time() - t0:.0f}s; checkpoints in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
