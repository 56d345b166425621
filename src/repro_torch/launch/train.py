"""Training entry point: config-driven, fault-tolerant, restartable; the JAX
package's ``launch/train.py`` with the same flags and loop, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \
        --steps 50 --ckpt-dir build/ckpt

``--smoke`` is a ``store_true`` flag whose default is True, as in the JAX
entry point, so the command line always trains the reduced same-family
config (``reduced(cfg)``). Checkpoints are async and atomic, in the JAX
package's layout; a killed run resumes from LATEST. ``train`` is the loop
itself, for callers that hand it a config and a device.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data.generators import token_batches
from repro_torch.data.pipeline import PrefetchPipeline
from repro_torch.distributed.fault import RestartManager
from repro_torch.models import build_model
from repro_torch.train import OptConfig, make_train_step
from repro_torch.train.checkpoint import (
    AsyncCheckpointer, latest_checkpoint, read_manifest, restore_checkpoint,
)
from repro_torch.train.train_step import init_train_state

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 4,
          seq: int = 128, lr: float = 3e-4, ckpt_dir: Path = DEFAULT_CKPT,
          save_every: int = 25, log_every: int = 10, device=None) -> dict:
    """Train ``cfg`` for ``steps`` steps on ``token_batches`` (seed 0),
    resuming from the newest checkpoint in ``ckpt_dir`` when there is one.
    Returns the final state, the loss of each step run, the step resumed
    from (None for a fresh start), the last step saved and the
    ``RestartManager``'s restart count."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                        total_steps=steps)
    step_fn = make_train_step(model, opt_cfg)
    data = PrefetchPipeline(token_batches(cfg.vocab_size, batch, seq),
                            depth=2, device=dev)
    ckpt = AsyncCheckpointer(ckpt_dir, keep=3)
    rec = {"losses": [], "resumed_from": None}

    def init_state():
        return init_train_state(model, torch.Generator(dev).manual_seed(0))

    def restore():
        latest = latest_checkpoint(ckpt_dir)
        if latest is None:
            return None
        manifest = read_manifest(latest)
        state = restore_checkpoint(latest, init_state())
        print(f"[train] restored step {manifest['step']} from {latest}")
        rec["resumed_from"] = manifest["step"]
        return state, manifest["step"]

    t0 = time.time()

    def one_step(state, step):
        state, metrics = step_fn(state, next(data))
        loss = float(metrics["loss"])
        rec["losses"].append(loss)
        if (step + 1) % log_every == 0 or step == 0:
            print(f"step {step + 1:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")
        return state

    rm = RestartManager(save_every=save_every)
    try:
        final = rm.run(init_state=init_state, restore=restore,
                       step_fn=one_step,
                       save=lambda s, step: ckpt.save(s, step),
                       num_steps=steps)
        ckpt.wait()
    finally:
        data.close()
    print(f"[train] done: {steps} steps of {cfg.name} "
          f"({cfg.param_count() / 1e6:.1f}M params) in "
          f"{time.time() - t0:.1f}s; last checkpoint step "
          f"{ckpt.last_saved_step}")
    rec.update(state=final, last_saved_step=ckpt.last_saved_step,
               restarts=rm.restarts)
    return rec


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=Path, default=DEFAULT_CKPT)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
          ckpt_dir=args.ckpt_dir, save_every=args.save_every,
          log_every=args.log_every)


if __name__ == "__main__":
    main()
