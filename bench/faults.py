"""Faults planted in the program, for the checks that ``correct`` must
catch (``bench/calibrate.py`` on the card, ``bench/tests`` on the CPU).
Each is a context manager that breaks the timed path underneath the
harness and mends it on exit:

* ``unchanged``: the optimizer step returns the state it was given;
* ``half_batch``: the loss sees only the first half of the batch's rows,
  its mean taken over them;
* ``token_altered``: every served token is the next id after the one the
  model picked (wrapping inside the vocabulary).
"""
from __future__ import annotations

import importlib
from contextlib import contextmanager

import torch


@contextmanager
def _patched(obj, attr, fn):
    real = getattr(obj, attr)
    setattr(obj, attr, fn(real))
    try:
        yield
    finally:
        setattr(obj, attr, real)


def unchanged():
    ts = importlib.import_module("repro_torch.train.train_step")

    def broken(real):
        def adamw_update(cfg, params, grads, opt_state, **kw):
            return params, opt_state, {}
        return adamw_update
    return _patched(ts, "adamw_update", broken)


def half_batch():
    from repro_torch.models.transformer import Model

    def broken(real):
        def loss(self, params, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return real(self, params, {k: v[:n] for k, v in batch.items()})
        return loss
    return _patched(Model, "loss", broken)


def token_altered(vocab: int):
    ss = importlib.import_module("repro_torch.serve.serve_step")

    def broken(real):
        def vocab_argmax(logits):
            tok = real(logits) + 1
            return torch.where(tok < vocab, tok, torch.zeros_like(tok))
        return vocab_argmax
    return _patched(ss, "vocab_argmax", broken)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "token_altered": token_altered}
