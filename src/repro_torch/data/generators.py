"""Synthetic event generators for the paper's workloads (§5).

Event timestamps follow the paper exactly:

    ts = currentTime - windowIndex * windowDuration

with windowIndex drawn from a log-normal distribution (mean 0, std 1), so
the likelihood a past window receives an event decays exponentially. Q4
also evaluates uniform / normal / bursty lateness distributions — all four
are provided by ``lateness_delays``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.workloads import WorkloadConfig
from repro_torch.core.events import EventBatch


def lateness_delays(dist: str, n: int, horizon: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Late-event delay samples in [0, horizon] for the Q4 distributions."""
    if dist == "lnorm":
        d = rng.lognormal(0.0, 1.0, n) * (horizon / 20.0)
    elif dist == "unif":
        d = rng.uniform(0, horizon, n)
    elif dist == "norm":
        d = rng.normal(horizon / 2, horizon / 8, n)
    elif dist == "bursts":
        centers = rng.choice([0.1, 0.35, 0.7, 0.9], n) * horizon
        d = centers + rng.normal(0, horizon / 40, n)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.clip(d, 1e-6, horizon)


@dataclass
class WorkloadGenerator:
    cfg: WorkloadConfig
    seed: int = 0
    lateness_dist: str = "lnorm"

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.width = self.cfg.resolved_value_width()

    def _values(self, n: int) -> np.ndarray:
        op = self.cfg.operator
        if op == "average":
            v = self.rng.integers(0, 1000, (n, self.width)).astype(np.float32)
        elif op == "bigrams":
            # token mini-documents (tweets)
            v = self.rng.integers(0, 255, (n, self.width)).astype(np.float32)
        elif op == "stock":
            base = self.rng.uniform(10, 500, (n, 1)).astype(np.float32)
            noise = self.rng.normal(0, 0.02, (n, self.width)).astype(np.float32)
            v = base * (1 + noise)
        elif op == "lrb":
            v = np.zeros((n, self.width), np.float32)
            v[:, 0] = np.maximum(self.rng.normal(55, 20, n), 0)  # speed
            stopped = self.rng.random(n) < 0.01
            v[stopped, 0] = 0.0
            if self.width > 1:
                v[:, 1] = self.rng.integers(0, 4, n)             # lane
        else:
            v = self.rng.normal(size=(n, self.width)).astype(np.float32)
        return v

    def batch(self, n: int, now: float) -> EventBatch:
        """Generate n events at processing time ``now`` with the paper's
        timestamp model (window_index ~ floor(lognormal))."""
        wd = self.cfg.window_duration
        widx = np.floor(self.rng.lognormal(0.0, 1.0, n)).astype(np.int64)
        ts = now - widx * wd - self.rng.uniform(0, wd, n)
        ts = np.maximum(ts, 0.0)
        keys = self.rng.integers(0, self.cfg.num_keys, n).astype(np.int32)
        return EventBatch(keys, ts, self._values(n))

    def stream(self, *, events_per_batch: int, start: float = 0.0,
               rate: Optional[float] = None) -> Iterator[EventBatch]:
        """Infinite stream; ``rate`` defaults to the workload's max
        ingestion rate. Yields (batch at virtual time now)."""
        rate = rate or self.cfg.max_ingestion_rate
        now = start
        while True:
            yield now, self.batch(events_per_batch, now)
            now += events_per_batch / rate


def make_generator(cfg: WorkloadConfig, seed: int = 0,
                   lateness_dist: str = "lnorm") -> WorkloadGenerator:
    return WorkloadGenerator(cfg, seed=seed, lateness_dist=lateness_dist)


def token_batches(vocab_size: int, batch: int, seq_len: int, seed: int = 0
                  ) -> Iterator[dict]:
    """LM training batches (synthetic next-token data), the JAX package's
    draws: ``default_rng(seed)`` gives both packages the same batches."""
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, vocab_size, (batch, seq_len + 1),
                            dtype=np.int32)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
