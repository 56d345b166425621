"""Store-health circuit breaker driving the graceful-degradation ladder.

The engine feeds one *signal delta* per poll tick — how many new I/O
errors + retries the scheduler recorded since the last tick. The breaker
turns that stream into a discrete **degradation level**:

    0  healthy         — nothing shed
    1  SHED_READAHEAD  — speculative readahead sweeps stop first
    2  SHED_PREFETCH   — pipelined next-round prefetch stops
    3  SYNC_ROUNDS     — fold rounds demote from the pipeline to the
                         synchronous path (no overlap, but no queued
                         rounds to lose either)
    4  BACKPRESSURE    — ingest admission is bounded; overflow batches
                         are deferred and readmitted when the store heals

Escalation: a tick whose delta reaches ``error_threshold`` climbs one
rung. De-escalation: ``cooldown_ticks`` consecutive *clean* ticks
(delta == 0) step one rung back down — the ladder is reversible, and
every transition is recorded so tests can assert the shed ORDER, not
just the final level. Purely tick-driven (no wall clocks): runs are
deterministic under fault injection.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import BoundedSeries, MetricsRegistry, StatsMap

#: ladder rungs, least- to most-disruptive (shed speculative work first,
#: demand-path service last)
LEVEL_HEALTHY = 0
LEVEL_SHED_READAHEAD = 1
LEVEL_SHED_PREFETCH = 2
LEVEL_SYNC_ROUNDS = 3
LEVEL_BACKPRESSURE = 4
MAX_LEVEL = LEVEL_BACKPRESSURE

LEVEL_NAMES = ("healthy", "shed-readahead", "shed-prefetch",
               "sync-rounds", "backpressure")


class StoreHealth:
    """Tick-based circuit breaker over the I/O error/retry stream.

    ``error_threshold <= 0`` disables the breaker entirely (``tick``
    never leaves level 0), which is how ``AionConfig.
    breaker_error_threshold = 0`` turns the ladder off.
    """

    def __init__(self, error_threshold: int = 8,
                 cooldown_ticks: int = 2,
                 registry: Optional[MetricsRegistry] = None,
                 max_transitions: int = 4096,
                 tenant: str = "default"):
        self.error_threshold = int(error_threshold)
        self.cooldown_ticks = max(int(cooldown_ticks), 1)
        self.level = LEVEL_HEALTHY
        self._clean_ticks = 0
        #: every (from_level, to_level) move, in order — the shed-order
        #: evidence ("readahead went first") chaos tests assert on.
        #: Bounded: a long-running engine under flapping faults would
        #: otherwise grow this without limit (the ladder is the one
        #: legacy list EngineMetrics.bounded() never capped).
        self.transitions = BoundedSeries(max_transitions)
        registry = registry if registry is not None else MetricsRegistry()
        self.stats = StatsMap(registry, "aion_health",
                              labels={"tenant": tenant})
        self.stats.register_many(["ticks", "escalations", "recoveries"])
        self._level_gauge = registry.gauge(
            "aion_health_level", "degradation ladder rung (0=healthy)",
            labelnames=("tenant",)).labels(tenant)

    # ------------------------------------------------------------ breaker
    def tick(self, signal_delta: int) -> int:
        """Advance one poll tick with ``signal_delta`` new error/retry
        events; returns the (possibly new) degradation level."""
        self.stats.inc("ticks")
        if self.error_threshold <= 0:
            return self.level
        if signal_delta >= self.error_threshold:
            self._clean_ticks = 0
            if self.level < MAX_LEVEL:
                self._move(self.level + 1)
                self.stats.inc("escalations")
        elif signal_delta == 0:
            self._clean_ticks += 1
            if self._clean_ticks >= self.cooldown_ticks \
                    and self.level > LEVEL_HEALTHY:
                self._clean_ticks = 0
                self._move(self.level - 1)
                self.stats.inc("recoveries")
        else:
            # sub-threshold noise: neither escalate nor count as clean
            self._clean_ticks = 0
        return self.level

    def _move(self, new_level: int) -> None:
        self.transitions.append((self.level, new_level))
        self.level = new_level
        self._level_gauge.set(new_level)

    # ------------------------------------------------------------ queries
    @property
    def name(self) -> str:
        return LEVEL_NAMES[self.level]

    def sheds_readahead(self) -> bool:
        return self.level >= LEVEL_SHED_READAHEAD

    def sheds_prefetch(self) -> bool:
        return self.level >= LEVEL_SHED_PREFETCH

    def demotes_rounds(self) -> bool:
        return self.level >= LEVEL_SYNC_ROUNDS

    def backpressures(self) -> bool:
        return self.level >= LEVEL_BACKPRESSURE
