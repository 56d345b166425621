"""The paper's own evaluation workloads (Table 1) as engine configs.

Four scenarios: two micro-benchmarks (*average*, *bigrams*) and two
applications (*stock market*, *LRB*). Parameters follow Table 1 verbatim;
payload bytes become the event value width so memory pressure is comparable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class WorkloadConfig:
    name: str
    max_ingestion_rate: int      # events/s (Table 1)
    window_duration: float       # seconds (Table 1)
    payload_bytes: int           # Table 1
    # which windowed operator the engine runs
    operator: str                # 'average' | 'bigrams' | 'stock' | 'lrb'
    # value width in float32 lanes derived from payload size
    value_width: int = 0
    blocking: bool = False       # §3.3: blocking ops need full window resident
    num_keys: int = 64           # key cardinality (stocks / road segments)

    def resolved_value_width(self) -> int:
        if self.value_width:
            return self.value_width
        return max(self.payload_bytes // 4, 1)


AVERAGE = WorkloadConfig(
    name="average", max_ingestion_rate=10_000, window_duration=20.0,
    payload_bytes=2304, operator="average", num_keys=1,
)
BIGRAMS = WorkloadConfig(
    name="bigrams", max_ingestion_rate=5_000, window_duration=30.0,
    payload_bytes=3584, operator="bigrams", num_keys=1,
)
STOCK_MARKET = WorkloadConfig(
    name="stock_market", max_ingestion_rate=10_000, window_duration=30.0,
    payload_bytes=1664, operator="stock", num_keys=128,
)
LRB = WorkloadConfig(
    name="lrb", max_ingestion_rate=10_000, window_duration=60.0,
    payload_bytes=1536, operator="lrb", num_keys=256,
)

WORKLOADS = {w.name: w for w in (AVERAGE, BIGRAMS, STOCK_MARKET, LRB)}


def get_workload(name: str) -> WorkloadConfig:
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(WORKLOADS)}")
    return WORKLOADS[name]


# --------------------------------------------------------------- tenancy
@dataclass(frozen=True)
class TenantProfile:
    """Declarative description of one tenant stream for the multiplexed
    engine (``core.pipeline.MultiTenantEngine.from_profiles``).

    The ten profiles below map the repo's ten model-shaped serving
    configs (``configs/<model>.py``) onto the paper's workloads: each
    profile is "the event-time telemetry stream of one served model".
    ``weight`` is the tenant's I/O fairness weight — the transfer
    executor serves ``weight`` consecutive tasks per tenant within a
    priority class before its round-robin cursor advances — and the
    budget fractions slice the shared device/host totals. Bigger models
    get larger weights and budget slices (costlier per-event serving,
    more telemetry volume); the fractions sum to ~1.0 so the shared
    budget is fully partitioned.
    """
    name: str
    workload: WorkloadConfig
    weight: int = 1
    device_budget_frac: float = 0.10
    host_budget_frac: float = 0.10


TENANT_PROFILES: Tuple[TenantProfile, ...] = (
    TenantProfile("mamba2_780m", AVERAGE, weight=1,
                  device_budget_frac=0.04, host_budget_frac=0.04),
    TenantProfile("hymba_1_5b", AVERAGE, weight=1,
                  device_budget_frac=0.05, host_budget_frac=0.05),
    TenantProfile("starcoder2_7b", BIGRAMS, weight=1,
                  device_budget_frac=0.07, host_budget_frac=0.07),
    TenantProfile("seamless_m4t_medium", BIGRAMS, weight=1,
                  device_budget_frac=0.06, host_budget_frac=0.06),
    TenantProfile("qwen3_moe_30b", STOCK_MARKET, weight=2,
                  device_budget_frac=0.09, host_budget_frac=0.09),
    TenantProfile("granite_34b", LRB, weight=2,
                  device_budget_frac=0.10, host_budget_frac=0.10),
    TenantProfile("command_r_35b", STOCK_MARKET, weight=2,
                  device_budget_frac=0.10, host_budget_frac=0.10),
    TenantProfile("phi35_moe_42b", LRB, weight=3,
                  device_budget_frac=0.12, host_budget_frac=0.12),
    TenantProfile("internvl2_76b", LRB, weight=3,
                  device_budget_frac=0.17, host_budget_frac=0.17),
    TenantProfile("mistral_large_123b", STOCK_MARKET, weight=4,
                  device_budget_frac=0.20, host_budget_frac=0.20),
)


def get_tenant_profile(name: str) -> TenantProfile:
    for p in TENANT_PROFILES:
        if p.name == name:
            return p
    raise KeyError(f"unknown tenant profile {name!r}; known: "
                   f"{[p.name for p in TENANT_PROFILES]}")
