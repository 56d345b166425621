"""Engine and workload configs: ``AionConfig`` and the paper's Table-1
workloads. The LM architecture registry of the JAX package is not ported
yet."""
from repro_torch.configs.base import AionConfig, to_json
from repro_torch.configs.workloads import (
    WORKLOADS, WorkloadConfig, get_workload,
)

__all__ = ["AionConfig", "to_json", "WORKLOADS", "WorkloadConfig",
           "get_workload"]
