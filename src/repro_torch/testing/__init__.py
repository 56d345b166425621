"""Deterministic fault injection for the storage / I-O / pipeline stack,
the JAX package's ``repro.testing``: every failure mode the self-healing
path claims to handle is drivable from tests, the chaos soaks and the
chip smoke run. Part of the package, not test code: framework-free, it
makes the same decisions as the JAX injector on the same seed."""
from repro_torch.testing.faults import (
    FAULT_OPS, FaultInjector, FaultyBlockStore,
)

__all__ = ["FAULT_OPS", "FaultInjector", "FaultyBlockStore"]
