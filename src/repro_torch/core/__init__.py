from repro_torch.core.batch_exec import BatchExecutor, BatchWorkItem
from repro_torch.core.block_pool import DeviceBlockPool
from repro_torch.core.buckets import Block, MemoryBudget, Tier, WindowState
from repro_torch.core.cleanup import LatenessHistogram, PredictiveCleanup
from repro_torch.core.engine import StreamEngine
from repro_torch.core.events import EventBatch
from repro_torch.core.operators import make_operator
from repro_torch.core.policies import (
    EngineOOM, GlobalMemoryPolicy, InMemoryPolicy, LocalRhoMinPolicy,
    StandardPolicy,
)
from repro_torch.core.pipeline import (
    EnginePipeline, MultiTenantEngine, PipelineError, ResultFuture,
    TenantSpec,
)
from repro_torch.core.proactive import PrestageScheduler, StagingCostModel
from repro_torch.core.staging import (
    IOScheduler, StagingError, TaskHandle, TransferExecutor,
)
from repro_torch.core.staleness import (
    deltaev_times, deltat_times, executions_for_bound,
    max_staleness_of, minimize_max_staleness,
)
from repro_torch.core.time import PeriodicWatermarkGenerator, WatermarkTracker
from repro_torch.core.triggers import (
    AionStalenessTrigger, DeltaEvTrigger, DeltaTTrigger,
)
from repro_torch.core.windows import (
    CountWindows, SessionWindows, SlidingWindows, TumblingWindows, WindowId,
)

__all__ = [
    "BatchExecutor", "BatchWorkItem", "DeviceBlockPool",
    "Block", "MemoryBudget", "Tier", "WindowState",
    "LatenessHistogram", "PredictiveCleanup", "StreamEngine", "EventBatch",
    "make_operator", "EngineOOM", "GlobalMemoryPolicy", "InMemoryPolicy",
    "LocalRhoMinPolicy", "StandardPolicy", "PrestageScheduler",
    "StagingCostModel", "IOScheduler", "StagingError", "TaskHandle",
    "TransferExecutor", "EnginePipeline", "MultiTenantEngine",
    "PipelineError", "ResultFuture", "TenantSpec", "deltaev_times", "deltat_times",
    "executions_for_bound", "max_staleness_of", "minimize_max_staleness",
    "PeriodicWatermarkGenerator", "WatermarkTracker", "AionStalenessTrigger",
    "DeltaEvTrigger", "DeltaTTrigger", "CountWindows", "SessionWindows",
    "SlidingWindows", "TumblingWindows", "WindowId",
]
