from repro_torch.distributed.fault import (
    BackupExecutor, BackupStats, EngineRecovery, HeartbeatMonitor,
    RestartManager,
)
from repro_torch.distributed.sharding import (
    ShardCtx,
    constrain,
    current_ctx,
    logical_to_pspec,
    make_rules,
    set_ctx,
    sharding_profile,
    use_ctx,
)

__all__ = [
    "ShardCtx", "current_ctx", "set_ctx", "use_ctx", "constrain",
    "logical_to_pspec", "make_rules", "sharding_profile",
    "BackupExecutor", "BackupStats", "EngineRecovery", "HeartbeatMonitor",
    "RestartManager",
]
