from repro_torch.distributed.fault import (
    BackupExecutor, BackupStats, EngineRecovery, HeartbeatMonitor,
    RestartManager,
)

__all__ = ["BackupExecutor", "BackupStats", "EngineRecovery",
           "HeartbeatMonitor", "RestartManager"]
