from repro_torch.distributed.fault import (
    BackupExecutor, BackupStats, RestartManager,
)

__all__ = ["BackupExecutor", "BackupStats", "RestartManager"]
