from repro_torch.distributed.fault import RestartManager

__all__ = ["RestartManager"]
