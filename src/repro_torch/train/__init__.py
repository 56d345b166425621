from repro_torch.train.compression import (
    CompressorConfig, compress_grads, compression_ratio, init_error_feedback,
)
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.train.train_step import (
    TrainState, init_train_state, make_train_step,
)

__all__ = [
    "adamw_init", "adamw_update", "OptConfig",
    "TrainState", "init_train_state", "make_train_step",
    "CompressorConfig", "compress_grads", "compression_ratio",
    "init_error_feedback",
]
