from repro_torch.data.generators import (
    WorkloadGenerator,
    lateness_delays,
    make_generator,
    token_batches,
)
from repro_torch.data.pipeline import PrefetchPipeline

__all__ = ["WorkloadGenerator", "make_generator", "lateness_delays",
           "token_batches", "PrefetchPipeline"]
