from repro_torch.data.generators import (
    WorkloadGenerator,
    lateness_delays,
    make_generator,
)

__all__ = ["WorkloadGenerator", "make_generator", "lateness_delays"]
