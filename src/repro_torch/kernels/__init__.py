from repro_torch.kernels.ops import (
    segment_aggregate,
    segment_aggregate_batched,
    segment_aggregate_block_table,
    segment_aggregate_block_table_splitk,
)

__all__ = [
    "segment_aggregate", "segment_aggregate_batched",
    "segment_aggregate_block_table", "segment_aggregate_block_table_splitk",
]
