from repro_torch.kernels.ops import (
    decode_attention_paged,
    flash_attention,
    flash_attention_vjp,
    segment_aggregate,
    segment_aggregate_batched,
    segment_aggregate_block_table,
    segment_aggregate_block_table_splitk,
    ssd_chunk_scan,
)

__all__ = [
    "decode_attention_paged", "flash_attention", "flash_attention_vjp",
    "segment_aggregate", "segment_aggregate_batched",
    "segment_aggregate_block_table", "segment_aggregate_block_table_splitk",
    "ssd_chunk_scan",
]
