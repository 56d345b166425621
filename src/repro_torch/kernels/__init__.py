from repro_torch.kernels import (
    decode_attention as _decode_attention,
    flash_attention as _flash_attention,
    flash_attention_bwd as _flash_attention_bwd,
    segment_aggregate as _segment_aggregate,
    ssd_scan as _ssd_scan,
)
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
    "ssd_chunk_scan", "counting_wrappers", "zero_launches",
]


def counting_wrappers() -> dict:
    """The seven kernels' wrappers, keyed K1 to K7. Each adds one to its
    ``launches`` (and to ``launches_by_design``, and the segment folds'
    sharded calls to ``launches_by_shard``) where it launches its
    kernel."""
    return {**dict(zip(("K1", "K2", "K3"),
                       _segment_aggregate.KERNEL_WRAPPERS)),
            "K4": _decode_attention.decode_attention_paged_cuda,
            "K5": _flash_attention.flash_attention_cuda,
            "K6": _flash_attention_bwd.flash_attention_bwd_cuda,
            "K7": _ssd_scan.ssd_scan_cuda}


def zero_launches(fns) -> None:
    """Each wrapper's launch count, and its counts by design and by shard
    where it keeps them, to 0."""
    for fn in fns:
        fn.launches = 0
        for key in getattr(fn, "launches_by_design", {}):
            fn.launches_by_design[key] = 0
        getattr(fn, "launches_by_shard", {}).clear()
