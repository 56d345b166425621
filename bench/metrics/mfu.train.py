"""mfu.train: The window's model FLOPs (no recompute) per second over the
card's bf16 peak."""
from bench.counts import PEAKS


def read(rec: dict):
    if rec["kind"] != "train" or "model_flops" not in rec:
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / PEAKS["bf16_flops"]
