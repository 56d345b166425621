"""mfu.prefill: the prefills' model FLOPs (every layer over the prompt,
the unembedding at its last position) over the prefills' time, each from
its batch's start to its first tokens on the host, over the card's bf16
peak."""
from bench.counts import PEAKS


def read(rec: dict):
    if rec["kind"] != "serve" or not rec.get("prefill_s"):
        return None
    return 100.0 * rec["prefill_flops"] / rec["prefill_s"] / PEAKS[
        "bf16_flops"]
