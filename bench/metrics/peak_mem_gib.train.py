"""peak_mem_gib.train: ``max_memory_allocated`` over the window after
``reset_peak_memory_stats`` at its start, in GiB."""


def read(rec: dict):
    if rec["kind"] != "train" or "peak_bytes" not in rec:
        return None
    return rec["peak_bytes"] / 2 ** 30
