"""opt_ms.train: The device time of ``adamw_update`` a window step, on CUDA
events."""


def read(rec: dict):
    if rec["kind"] != "train" or "opt_s" not in rec:
        return None
    return 1e3 * rec["opt_s"] / rec["steps_timed"]
