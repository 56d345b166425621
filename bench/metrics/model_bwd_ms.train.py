"""model_bwd_ms.train: The device time from the end of ``Model.loss`` to
the start of ``adamw_update`` (the backward) a window step, on CUDA
events."""


def read(rec: dict):
    if rec["kind"] != "train" or "bwd_s" not in rec:
        return None
    return 1e3 * rec["bwd_s"] / rec["steps_timed"]
