"""model_fwd_ms.train: The device time of ``Model.loss`` (the forward and
the loss) a window step, on CUDA events."""


def read(rec: dict):
    if rec["kind"] != "train" or "fwd_s" not in rec:
        return None
    return 1e3 * rec["fwd_s"] / rec["steps_timed"]
