"""idle_share.train: The share of the profiled steps' span in which no
kernel, copy or set ran on the device."""


def read(rec: dict):
    if rec["kind"] != "train":
        return None
    return rec.get("idle_share")
