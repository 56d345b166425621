"""k5_roofline.train: K5's least time for the window steps' attention
forwards (one a layer and step) over the measured time of every call of
its entry point (the recomputes of remat included)."""
from bench.metrics.share import roofline


def read(rec: dict):
    if rec["kind"] != "train":
        return None
    return roofline(rec, "k5")
