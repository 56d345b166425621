"""k6_roofline.train: K6's least time for the window steps' attention
backwards over the measured time of its entry point."""
from bench.metrics.share import roofline


def read(rec: dict):
    if rec["kind"] != "train":
        return None
    return roofline(rec, "k6")
