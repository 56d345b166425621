"""k5_roofline.serve: K5's least time for the window's prefills over the
measured time of its entry point in them."""
from bench.metrics.share import roofline


def read(rec: dict):
    if rec["kind"] != "serve":
        return None
    return roofline(rec, "k5")
