"""The share of a roofline that a timed op reaches, for the readers."""


def roofline(rec: dict, op: str):
    """100 x the op's least time over its measured time; None where the
    run timed no call of it."""
    entry = rec.get(op)
    if not entry or not entry["calls"] or entry["time_s"] <= 0:
        return None
    return 100.0 * entry["need_s"] / entry["time_s"]
