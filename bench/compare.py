"""The comparisons that decide ``correct``: readings of the program
against the plain reference, each held to its limit.

Training compares norms leaf by leaf, each gap measured against the
reference's norm of that leaf or of the median leaf, whichever is
larger, and reports the worst leaf; the change of a leaf whose reference
gradient is under a thousandth of the median leaf's (it moves by
round-off and weight decay alone, as a key's bias under softmax) is left
out. Serving reports the widest gap by which a served token's reference
logit lies below the reference's best at its position.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of the change
QUIET = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               skip: Optional[set] = None) -> tuple:
    """(the largest |prog - ref| / max(ref, median ref) over the leaves,
    the leaf)."""
    names = [n for n in ref if not skip or n not in skip]
    med = statistics.median(ref[n] for n in names)
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def quiet_leaves(grad_ref: Dict[str, float]) -> set:
    med = statistics.median(grad_ref.values())
    return {n for n, g in grad_ref.items() if g < QUIET * med}


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (the first steps'),
    ``grad`` (each leaf's norm of the first clipped gradient) and
    ``change`` (each leaf's norm of its change over the steps)."""
    loss = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
               for a, b in zip(prog["losses"], ref["losses"]))
    grad, grad_leaf = worst_leaf(prog["grad"], ref["grad"])
    quiet = quiet_leaves(ref["grad"])
    change, change_leaf = worst_leaf(prog["change"], ref["change"], quiet)
    return {"loss": loss, "grad": grad, "change": change,
            "where": {"grad": grad_leaf, "change": change_leaf,
                      "quiet": sorted(quiet)}}


def held(readings: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each compared number beside its limit, in the limits' order."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def all_within(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
