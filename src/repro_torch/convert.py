"""Carry window state from the JAX package's engine into the port's.

A streaming engine carries window state where a model carries weights.
``engine_state_from_jax(snap)`` takes the dict that the JAX package's
``StreamEngine.checkpoint_state()`` returns (plain lists and numpy
arrays; nothing of JAX in it) and returns the input that
``repro_torch.core.StreamEngine.restore_state`` takes. Inline blocks keep
their event arrays; manifest blocks (``stored: True``) stay references
into the log store the JAX package wrote, whose on-disk format the port
reads unchanged, so the port's engine must be opened on that store.

The conversion validates what would otherwise make the two engines
silently compute different things: fills against the block arrays, block
ids (present, integral, unique), window bounds and the lateness
histogram's shape.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

#: bins of the port's ``LatenessHistogram`` (and of the JAX package's)
HIST_BINS = 256


def _block(b: Dict[str, Any], where: str, seen: set) -> Dict[str, Any]:
    fill = int(b["fill"])
    if fill < 0:
        raise ValueError(f"{where}: negative fill {fill}")
    if "block_id" not in b:
        raise ValueError(f"{where}: block without a block_id")
    bid = int(b["block_id"])
    if bid != b["block_id"] or bid <= 0 or bid in seen:
        raise ValueError(f"{where}: bad or duplicate block_id "
                         f"{b['block_id']!r}")
    seen.add(bid)
    out = {"fill": fill, "block_id": bid, "tier": b.get("tier"),
           "persisted": bool(b.get("persisted", False))}
    stored = bool(b.get("stored", False))
    data = b.get("data") or {}
    if stored and not data:
        out["stored"] = True
        out["data"] = {}
        return out
    if fill and not data:
        raise ValueError(f"{where}: fill {fill} but no event data")
    arrays = {}
    for key, dtype in (("keys", np.int32), ("timestamps", np.float64),
                       ("values", np.float32)):
        if data:
            arr = np.asarray(data[key], dtype)
            if arr.shape[0] < fill:
                raise ValueError(f"{where}: {key} holds {arr.shape[0]} "
                                 f"rows, fill is {fill}")
            arrays[key] = arr
    if data and arrays["values"].ndim != 2:
        raise ValueError(f"{where}: values must be [capacity, width]")
    out["data"] = arrays
    if stored:
        out["stored"] = True
    return out


def engine_state_from_jax(snap: Dict[str, Any]) -> Dict[str, Any]:
    """``repro.core.StreamEngine.checkpoint_state()`` output ->
    ``repro_torch.core.StreamEngine.restore_state`` input."""
    counts = np.asarray(snap["hist_counts"], np.float32)
    if counts.shape != (HIST_BINS,):
        raise ValueError(f"hist_counts must have shape ({HIST_BINS},), "
                         f"got {counts.shape}")
    total = int(snap["hist_total"])
    if total < 0:
        raise ValueError(f"negative hist_total {total}")
    seen: set = set()
    windows = []
    for w in snap["windows"]:
        start, end = float(w["start"]), float(w["end"])
        if not end > start:
            raise ValueError(f"window [{start}, {end}) is empty")
        where = f"window [{start}, {end})"
        blocks = [_block(b, f"{where} block {i}", seen)
                  for i, b in enumerate(w["blocks"])]
        total_events = int(w["total_events"])
        if sum(b["fill"] for b in blocks) != total_events:
            raise ValueError(f"{where}: block fills do not add up to "
                             f"total_events {total_events}")
        windows.append({"start": start, "end": end,
                        "total_events": total_events,
                        "late_events": int(w["late_events"]),
                        "expired": bool(w["expired"]),
                        "blocks": blocks})
    return {"watermark": float(snap["watermark"]), "hist_counts": counts,
            "hist_total": total, "windows": windows}
