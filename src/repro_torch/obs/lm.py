"""The LM path's spans and counters: training (``train.*``), serving
(``serve.*``, ``decode.pos_read``), the model's sublayers (``model.*``)
and the attention kernels' entry points (``kernel.k5``, ``kernel.k6``),
all on one tracer, :data:`TRACER`, nested by thread.

Off by default: every ``span`` is then :data:`~.trace.NULL_SPAN` and
every counter call returns at its first branch, so the path runs as
without them. :func:`tracing` turns it on (every span sampled, and the
CUDA events of the device clock where the work runs on a card); each
span then records its host time and, under the device clock, its device
time, and the same
``torch.profiler`` trace that times the kernels holds it as
``repro:<name>``. :func:`span_table` sums the records by name.

Counters, as attributes of the innermost open span (summed into the
spans around it): ``host_syncs``, each read-back of a device value that
the program makes (:func:`host_read`); ``cast_bytes``, the stored bytes
of each parameter converted to another type for a call
(``models.layers.param_as``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Optional

import torch

from .trace import Tracer

__all__ = ["TRACER", "span", "count", "host_read", "tracing",
           "recompute_marked", "backward_stamp", "span_table"]

#: the LM path's tracer (a serving window's spans fit its ring)
TRACER = Tracer(capacity=1 << 16, annotate=True)
#: a span nested in the innermost open one (``Tracer.span``)
span = TRACER.span
#: add to a counter of the innermost open span (``Tracer.count``)
count = TRACER.count


def host_read(t: torch.Tensor) -> int:
    """``int(t)``: a device value read back to the host, counted as
    ``host_syncs``."""
    count("host_syncs")
    return int(t)


@contextlib.contextmanager
def tracing(device):
    """:data:`TRACER` on while entered, every span sampled, its ring
    cleared first, with the device clock where ``device`` (the one the
    traced work runs on) is a CUDA device. Yields the tracer; its
    settings are restored on exit."""
    saved = TRACER.sample_rate, TRACER.device_clock
    TRACER.clear()
    TRACER.sample_rate = 1.0
    TRACER.device_clock = torch.device(device).type == "cuda"
    try:
        yield TRACER
    finally:
        TRACER.sample_rate, TRACER.device_clock = saved


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def recompute_marked(context_fn):
    """A ``torch.utils.checkpoint`` ``context_fn`` whose recompute context
    also marks the spans opened in it ``recompute=True``."""
    def contexts():
        fwd, rec = context_fn()
        return fwd, _both(rec, TRACER.recomputing())
    return contexts


class _BackwardStamp(torch.autograd.Function):
    """The identity; its backward records a CUDA event into ``stamps``."""

    @staticmethod
    def forward(ctx, x, stamps):
        ctx.stamps = stamps
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.stamps.append(TRACER._device_stamp())
        return grad, None


def backward_stamp(sp, x: torch.Tensor) -> torch.Tensor:
    """``x`` through an identity node that records a CUDA event into
    ``sp``'s backward stamps as the gradient passes: put on a block's
    output, then on its input, the two time the block's backward
    (``device_bwd_s``). ``x`` itself where ``sp`` keeps no device clock or
    nothing differentiates ``x``."""
    if sp.sampled and sp.device is not None and x.requires_grad:
        return _BackwardStamp.apply(x, sp.device.setdefault("bwd", []))
    return x


def span_table(records: Optional[Iterable[dict]] = None
               ) -> Dict[str, Dict[str, float]]:
    """Per span name, a recompute's apart as ``"<name> (recompute)"``:
    ``calls``, ``host_s``, ``device_s`` and ``device_bwd_s`` (where
    recorded), ``host_syncs`` and ``cast_bytes``, summed over ``records``
    (the tracer's, by default)."""
    out: Dict[str, Dict[str, float]] = {}
    for r in TRACER.records() if records is None else records:
        attrs = r["attrs"]
        key = r["name"] + (" (recompute)" if attrs.get("recompute") else "")
        row = out.setdefault(key, {"calls": 0, "host_s": 0.0,
                                   "host_syncs": 0, "cast_bytes": 0})
        row["calls"] += 1
        row["host_s"] += r["dur"]
        for name in ("host_syncs", "cast_bytes"):
            row[name] += attrs.get(name, 0)
        for name in ("device_s", "device_bwd_s"):
            if name in r:
                row[name] = row.get(name, 0.0) + r[name]
    return out
