"""Structured tracing with explicit parent handoff across threads, and
nesting on one thread.

Spans carry ``(trace_id, span_id, parent_id)``. Across threads a parent
span object is passed *explicitly* to :meth:`Tracer.child`, so a fold
round executed on the pipeline worker can parent to the watermark-advance
span created on the caller thread, and an I/O task span can parent to
whichever engine span submitted it. On one thread :meth:`Tracer.span`
nests: a span opened inside another's ``with`` block takes it as its
parent. A span lent with :meth:`Tracer.lend` is the parent of the spans
that a thread with no open span of its own opens meanwhile (autograd's
device thread, running a backward on the caller's behalf).

Sampling happens once, at the root: :meth:`Tracer.root` flips a seeded
coin at ``sample_rate``; children inherit the decision from their parent.
Unsampled (and all, when ``sample_rate <= 0``) spans are the module
singleton :data:`NULL_SPAN`, whose every method is a no-op — the hot-path
cost of disabled tracing is one attribute read and one predictable branch.

A span is stamped in integer Unix nanoseconds at its start
(``time.time_ns``, the base of ``torch.profiler``'s trace) and timed by
``time.perf_counter_ns``; it exports ``t0`` and ``dur`` in seconds. On
a tracer made with ``annotate``, a sampled span entered as a context
(``with``) also opens ``record_function("repro:<name>")`` while a
``torch.profiler`` records
(:func:`~repro_torch.obs.export.profiler_annotation`), so the profiler's
trace holds it; and with ``device_clock`` set it records a CUDA event on
the current stream at entry and at exit, read as ``device_s`` at export
(after the caller's synchronise: no span synchronises). Counters
(:meth:`Tracer.count`) are attributes of the innermost open span, summed
into the enclosing span when it ends.

Finished spans land in a bounded ring buffer (oldest dropped) and export
as JSON-lines via :meth:`Tracer.export_jsonl`.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .export import profiler_annotation

__all__ = ["Span", "NullSpan", "NULL_SPAN", "Tracer"]


class NullSpan:
    """No-op span; stands in for every unsampled span."""

    __slots__ = ()
    sampled = False
    trace_id = 0
    span_id = 0

    def event(self, name: str, **attrs) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def end(self, **attrs) -> None:
        pass

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NULL_SPAN = NullSpan()


def _profiling() -> bool:
    import torch.autograd.profiler as prof
    return prof._is_profiler_enabled


class Span:
    """A sampled span. Mutate only from the thread currently running it;
    hand it to another thread as a *parent* (read-only) freely."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "_c0", "_dur", "attrs", "counts", "events", "thread",
                 "_ended", "_parent", "_ann", "device")
    sampled = True

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, object],
                 parent: Optional["Span"] = None) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.time_ns()
        self._c0 = time.perf_counter_ns()
        self._dur = 0
        self.attrs = attrs
        self.counts: Dict[str, int] = {}
        self.events: List[Dict[str, object]] = []
        self.thread = threading.current_thread().name
        self._ended = False
        self._parent = parent
        self._ann = None
        #: the CUDA events of the device clock: "span" at entry and exit,
        #: "bwd" as a backward enters and leaves (a caller's autograd nodes)
        self.device: Optional[Dict[str, list]] = None

    def event(self, name: str, **attrs) -> None:
        rec: Dict[str, object] = {
            "name": name,
            "t": round((time.perf_counter_ns() - self._c0) / 1e9, 6)}
        if attrs:
            rec.update(attrs)
        self.events.append(rec)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        if self._ended:
            return
        self._ended = True
        self._dur = time.perf_counter_ns() - self._c0
        # re-stamp with the finishing thread: task spans are created on
        # the submitter thread but run (and end) on the executor, and the
        # executing thread is the one cross-thread reconstruction needs
        self.thread = threading.current_thread().name
        if attrs:
            self.attrs.update(attrs)
        parent = self._parent
        if self.counts and parent is not None:
            for k, n in self.counts.items():
                parent.counts[k] = parent.counts.get(k, 0) + n
        self._tracer._finish(self)

    def __enter__(self) -> "Span":
        tracer = self._tracer
        tracer._stack().append(self)
        if tracer.annotate and _profiling():
            self._ann = profiler_annotation("repro:" + self.name)
            self._ann.__enter__()
        if tracer.device_clock:
            self.device = {"span": [tracer._device_stamp()]}
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tracer = self._tracer
        if self.device is not None:
            self.device["span"].append(tracer._device_stamp())
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        tracer._stack().pop()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()

    def __bool__(self) -> bool:
        return True


class Tracer:
    """Span factory + bounded ring of finished span records.

    ``sample_rate`` in [0, 1] gates *root* spans only; the decision then
    flows down the parent chain. ``seed`` makes sampling reproducible.
    With ``annotate``, spans entered as contexts are ``repro:<name>`` in a
    recording profiler's trace (the LM tracer's; the engine annotates its
    fold launches under its own ``profiler_annotations`` knob). With
    ``device_clock`` set (``obs.lm.tracing`` sets it for a CUDA device),
    spans entered as contexts record CUDA events.
    """

    def __init__(self, sample_rate: float = 0.0, capacity: int = 4096,
                 seed: int = 0, annotate: bool = False) -> None:
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self.annotate = annotate
        self.device_clock = False
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        self._rng = random.Random(seed)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._lent: Optional[Span] = None
        self.spans_started = 0
        self.spans_finished = 0
        self.spans_dropped = 0

    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    # -- span creation ----------------------------------------------------
    def root(self, name: str, **attrs):
        """Start a new trace; samples at ``sample_rate``."""
        if self.sample_rate <= 0.0:
            return NULL_SPAN
        with self._lock:
            if self.sample_rate < 1.0 and self._rng.random() >= self.sample_rate:
                return NULL_SPAN
            trace_id = span_id = next(self._ids)
            self.spans_started += 1
        return Span(self, name, trace_id, span_id, None, dict(attrs))

    def child(self, parent, name: str, **attrs):
        """Continue ``parent``'s trace; NULL when the parent is unsampled."""
        if parent is None or not parent.sampled:
            return NULL_SPAN
        with self._lock:
            span_id = next(self._ids)
            self.spans_started += 1
        return Span(self, name, parent.trace_id, span_id, parent.span_id,
                    dict(attrs), parent)

    def span(self, name: str, **attrs):
        """A span nested in the innermost span open on this thread (else
        in the lent one, else a new root that samples at ``sample_rate``:
        a root that loses the coin is not open, so a span opened inside it
        is a root of its own); enter it with ``with``. Inside
        :meth:`recomputing` it carries ``recompute=True``."""
        if self.sample_rate <= 0.0:
            return NULL_SPAN
        stack = self._stack()
        parent = stack[-1] if stack else self._lent
        if getattr(self._local, "recompute", 0):
            attrs["recompute"] = True
        if parent is not None:
            return self.child(parent, name, **attrs)
        return self.root(name, **attrs)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def lend(self, span):
        """A context: while entered, ``span`` (if sampled) is the parent
        of the spans that a thread with no open span opens (a backward's
        device thread)."""
        return self._lending(span) if span.sampled else NULL_SPAN

    @contextlib.contextmanager
    def _lending(self, span: Span):
        saved, self._lent = self._lent, span
        try:
            yield
        finally:
            self._lent = saved

    @contextlib.contextmanager
    def recomputing(self):
        """While entered on this thread, its spans carry ``recompute=True``
        (a checkpoint's recompute, run in the backward)."""
        local = self._local
        local.recompute = getattr(local, "recompute", 0) + 1
        try:
            yield
        finally:
            local.recompute -= 1

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost span open on this
        thread (none while disabled or outside a sampled span)."""
        if self.sample_rate <= 0.0:
            return
        stack = self._stack()
        if stack and stack[-1].sampled:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    def _device_stamp(self):
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    # -- ring -------------------------------------------------------------
    def _finish(self, span: Span) -> None:
        rec = {
            "name": span.name,
            "trace": span.trace_id,
            "span": span.span_id,
            "parent": span.parent_id,
            "t0": round(span.t0 / 1e9, 6),
            "dur": round(span._dur / 1e9, 6),
            "thread": span.thread,
            "attrs": {**span.attrs, **span.counts} if span.counts
            else span.attrs,
            "events": span.events,
        }
        if span.device is not None:
            rec["_device"] = span.device
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.spans_dropped += 1
            self._ring.append(rec)
            self.spans_finished += 1

    def records(self) -> List[Dict[str, object]]:
        """The finished spans, oldest first. A span's device events are
        read here, once: ``device_s`` (entry to exit) and
        ``device_bwd_s`` (a backward's, where one was recorded)."""
        with self._lock:
            pending = [r for r in self._ring if "_device" in r]
            if pending:
                import torch
                torch.cuda.synchronize()
                for rec in pending:
                    for key, name in (("span", "device_s"),
                                      ("bwd", "device_bwd_s")):
                        ev = rec["_device"].get(key)
                        if ev and len(ev) == 2:
                            rec[name] = ev[0].elapsed_time(ev[1]) / 1e3
                    del rec["_device"]
            return list(self._ring)

    def export_jsonl(self) -> str:
        return "\n".join(json.dumps(rec, default=str)
                         for rec in self.records())

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "sample_rate": self.sample_rate,
                "spans_started": self.spans_started,
                "spans_finished": self.spans_finished,
                "spans_dropped": self.spans_dropped,
                "ring_len": len(self._ring),
                "ring_capacity": self.capacity,
            }
