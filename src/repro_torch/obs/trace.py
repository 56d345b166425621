"""Structured tracing with explicit parent handoff across threads.

Spans carry ``(trace_id, span_id, parent_id)``; a parent span object is
passed *explicitly* to :meth:`Tracer.child` — never via thread-locals — so
a fold round executed on the pipeline worker can parent to the
watermark-advance span created on the caller thread, and an I/O task span
can parent to whichever engine span submitted it.

Sampling happens once, at the root: :meth:`Tracer.root` flips a seeded
coin at ``sample_rate``; children inherit the decision from their parent.
Unsampled (and all, when ``sample_rate <= 0``) spans are the module
singleton :data:`NULL_SPAN`, whose every method is a no-op — the hot-path
cost of disabled tracing is one attribute read and one predictable branch.

Finished spans land in a bounded ring buffer (oldest dropped) and export
as JSON-lines via :meth:`Tracer.export_jsonl`.
"""
from __future__ import annotations

import itertools
import json
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

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


class Span:
    """A sampled span. Mutate only from the thread currently running it;
    hand it to another thread as a *parent* (read-only) freely."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "attrs", "events", "thread", "_ended")
    sampled = True

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, object]) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.time()
        self.attrs = attrs
        self.events: List[Dict[str, object]] = []
        self.thread = threading.current_thread().name
        self._ended = False

    def event(self, name: str, **attrs) -> None:
        rec: Dict[str, object] = {"name": name,
                                  "t": round(time.time() - self.t0, 6)}
        if attrs:
            rec.update(attrs)
        self.events.append(rec)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self, **attrs) -> None:
        if self._ended:
            return
        self._ended = True
        # re-stamp with the finishing thread: task spans are created on
        # the submitter thread but run (and end) on the executor, and the
        # executing thread is the one cross-thread reconstruction needs
        self.thread = threading.current_thread().name
        if attrs:
            self.attrs.update(attrs)
        self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()

    def __bool__(self) -> bool:
        return True


class Tracer:
    """Span factory + bounded ring of finished span records.

    ``sample_rate`` in [0, 1] gates *root* spans only; the decision then
    flows down the parent chain. ``seed`` makes sampling reproducible.
    """

    def __init__(self, sample_rate: float = 0.0, capacity: int = 4096,
                 seed: int = 0) -> None:
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        self._rng = random.Random(seed)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
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
                    dict(attrs))

    # -- ring -------------------------------------------------------------
    def _finish(self, span: Span) -> None:
        rec = {
            "name": span.name,
            "trace": span.trace_id,
            "span": span.span_id,
            "parent": span.parent_id,
            "t0": round(span.t0, 6),
            "dur": round(time.time() - span.t0, 6),
            "thread": span.thread,
            "attrs": span.attrs,
            "events": span.events,
        }
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.spans_dropped += 1
            self._ring.append(rec)
            self.spans_finished += 1

    def records(self) -> List[Dict[str, object]]:
        with self._lock:
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
