"""Host-side prefetch pipeline: produce -> stage -> consume, double
buffered, as the JAX package's ``data/pipeline.py``.

A producer thread takes batches from the source, pins each array and
copies it to the card on a side stream, and records an event after the
copy; ``__next__`` makes the consumer's current stream wait on that event
before the batch is used (a step must never read a half-copied batch) and
marks the tensors as used on that stream, so their memory is not reused
before the step is done with them. Step N's compute thus overlaps step
N+1's copy. On the CPU the arrays become tensors and nothing else
happens. An exception in the source is raised by ``__next__``.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device

_END = object()


class PrefetchPipeline:
    def __init__(self, source: Iterator[Any], *, depth: int = 2,
                 to_device: bool = True,
                 transform: Optional[Callable[[Any], Any]] = None,
                 device=None):
        self.source = source
        self.depth = depth
        self.to_device = to_device
        self.transform = transform
        self.device = resolve_device(device) if to_device else None
        self._stream = torch.cuda.Stream(self.device) \
            if self.device is not None and self.device.type == "cuda" \
            else None
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _stage(self, item):
        """A batch's arrays as tensors on the device, and the event that
        the copies are done (None off the card)."""
        def put(x):
            if not hasattr(x, "shape"):
                return x
            t = torch.as_tensor(np.asarray(x))
            if self._stream is None:
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)

        if self._stream is None:
            return _map(put, item), None
        with torch.cuda.stream(self._stream):
            staged = _map(put, item)
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def _put(self, entry) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                if self.transform is not None:
                    item = self.transform(item)
                entry = self._stage(item) if self.to_device else (item, None)
                if not self._put(entry):
                    return
        except BaseException as e:          # handed to the consumer
            self._put((_END, e))
            return
        self._put((_END, None))

    def __iter__(self):
        return self

    def __next__(self):
        item, done = self._q.get()
        if item is _END:
            self._q.put_nowait((item, done))  # for the next caller
            if done is not None:
                raise done
            raise StopIteration
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            _map(lambda t: t.record_stream(stream)
                 if isinstance(t, torch.Tensor) else t, item)
        return item

    def close(self) -> None:
        self._stop.set()


def _map(fn, item):
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_map(fn, v) for v in item)
    return fn(item)

