"""Typed metrics registry: Counter / Gauge / Histogram families with labels.

One :class:`MetricsRegistry` instance is shared by every component of an
engine stack (engine, I/O scheduler, transfer executor, store, block pool,
health ladder, pipeline).  Components register *families* by name; a family
with label names fans out into per-label-value *children* (e.g. one
``aion_io_tasks_total`` child per ``(tenant, class)`` pair).

Two adapters preserve the legacy telemetry surfaces on top of the registry:

* :class:`StatsMap` — a ``MutableMapping`` drop-in for the old ``.stats``
  dicts (``stats["errors"] += 1`` and ``stats["last_error"]`` keep working,
  but numeric entries are registry instruments and ``inc()`` is atomic).
* ``EngineMetrics`` (in ``core/engine.py``) — attribute access routed onto
  registry instruments via ``__getattr__`` / ``__setattr__``.

All instrument mutation is guarded by a per-family lock, so increments from
pipeline workers and I/O executor threads cannot lose updates.
"""
from __future__ import annotations

import bisect
import threading
from typing import (Callable, Dict, Iterator, List, Mapping, MutableMapping,
                    Optional, Sequence, Tuple)

__all__ = [
    "BoundedSeries",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StatsMap",
]


class BoundedSeries(list):
    """List that sheds its oldest half once it reaches ``maxlen``.

    ``maxlen <= 0`` means unbounded (plain list behaviour).  Moved here from
    ``core/engine.py`` so every telemetry surface can share it; the engine
    re-exports it for backwards compatibility.
    """

    def __init__(self, maxlen: int = 0, iterable: Sequence = ()) -> None:
        super().__init__(iterable)
        self.maxlen = int(maxlen)

    def append(self, item) -> None:  # type: ignore[override]
        super().append(item)
        if self.maxlen > 0 and len(self) >= self.maxlen:
            del self[: len(self) // 2]

    def extend(self, items) -> None:  # type: ignore[override]
        for item in items:
            self.append(item)


# ---------------------------------------------------------------------------
# Instruments
# ---------------------------------------------------------------------------

class _Child:
    """A single (family, label-values) time series."""

    __slots__ = ("_family", "labels", "_value")

    def __init__(self, family: "_Family", labels: Tuple[str, ...]) -> None:
        self._family = family
        self.labels = labels
        self._value = 0

    @property
    def value(self):
        return self._value

    def inc(self, amount=1) -> None:
        if amount < 0 and self._family.kind == "counter":
            raise ValueError(
                f"{self._family.name}: counters only increase "
                f"(inc({amount!r}))")
        with self._family._lock:
            self._value += amount

    def set(self, value) -> None:
        with self._family._lock:
            self._value = value

    def get(self):
        return self._value


class _Family:
    """A named instrument family; children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def _make_child(self, key: Tuple[str, ...]) -> _Child:
        return _Child(self, key)

    def labels(self, *values, **kw) -> _Child:
        if kw:
            values = tuple(str(kw.get(n, "")) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child(values)
                self._children[values] = child
            return child

    @property
    def default(self) -> _Child:
        """Unlabelled child (only valid when the family has no labels)."""
        return self.labels()

    def children(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())

    # Convenience pass-throughs for label-less families -------------------
    def inc(self, amount=1) -> None:
        self.labels().inc(amount)

    def set(self, value) -> None:
        self.labels().set(value)

    def get(self):
        return self.labels().get()

    @property
    def value(self):
        return self.labels().value


class Counter(_Family):
    kind = "counter"


class Gauge(_Family):
    kind = "gauge"


DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _HistogramChild(_Child):
    __slots__ = ("counts", "sum", "count")

    def __init__(self, family: "_Family", labels: Tuple[str, ...]) -> None:
        super().__init__(family, labels)
        self.counts = [0] * (len(family.buckets) + 1)  # type: ignore[attr-defined]
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        fam = self._family
        idx = bisect.bisect_left(fam.buckets, value)  # type: ignore[attr-defined]
        with fam._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> Dict[str, float]:
        with self._family._lock:
            return {"count": self.count, "sum": self.sum}


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self, key: Tuple[str, ...]) -> _HistogramChild:
        return _HistogramChild(self, key)

    def observe(self, value: float) -> None:
        self.labels().observe(value)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of instrument families plus poll callbacks.

    ``register_callback(fn)`` adds a zero-arg callable returning a flat
    ``{metric_name: value}`` dict polled at snapshot time — used for
    occupancy-style gauges (pool free slots, budget bytes) that are cheaper
    to compute on demand than to maintain incrementally.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._callbacks: List[Tuple[str, Callable[[], Mapping[str, float]]]] = []

    def _instrument(self, cls, name: str, help: str,
                    labelnames: Sequence[str], **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, tuple(labelnames), **kw)
                self._families[name] = fam
            else:
                if not isinstance(fam, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {fam.kind}")
                if fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with labels "
                        f"{tuple(labelnames)} != {fam.labelnames}")
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._instrument(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._instrument(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._instrument(Histogram, name, help, labelnames,
                                buckets=buckets)

    def register_callback(self, fn: Callable[[], Mapping[str, float]],
                          group: str = "gauges") -> None:
        with self._lock:
            self._callbacks.append((group, fn))

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def collect_callbacks(self) -> Dict[str, float]:
        with self._lock:
            callbacks = list(self._callbacks)
        out: Dict[str, float] = {}
        for _group, fn in callbacks:
            try:
                out.update(fn())
            except Exception:  # pragma: no cover - snapshot must not raise
                continue
        return out

    def snapshot(self) -> Dict[str, object]:
        """Flat {name{labels}: value} view of every family + callbacks."""
        out: Dict[str, object] = {}
        for fam in self.families():
            for child in fam.children():
                key = fam.name
                if child.labels:
                    key += "{" + ",".join(
                        f'{n}="{v}"'
                        for n, v in zip(fam.labelnames, child.labels)
                    ) + "}"
                if isinstance(child, _HistogramChild):
                    out[key] = child.snapshot()
                else:
                    out[key] = child.value
        out.update(self.collect_callbacks())
        return out


# ---------------------------------------------------------------------------
# Legacy `.stats` dict adapter
# ---------------------------------------------------------------------------

class _TenantCounterView(Mapping):
    """Read view of a labelled counter family, keyed by one label value.

    Backs ``executor.stats["tenant_executed"]`` — reads behave like the old
    ``{tenant: count}`` dict; writes go through ``StatsMap.inc_labeled``.
    """

    def __init__(self, family: Counter, fixed: Dict[str, str],
                 keyed_by: str) -> None:
        self._family = family
        self._fixed = dict(fixed)
        self._keyed_by = keyed_by
        self._key_idx = family.labelnames.index(keyed_by)
        self._fixed_idx = [
            (i, self._fixed[n]) for i, n in enumerate(family.labelnames)
            if n in self._fixed
        ]

    def _matches(self, child: _Child) -> bool:
        return all(child.labels[i] == v for i, v in self._fixed_idx)

    def __getitem__(self, key: str):
        key = str(key)
        for child in self._family.children():
            if self._matches(child) and child.labels[self._key_idx] == key:
                return child.value
        raise KeyError(key)

    def __iter__(self) -> Iterator[str]:
        for child in self._family.children():
            if self._matches(child):
                yield child.labels[self._key_idx]

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def inc(self, key: str, amount=1) -> None:
        labels = dict(self._fixed)
        labels[self._keyed_by] = str(key)
        self._family.labels(**labels).inc(amount)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return repr(dict(self))


class StatsMap(MutableMapping):
    """``.stats`` drop-in whose numeric entries live in a registry.

    Numeric keys read/write registry instruments; non-numeric entries
    (``last_error``) and mapping values (``tenant_executed``) are stored in
    ``_raw``.

    ``stats["k"] += 1`` (read-modify-write) is only atomic when the caller
    holds its own lock; hot multi-threaded paths should use :meth:`inc`.
    Unknown keys assigned a number auto-register a counter — this keeps the
    stores' ``stats.update({...})`` extension pattern working.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 labels: Optional[Dict[str, str]] = None) -> None:
        self._registry = registry
        self._prefix = prefix
        self._labels = dict(labels or {})
        self._labelnames = tuple(self._labels)
        self._children: Dict[str, _Child] = {}
        self._raw: Dict[str, object] = {}
        self._order: List[str] = []

    # -- wiring ----------------------------------------------------------
    def _metric_name(self, key: str) -> str:
        return f"{self._prefix}_{key}"

    def register(self, key: str, kind: str = "counter", help: str = "") -> None:
        if key in self._children:
            return
        cls = _KINDS[kind]
        fam = self._registry._instrument(
            cls, self._metric_name(key), help, self._labelnames)
        self._children[key] = fam.labels(**self._labels) if self._labels \
            else fam.labels()
        if key not in self._order:
            self._order.append(key)

    def register_many(self, keys: Sequence[str], kind: str = "counter") -> None:
        for key in keys:
            self.register(key, kind)

    def register_raw(self, key: str, value=None) -> None:
        self._raw[key] = value
        if key not in self._order:
            self._order.append(key)

    def register_tenant_view(self, key: str, family: Counter,
                             keyed_by: str = "tenant") -> None:
        self._raw[key] = _TenantCounterView(family, self._labels, keyed_by)
        if key not in self._order:
            self._order.append(key)

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str):
        child = self._children.get(key)
        if child is not None:
            return child.value
        if key in self._raw:
            return self._raw[key]
        raise KeyError(key)

    def __setitem__(self, key: str, value) -> None:
        child = self._children.get(key)
        if child is None:
            if key in self._raw or not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                self._raw[key] = value
                if key not in self._order:
                    self._order.append(key)
                return
            self.register(key, "counter")
            child = self._children[key]
        child.set(value)

    def __delitem__(self, key: str) -> None:
        if key in self._raw:
            del self._raw[key]
            self._order.remove(key)
            return
        raise KeyError(f"cannot delete instrument-backed key {key!r}")

    def __contains__(self, key) -> bool:  # type: ignore[override]
        return key in self._children or key in self._raw

    def __iter__(self) -> Iterator[str]:
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def keys(self):
        return list(self._order)

    def values(self):
        return [self[k] for k in self._order]

    def items(self):
        return [(k, self[k]) for k in self._order]

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def update(self, other=(), **kw) -> None:  # type: ignore[override]
        if hasattr(other, "items"):
            other = other.items()
        for k, v in other:
            self[k] = v
        for k, v in kw.items():
            self[k] = v

    def setdefault(self, key, default=None):
        if key in self:
            return self[key]
        self[key] = default
        return self[key]

    def copy(self) -> Dict[str, object]:
        out = {}
        for k in self._order:
            v = self[k]
            out[k] = dict(v) if isinstance(v, Mapping) else v
        return out

    def __eq__(self, other) -> bool:  # type: ignore[override]
        if isinstance(other, Mapping) and not isinstance(other, StatsMap):
            return self.copy() == dict(other)
        return self is other

    def __ne__(self, other) -> bool:  # type: ignore[override]
        return not self.__eq__(other)

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self) -> str:
        return f"StatsMap({self.copy()!r})"

    # -- atomic helpers ---------------------------------------------------
    def inc(self, key: str, amount=1) -> None:
        child = self._children.get(key)
        if child is None:
            self.register(key, "counter")
            child = self._children[key]
        child.inc(amount)

    def set(self, key: str, value) -> None:
        self[key] = value

    def inc_labeled(self, key: str, label_value: str, amount=1) -> None:
        view = self._raw[key]
        view.inc(label_value, amount)
