"""Unified observability layer: metrics registry, structured tracing, and
exporters shared by the engine, I/O scheduler, stores, pool, and pipeline."""
from .registry import (BoundedSeries, Counter, Gauge, Histogram,
                       MetricsRegistry, StatsMap)
from .trace import NULL_SPAN, NullSpan, Span, Tracer
from .export import profiler_annotation, to_json, to_prometheus

__all__ = [
    "BoundedSeries", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "StatsMap", "NULL_SPAN", "NullSpan", "Span", "Tracer",
    "profiler_annotation", "to_json", "to_prometheus",
]
