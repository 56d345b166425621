"""Registry exporters: Prometheus text exposition, JSON snapshot, and a
``torch.profiler`` annotation hook for fold launches."""
from __future__ import annotations

import contextlib
import json
from typing import Dict

from .registry import Histogram, MetricsRegistry, _HistogramChild

__all__ = ["to_prometheus", "to_json", "profiler_annotation"]


def _fmt_labels(labelnames, labelvalues) -> str:
    if not labelvalues:
        return ""
    body = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, labelvalues))
    return "{" + body + "}"


def to_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition format (v0.0.4) for the whole registry."""
    lines = []
    for fam in registry.families():
        children = fam.children()
        if not children:
            continue
        name = fam.name
        if fam.kind == "counter" and not name.endswith("_total"):
            name += "_total"
        if fam.help:
            lines.append(f"# HELP {name} {fam.help}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for child in children:
            labels = _fmt_labels(fam.labelnames, child.labels)
            if isinstance(child, _HistogramChild):
                acc = 0
                for bound, n in zip(fam.buckets, child.counts):
                    acc += n
                    lb = _fmt_labels(fam.labelnames + ("le",),
                                     child.labels + (repr(float(bound)),))
                    lines.append(f"{name}_bucket{lb} {acc}")
                lb = _fmt_labels(fam.labelnames + ("le",),
                                 child.labels + ("+Inf",))
                lines.append(f"{name}_bucket{lb} {child.count}")
                lines.append(f"{name}_sum{labels} {child.sum}")
                lines.append(f"{name}_count{labels} {child.count}")
            else:
                lines.append(f"{name}{labels} {child.value}")
    for cname, value in sorted(registry.collect_callbacks().items()):
        lines.append(f"# TYPE {cname} gauge")
        lines.append(f"{cname} {value}")
    return "\n".join(lines) + "\n"


def to_json(registry: MetricsRegistry, indent=None) -> str:
    """JSON rendering of ``registry.snapshot()``."""
    return json.dumps(registry.snapshot(), indent=indent, sort_keys=True,
                      default=str)


@contextlib.contextmanager
def profiler_annotation(name: str, enabled: bool = True):
    """Wrap a region in ``torch.profiler.record_function`` so device
    traces line up with engine spans. No-op when disabled, so callers can
    wrap fold launches unconditionally and gate with a config knob."""
    if not enabled:
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        yield
