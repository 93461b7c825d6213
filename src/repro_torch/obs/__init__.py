"""Observability: the host metrics registry (:mod:`.metrics`), the serving
and co-sim taps with their host-side toggle (:mod:`.taps`), the fleet
health snapshot (:mod:`.health`) and the JSONL / Prometheus export
(:mod:`.export`)."""
from .metrics import (REGISTRY, Counter, Gauge, MetricsRegistry, Sample,
                      StreamingHistogram, TraceCounter, cache_stats,
                      clear_caches, observe_span, trace_counts)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "MetricsRegistry", "Sample",
    "StreamingHistogram", "TraceCounter", "cache_stats", "clear_caches",
    "observe_span", "trace_counts",
]
