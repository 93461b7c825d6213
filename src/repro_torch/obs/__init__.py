"""Observability: the host metrics registry (:mod:`.metrics`), per-step
serving taps (:mod:`.taps`) and the fleet health snapshot
(:mod:`.health`)."""
from .metrics import (REGISTRY, Counter, Gauge, MetricsRegistry, Sample,
                      StreamingHistogram, TraceCounter, cache_stats,
                      clear_caches, observe_span, trace_counts)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "MetricsRegistry", "Sample",
    "StreamingHistogram", "TraceCounter", "cache_stats", "clear_caches",
    "observe_span", "trace_counts",
]
