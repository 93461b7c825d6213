"""Host-layer metrics registry: counters, gauges, streaming histograms
(the port's own copy of ``repro.obs.metrics``, which is plain Python).

* :class:`Counter` / :class:`Gauge` — monotone totals and last-value
  instruments;
* :class:`StreamingHistogram` — a log-bucketed streaming histogram with
  bounded relative error: ``observe`` is O(1), quantiles (p50/p99) read
  off the cumulative bucket walk, and :meth:`StreamingHistogram.merge`
  adds per-bucket counts, so shard- or process-local histograms fold
  into fleet-wide ones without bias;
* :class:`TraceCounter` — a ``collections.Counter`` that lives in the
  registry.  The reference ticks one per jax trace; the port has no
  tracing and registers none itself, but keeps the instrument so a
  caller's counts export the same way;
* the compile-cache registry: :func:`register_cache` /
  :func:`cache_stats` / :func:`clear_caches` see every cache registered
  with it (the port's serving layer registers none: it compiles nothing
  per shape).

:func:`MetricsRegistry.collect` flattens everything (plus any registered
collectors) into :class:`Sample` rows.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "StreamingHistogram", "TraceCounter", "Sample",
    "MetricsRegistry", "REGISTRY", "register_cache", "cache_stats",
    "clear_caches", "trace_counts", "observe_span",
]


@dataclasses.dataclass(frozen=True)
class Sample:
    """One exported metric row: ``name{labels} value``."""

    name: str
    labels: Tuple[Tuple[str, str], ...]
    value: float
    kind: str = "gauge"            # counter | gauge | histogram
    help: str = ""


class Counter:
    """Monotone total."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        assert amount >= 0, "counters only go up"
        self.value += float(amount)

    def samples(self) -> Iterable[Sample]:
        yield Sample(self.name + "_total", (), self.value, "counter",
                     self.help)


class Gauge:
    """Last-set value."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = math.nan

    def set(self, value: float) -> None:
        self.value = float(value)

    def samples(self) -> Iterable[Sample]:
        if not math.isnan(self.value):
            yield Sample(self.name, (), self.value, "gauge", self.help)


class StreamingHistogram:
    """Log-bucketed streaming histogram with relative-error-bounded
    quantiles and exactly-associative merge.

    Positive observations land in bucket ``floor(log(v) / log(growth))``
    — every bucket spans a fixed ``growth`` ratio, so a quantile read off
    a bucket's geometric midpoint is within a factor ``growth`` of some
    order statistic at the target rank.
    Non-positive observations (latency/telemetry metrics are naturally
    ``>= 0``; zeros happen) collapse into one underflow bucket whose
    quantile estimate is the exact running ``min``.  ``count/sum/min/max``
    are exact.

    ``merge`` adds per-bucket counts — associative and commutative by
    construction, so partial histograms from different shards/processes
    fold in any order to the same buckets (``sum`` is a float sum and
    rounds by the order of the fold).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", growth: float = 1.05):
        assert growth > 1.0
        self.name = name
        self.help = help
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.buckets: Dict[int, int] = {}
        self.n_nonpos = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ------------------------------------------------------------------ #
    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= 0.0:
            self.n_nonpos += 1
            return
        b = math.floor(math.log(v) / self._log_g)
        self.buckets[b] = self.buckets.get(b, 0) + 1

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(v)

    # ------------------------------------------------------------------ #
    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], within a ``growth`` factor
        of the exact order statistic (NaN on an empty histogram)."""
        if self.count == 0:
            return math.nan
        q = min(max(float(q), 0.0), 1.0)
        target = min(max(int(math.ceil(q * self.count)), 1), self.count)
        if target <= self.n_nonpos:
            return self.min
        cum = self.n_nonpos
        for b in sorted(self.buckets):
            cum += self.buckets[b]
            if cum >= target:
                mid = math.exp((b + 0.5) * self._log_g)
                return min(max(mid, self.min), self.max)
        return self.max                          # numerically unreachable

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    # ------------------------------------------------------------------ #
    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Return a new histogram holding both streams (exact fold)."""
        assert math.isclose(self.growth, other.growth), \
            "cannot merge histograms with different bucket growth"
        out = StreamingHistogram(self.name, self.help, self.growth)
        out.buckets = dict(self.buckets)
        for b, c in other.buckets.items():
            out.buckets[b] = out.buckets.get(b, 0) + c
        out.n_nonpos = self.n_nonpos + other.n_nonpos
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    def state(self) -> Dict:
        """Comparable/serialisable snapshot (merge-associativity tests)."""
        return {"buckets": dict(self.buckets), "n_nonpos": self.n_nonpos,
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}

    def samples(self) -> Iterable[Sample]:
        yield Sample(self.name + "_count", (), float(self.count),
                     "histogram", self.help)
        yield Sample(self.name + "_sum", (), self.sum, "histogram",
                     self.help)
        if self.count:
            for q in (0.5, 0.99):
                yield Sample(self.name, (("quantile", f"{q:g}"),),
                             self.quantile(q), "histogram", self.help)


class TraceCounter(collections.Counter):
    """A per-site counter that lives in the metrics registry.

    Subclasses ``collections.Counter`` (``counts["site"] += 1``,
    ``dict(counts)`` snapshots, ``.clear()``); the registry exports each
    site as a labelled ``repro_trace_total`` sample and
    :func:`trace_counts` folds every registered instance into one dict.
    """

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def samples(self) -> Iterable[Sample]:
        for site, n in sorted(self.items()):
            yield Sample("repro_trace_total",
                         (("registry", self.name), ("site", str(site))),
                         float(n), "counter",
                         "ticks of an instrumented site")


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #
class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    ``collect()`` flattens every instrument (and every registered
    collector's extra samples) into :class:`Sample` rows for export.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = collections.OrderedDict()
        self._collectors: List[Callable[[], Iterable[Sample]]] = []

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        assert isinstance(m, cls), \
            f"metric {name!r} already registered as {type(m).__name__}"
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  growth: float = 1.05) -> StreamingHistogram:
        return self._get(name, StreamingHistogram, help=help, growth=growth)

    def trace_counter(self, name: str) -> TraceCounter:
        m = self._metrics.get(name)
        if m is None:
            m = TraceCounter(name)
            self._metrics[name] = m
        assert isinstance(m, TraceCounter)
        return m

    def add_collector(self, fn: Callable[[], Iterable[Sample]]) -> None:
        self._collectors.append(fn)

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return list(self._metrics)

    def collect(self) -> List[Sample]:
        out: List[Sample] = []
        for m in self._metrics.values():
            out.extend(m.samples())
        for fn in self._collectors:
            out.extend(fn())
        return out

    def reset(self) -> None:
        """Zero every instrument (tests); trace counters clear too."""
        for m in list(self._metrics.values()):
            if isinstance(m, TraceCounter):
                m.clear()
            elif isinstance(m, Counter):
                m.value = 0.0
            elif isinstance(m, Gauge):
                m.value = math.nan
            elif isinstance(m, StreamingHistogram):
                fresh = StreamingHistogram(m.name, m.help, m.growth)
                self._metrics[m.name] = fresh


REGISTRY = MetricsRegistry()


def observe_span(name: str, seconds: float,
                 registry: MetricsRegistry = REGISTRY) -> None:
    """Record one wall-clock span into a streaming histogram."""
    registry.histogram(name, help="wall-clock span [s]").observe(seconds)


def trace_counts(registry: MetricsRegistry = REGISTRY) -> Dict[str, int]:
    """Every registered ``TraceCounter`` site, flattened to
    ``{"<registry>.<site>": ticks}``."""
    out: Dict[str, int] = {}
    for m in registry._metrics.values():
        if isinstance(m, TraceCounter):
            for site, n in m.items():
                out[f"{m.name}.{site}"] = int(n)
    return out


# --------------------------------------------------------------------------- #
# compile-cache registry
# --------------------------------------------------------------------------- #
_CACHES: list = []


def register_cache(cache) -> None:
    """Register an object with ``name``, ``stats()`` and ``clear()``."""
    _CACHES.append(cache)


def cache_stats() -> Dict[str, Dict[str, int]]:
    """Per-cache ``{currsize, maxsize, hits, misses, evictions}``."""
    return {c.name: c.stats() for c in _CACHES}


def clear_caches() -> None:
    """Clear every registered cache."""
    for c in _CACHES:
        c.clear()


def _cache_samples() -> Iterable[Sample]:
    for c in _CACHES:
        s = c.stats()
        for field in ("hits", "misses", "evictions"):
            yield Sample(f"repro_compile_cache_{field}_total",
                         (("cache", c.name),), float(s[field]), "counter",
                         "compiled-fn cache " + field)
        yield Sample("repro_compile_cache_size", (("cache", c.name),),
                     float(s["currsize"]), "gauge",
                     "compiled-fn cache entries")


REGISTRY.add_collector(_cache_samples)
