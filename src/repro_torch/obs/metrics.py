"""Process-local metrics: counters, gauges, and log-bucketed histograms.

Every layer of the serving stack (front tier, executor, query cache, live
store, sharded dispatch) records into one :class:`MetricsRegistry` instead
of keeping its own ad-hoc counters, so "why was this query slow" has a
single answer surface: ``registry.snapshot()`` (and ``session.explain``'s
``== metrics ==`` section, which is just a reader of it).

Design constraints, in order:

* **near-zero cost when disabled** — the package-level accessor
  (``repro_torch.obs.registry()``) returns the :data:`NULL_REGISTRY` no-op
  singleton unless observability was enabled, so instrumented hot paths pay
  one attribute call that does nothing;
* **clock-injectable** — like ``serve/batching.py``'s ``BatchFormer``,
  every timing surface takes ``now=`` so unit tests drive histograms and
  timers with a fake clock (tests/test_obs.py);
* **bounded memory** — histograms are log-bucketed (geometric bucket
  edges), so a latency distribution spanning six orders of magnitude costs
  a fixed ~64 ints, and percentile snapshots (p50/p95/p99) read straight
  off the cumulative bucket counts.

Percentiles are bucket-resolution: a reported quantile is the geometric
midpoint of the bucket containing it, i.e. exact to within a factor of
``sqrt(growth)`` (default growth 2.0 -> ~1.41x).  ``count``/``sum``/
``min``/``max`` are exact.

Nothing here is hard-synchronized: increments are GIL-atomic enough for
telemetry (a lost update under extreme thread races skews a counter by one,
never corrupts state), and metric *creation* is locked so concurrent first
touches of one name agree on the instrument.
"""
from __future__ import annotations

import math
import threading
import time


class Counter:
    """Monotone event count (``inc`` only)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class Gauge:
    """Point-in-time level (``set``/``inc``/``dec``): queue depth, resident
    bytes, segment count, compaction debt."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def inc(self, n: float = 1.0):
        self.value += n

    def dec(self, n: float = 1.0):
        self.value -= n


class Histogram:
    """Log-bucketed distribution with percentile snapshots.

    Bucket ``i >= 1`` covers ``[lo * growth**(i-1), lo * growth**i)``;
    bucket 0 holds everything below ``lo`` (including zeros/negatives,
    which a wall-clock duration can produce on coarse clocks).  Values at
    or above the top edge clamp into the last bucket — ``max`` still
    reports them exactly.
    """

    __slots__ = ("name", "lo", "growth", "n_buckets", "buckets", "count",
                 "sum", "min", "max", "_log_lo", "_log_growth")

    def __init__(self, name: str, lo: float = 1e-6, growth: float = 2.0,
                 n_buckets: int = 64):
        if lo <= 0 or growth <= 1.0 or n_buckets < 2:
            raise ValueError("need lo > 0, growth > 1, n_buckets >= 2")
        self.name = name
        self.lo = lo
        self.growth = growth
        self.n_buckets = n_buckets
        self.buckets = [0] * n_buckets
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._log_lo = math.log(lo)
        self._log_growth = math.log(growth)

    def bucket_index(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = 1 + int((math.log(v) - self._log_lo) / self._log_growth)
        return min(i, self.n_buckets - 1)

    def bucket_edges(self, i: int) -> tuple:
        """(lower, upper) value edges of bucket ``i`` (bucket 0's lower
        edge is 0)."""
        if i <= 0:
            return (0.0, self.lo)
        return (self.lo * self.growth ** (i - 1), self.lo * self.growth ** i)

    def observe(self, v: float):
        v = float(v)
        self.buckets[self.bucket_index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Bucket-resolution quantile: the geometric midpoint of the bucket
        containing the ``q``-th percentile observation (0 with no data)."""
        if self.count == 0:
            return 0.0
        target = max(q / 100.0 * self.count, 1.0)
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                lo, hi = self.bucket_edges(i)
                if i == 0:
                    return min(self.lo, self.max)
                # clamp into the observed range so single-value
                # distributions report that value exactly
                return min(max(math.sqrt(lo * hi), self.min), self.max)
        return self.max

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count, "min": self.min,
                "max": self.max, "p50": self.percentile(50),
                "p95": self.percentile(95), "p99": self.percentile(99)}


class _Timer:
    """Context manager recording elapsed ``now()`` seconds into a
    histogram on exit."""

    __slots__ = ("_hist", "_now", "_t0")

    def __init__(self, hist: Histogram, now):
        self._hist = hist
        self._now = now

    def __enter__(self):
        self._t0 = self._now()
        return self

    def __exit__(self, *exc):
        self._hist.observe(self._now() - self._t0)
        return False


class MetricsRegistry:
    """One process-local home for every metric (see module docstring).

    Instruments are created on first touch and memoized by name; touching a
    name as two different kinds raises (one name, one meaning)."""

    def __init__(self, now=time.perf_counter):
        self._now = now
        self._metrics: dict = {}
        self._lock = threading.Lock()
        #: real registries answer True so call sites can skip expensive
        #: *derivations* (not recording) when observability is off
        self.enabled = True

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name, **kw)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {type(m).__name__}, "
                            f"not a {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: float = 1e-6, growth: float = 2.0,
                  n_buckets: int = 64) -> Histogram:
        return self._get(name, Histogram, lo=lo, growth=growth,
                         n_buckets=n_buckets)

    def timer(self, name: str) -> _Timer:
        """``with registry.timer("store.add_table_seconds"): ...``"""
        return _Timer(self.histogram(name), self._now)

    # -------------------------------------------------------------- reading
    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}`` —
        plain JSON-serializable values (histograms as their snapshot
        dicts), name-sorted for stable rendering."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def render(self) -> str:
        """Human-readable snapshot (examples / ``explain``)."""
        snap = self.snapshot()
        lines = []
        for name, v in snap["counters"].items():
            lines.append(f"  {name:<40s} {v:,.0f}")
        for name, v in snap["gauges"].items():
            lines.append(f"  {name:<40s} {v:,.1f}")
        for name, h in snap["histograms"].items():
            if "seconds" in name:
                lines.append(
                    f"  {name:<40s} n={h['count']:<7d} "
                    f"p50={h['p50'] * 1e3:9.3f}ms "
                    f"p95={h['p95'] * 1e3:9.3f}ms "
                    f"p99={h['p99'] * 1e3:9.3f}ms "
                    f"max={h['max'] * 1e3:9.3f}ms")
            else:
                lines.append(
                    f"  {name:<40s} n={h['count']:<7d} "
                    f"p50={h['p50']:9.2f} p95={h['p95']:9.2f} "
                    f"p99={h['p99']:9.2f} max={h['max']:9.2f}")
        return "\n".join(lines) if lines else "  (no metrics recorded)"

    def reset(self):
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# the disabled path: no-op singletons (one shared instance of each, so the
# instrumented hot paths allocate nothing when observability is off)
# ---------------------------------------------------------------------------

class _NullCounter:
    name = "null"
    value = 0.0

    def inc(self, n: float = 1.0):
        pass


class _NullGauge:
    name = "null"
    value = 0.0

    def set(self, v: float):
        pass

    def inc(self, n: float = 1.0):
        pass

    def dec(self, n: float = 1.0):
        pass


class _NullHistogram:
    name = "null"
    count = 0

    def observe(self, v: float):
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def snapshot(self) -> dict:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0, "max": 0.0,
                "p50": 0.0, "p95": 0.0, "p99": 0.0}


class _NullTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class NullRegistry:
    """The disabled registry: every accessor returns a shared no-op."""

    enabled = False
    _counter = _NullCounter()
    _gauge = _NullGauge()
    _hist = _NullHistogram()
    _timer = _NullTimer()

    def counter(self, name: str) -> _NullCounter:
        return self._counter

    def gauge(self, name: str) -> _NullGauge:
        return self._gauge

    def histogram(self, name: str, **kw) -> _NullHistogram:
        return self._hist

    def timer(self, name: str) -> _NullTimer:
        return self._timer

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def render(self) -> str:
        return "  (observability disabled)"

    def reset(self):
        pass


NULL_REGISTRY = NullRegistry()
