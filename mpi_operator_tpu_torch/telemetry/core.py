"""Zero-dependency metrics core for the data plane.

The PyTorch port's own copy of mpi_operator_tpu/telemetry/core.py:
the port imports nothing of the JAX package, not even its
framework-free modules. Its logic and names are the reference's,
held to it by tests/test_torch_telemetry.py.

The control plane grew a Prometheus endpoint (controller/metrics.py)
while the data plane — the part ROADMAP says must run "as fast as the
hardware allows" — reported nothing but a post-hoc bench JSONL line.
This module is the missing half: counters, gauges, and streaming
histograms cheap enough to live INSIDE the hot loops (train step, decode
step) without moving the numbers they measure.

Design constraints, in order:

  * **No per-step allocation on the hot path.** `Histogram.observe` is a
    bisect into a precomputed edge tuple plus two integer bumps — no new
    lists, dicts, or strings per call. Rendering (the slow path) is the
    only place that builds text.
  * **Fixed log-spaced buckets.** Latencies span decades (a 50 µs decode
    dispatch to a 30 s compile); log-spaced edges give constant RELATIVE
    resolution everywhere on that range, and fixing them at construction
    means observe never rebalances anything (contrast HDR/t-digest style
    adaptive sketches — better tails, but allocation and branching on
    every record). With the default 10 buckets/decade the edge ratio is
    10^(1/10) ≈ 1.26, so any quantile estimate is within ~26% of truth —
    the right trade for wall-time telemetry read as p50/p99 summaries.
  * **Thread-safe.** The serving engine's host loop, checkpoint threads,
    and the /metrics scrape thread all touch the same registry; every
    mutation takes a per-metric lock (uncontended CPython lock ≈ 100 ns,
    invisible next to a millisecond step).

Exporters live next door: prometheus.py (worker /metrics, text format)
and events.py (fsync'd JSONL for discrete events).
"""
from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Tuple


def _env_float(name: str) -> Optional[float]:
    v = os.environ.get(name, "").strip()
    if not v:
        return None
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not a number") from None


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class Counter:
    """Monotone counter (`*_total` naming convention)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Streaming histogram over fixed log-spaced buckets.

    Edges are ``lo * r^i`` with ``r = 10^(1/per_decade)``, spanning
    [lo, hi]; observations below lo land in the first bucket and
    observations above hi in the overflow (+Inf) bucket, so no value is
    ever dropped. Defaults (100 µs … 1000 s, 10/decade = 71 edges) cover
    everything from a decode-step dispatch to a cold compile.

    `percentile(p)` log-interpolates inside the covering bucket — an
    estimate with relative error bounded by the edge ratio (~26% at the
    default resolution), which is what a p50/p99 summary needs; exact
    quantiles would require keeping every sample.

    Deploy-time overrides: ``TPU_HIST_LO``, ``TPU_HIST_HI`` (seconds) and
    ``TPU_HIST_PER_DECADE`` (int) replace the constructor's range/
    resolution for EVERY histogram in the process — the operator knob for
    re-ranging telemetry on hardware whose latencies fall off the baked-in
    edges (e.g. sub-10 µs decode steps, or coarser buckets to shrink
    scrape payloads) without touching call sites. Unset or empty
    variables leave the code-specified values alone.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 lo: float = 1e-4, hi: float = 1e3,
                 per_decade: int = 10,
                 labels: Optional[Dict[str, str]] = None):
        env_lo = _env_float("TPU_HIST_LO")
        env_hi = _env_float("TPU_HIST_HI")
        env_pd = _env_float("TPU_HIST_PER_DECADE")
        if env_lo is not None:
            lo = env_lo
        if env_hi is not None:
            hi = env_hi
        if env_pd is not None:
            per_decade = int(env_pd)
        if not (0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if per_decade < 1:
            raise ValueError(f"per_decade must be >= 1, got {per_decade}")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        r = 10.0 ** (1.0 / per_decade)
        # rounded to 6 significant figures: keeps the `le` labels human-
        # readable and strictly increasing (ratio ~1.26 >> rounding error)
        edges: List[float] = [float(f"{lo:.6g}")]
        while edges[-1] < hi * (1 - 1e-9):
            edges.append(float(f"{lo * r ** len(edges):.6g}"))
        self.edges: Tuple[float, ...] = tuple(edges)   # bucket UPPER bounds
        self._lock = threading.Lock()
        # one extra slot: the +Inf overflow bucket
        self._counts = [0] * (len(self.edges) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, x: float) -> None:
        # bisect_left: first edge >= x, i.e. the Prometheus `le` bucket;
        # x past the last edge indexes the overflow slot
        i = bisect_left(self.edges, x)
        with self._lock:
            self._counts[i] += 1
            self._sum += x
            self._count += 1

    def observe_n(self, x: float, n: int) -> None:
        """Fold n identical observations in one lock acquisition — for
        windowed loops that only learn a per-step AVERAGE at the window
        fetch (async dispatch makes per-iteration host time meaningless;
        the window average is the true device step time)."""
        if n <= 0:
            return
        i = bisect_left(self.edges, x)
        with self._lock:
            self._counts[i] += n
            self._sum += x * n
            self._count += n

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. overflow, sum, count) — one lock."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def percentile(self, p: float) -> Optional[float]:
        """Estimated p-th percentile (0-100), None when empty."""
        counts, _sum, total = self.snapshot()
        if total == 0:
            return None
        target = max(1, min(total, -(-total * p // 100)))  # ceil, clamped
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                if i >= len(self.edges):        # overflow: best we can say
                    return self.edges[-1]
                upper = self.edges[i]
                lower = self.edges[i - 1] if i > 0 else upper / 1.26
                frac = (target - (cum - c)) / c
                return lower * (upper / lower) ** frac
        return self.edges[-1]                   # unreachable


class Registry:
    """Named metric store, get-or-create semantics.

    Re-requesting a (name, labels) pair returns the EXISTING instrument —
    repeated benchmark legs in one process accumulate into the same
    series instead of colliding on registration. Asking for the same name
    with a different kind raises: that's a naming bug, not a merge.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], object] = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}, requested "
                        f"{cls.__name__}")
                return existing
            m = cls(name, help, labels=labels, **kw)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  lo: float = 1e-4, hi: float = 1e3, per_decade: int = 10,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   lo=lo, hi=hi, per_decade=per_decade)

    def collect(self) -> Iterable[object]:
        """Metrics in registration order (stable scrape output)."""
        with self._lock:
            return list(self._metrics.values())


__all__ = ["Counter", "Gauge", "Histogram", "Registry"]
