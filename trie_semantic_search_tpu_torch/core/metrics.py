"""Metrics registry (copy of the JAX package's ``core/metrics.py``):
counters and latency histograms (``metrics.inc``, ``metrics.timed``) that
the engine feeds. The periodic reporter and the profiling hook come with
the server slice, which calls them.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional


@dataclass
class LatencyHistogram:
    """Bounded reservoir of latencies with percentile queries."""

    max_samples: int = 4096
    _samples: list[float] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    count: int = 0
    total_ms: float = 0.0

    def observe(self, ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += ms
            bisect.insort(self._samples, ms)
            if len(self._samples) > self.max_samples:
                # drop alternating extremes to keep the distribution shape
                del self._samples[0 if self.count % 2 else -1]

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            idx = min(len(self._samples) - 1, int(p / 100 * len(self._samples)))
            return self._samples[idx]

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_ms": (self.total_ms / self.count) if self.count else None,
            "p50_ms": self.percentile(50),
            "p95_ms": self.percentile(95),
            "p99_ms": self.percentile(99),
        }


class MetricsRegistry:
    """Named counters + latency histograms."""

    def __init__(self) -> None:
        self._counters: dict[str, int] = {}
        self._histograms: dict[str, LatencyHistogram] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def histogram(self, name: str) -> LatencyHistogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = LatencyHistogram()
            return h

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.histogram(name).observe((time.perf_counter() - t0) * 1000)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "latency": {k: h.summary() for k, h in self._histograms.items()},
            }


#: process-wide default registry
metrics = MetricsRegistry()
