"""Metrics registry (port of the JAX package's ``core/metrics.py``):
counters and latency histograms (``metrics.inc``, ``metrics.timed``) that
the engine feeds, and the periodic :class:`MetricsReporter` of ``serve``.

The served batch's spans live here. ``timed`` spans the parents
(``search_batch``, ``fused_embed``, ``fused_device``); ``leaf`` spans the
contiguous parts inside them and, while a ``torch.profiler`` records the
calling thread, also opens a ``record_function`` range of the same name on
the profiler's clock; ``profile_range`` opens only the range, for device
work the host merely enqueues. Work interleaved per result (gunzip, the
sentence split, the snippet) is summed by its caller and recorded once with
``histogram(name).observe``. Each histogram also keeps its newest
observations with their end times, so :meth:`MetricsRegistry.between`
gives a span's count and total over any recent stretch of
``time.perf_counter``, read after the stretch.
"""

from __future__ import annotations

import bisect
import contextlib
import logging
import sys
import threading
import time
from array import array
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

_log = logging.getLogger("tss_torch.metrics")


#: observations a histogram keeps with their end times (a ring)
RECENT = 16384


@dataclass
class LatencyHistogram:
    """Bounded reservoir of latencies with percentile queries, and a ring of
    the newest ``RECENT`` observations with their end times."""

    max_samples: int = 4096
    _samples: list[float] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    count: int = 0
    total_ms: float = 0.0
    _ends: array = field(default_factory=lambda: array("d"))
    _ms: array = field(default_factory=lambda: array("d"))

    def observe(self, ms: float, end: Optional[float] = None) -> None:
        """Record ``ms`` that ended at ``end`` (``time.perf_counter``; now
        by default)."""
        end = time.perf_counter() if end is None else end
        with self._lock:
            self.count += 1
            self.total_ms += ms
            bisect.insort(self._samples, ms)
            if len(self._samples) > self.max_samples:
                # drop alternating extremes to keep the distribution shape
                del self._samples[0 if self.count % 2 else -1]
            if len(self._ends) < RECENT:
                self._ends.append(end)
                self._ms.append(ms)
            else:
                i = (self.count - 1) % RECENT
                self._ends[i], self._ms[i] = end, ms

    def between(self, t0: float, t1: float) -> Optional[tuple[int, float]]:
        """Count and total ms of the observations that ended in ``[t0,
        t1]``; None where the ring has since dropped one that may have."""
        with self._lock:
            if len(self._ends) == RECENT and self._ends[self.count % RECENT] > t0:
                return None
            hits = [ms for end, ms in zip(self._ends, self._ms) if t0 <= end <= t1]
        return len(hits), sum(hits)

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
            t1 = time.perf_counter()
            self.histogram(name).observe((t1 - t0) * 1000, t1)

    @contextlib.contextmanager
    def leaf(self, name: str) -> Iterator[None]:
        """:meth:`timed`, and a ``torch.profiler`` range of the same name
        while a profiler records this thread (a ``user_annotation`` in its
        trace). Without one it costs one check beyond the registry entry."""
        rng = _profiler_range(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rng is not None:
                rng.__exit__(None, None, None)
            self.histogram(name).observe((t1 - t0) * 1000, t1)

    @contextlib.contextmanager
    def profile_range(self, name: str) -> Iterator[None]:
        """A ``torch.profiler`` range of ``name`` while a profiler records
        this thread, and no histogram: for device work the host only
        enqueues (an encoder's layers), whose host time says nothing."""
        rng = _profiler_range(name)
        try:
            yield
        finally:
            if rng is not None:
                rng.__exit__(None, None, None)

    def between(self, t0: float, t1: float) -> dict[str, tuple[int, float]]:
        """``{name: (count, total ms)}`` of each histogram's observations that
        ended in ``[t0, t1]`` (``time.perf_counter``), for the names whose
        ring still holds the whole stretch."""
        with self._lock:
            hs = dict(self._histograms)
        out = {n: h.between(t0, t1) for n, h in hs.items()}
        return {n: v for n, v in out.items() if v is not None}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "latency": {k: h.summary() for k, h in self._histograms.items()},
            }


#: process-wide default registry
metrics = MetricsRegistry()


def _profiler_range(name: str):
    """An entered ``record_function(name)`` while a ``torch.profiler``
    records the calling thread, else None (no profiler can run before torch
    is imported, so this module does not import it)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch.autograd.profiler.record_function(name)
    rng.__enter__()
    return rng


class MetricsReporter:
    """Logs a snapshot of the registry (plus ``extra()`` under
    ``"system"``) every ``interval_seconds``, on a
    :class:`..maintenance.PeriodicTask`."""

    def __init__(
        self,
        interval_seconds: float = 60.0,
        extra: Optional[Callable[[], dict]] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        from .maintenance import PeriodicTask

        self.extra = extra
        self.registry = registry or metrics
        self._task = PeriodicTask("metrics", interval_seconds, self._report)

    def _report(self) -> None:
        snap = self.registry.snapshot()
        if self.extra:
            try:
                snap["system"] = self.extra()
            except Exception as e:  # a failing probe must not stop the reports
                snap["system"] = {"error": str(e)}
        _log.info("metrics: %s", snap)

    def start(self) -> None:
        self._task.start()

    def stop(self) -> None:
        self._task.stop()

