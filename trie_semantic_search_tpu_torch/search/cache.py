"""Host-side caches for the query path (copy of the JAX package's
``search/cache.py``).

* :class:`QueryCache` — TTL'd result cache (ref:
  ``reference src/search.rs:104-116,344-385``: 10k entries, TTL
  3600 s, evict-on-full). The reference evicted an arbitrary map entry;
  here eviction is LRU (strictly better, same surface).
* :class:`VectorCache` — embedding memo (ref:
  ``reference src/vector.rs:46-50,210-235``: max 1000 entries, naive
  first-key eviction → LRU here).

Both are thread-safe: the API server serves from a thread pool.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Generic, Hashable, Optional, TypeVar

import numpy as np

T = TypeVar("T")


@dataclass
class CacheStats:
    """ref: search.rs:396-400."""

    size: int = 0
    max_size: int = 0
    hits: int = 0
    misses: int = 0


class _LruTtl(Generic[T]):
    def __init__(self, max_size: int, ttl_seconds: Optional[float] = None):
        self.max_size = max_size
        self.ttl = ttl_seconds
        self._d: OrderedDict[Hashable, tuple[float, T]] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0

    def get(self, key: Hashable) -> Optional[T]:
        with self._lock:
            item = self._d.get(key)
            if item is None:
                self._misses += 1
                return None
            ts, value = item
            if self.ttl is not None and (time.monotonic() - ts) >= self.ttl:
                del self._d[key]
                self._misses += 1
                return None
            self._d.move_to_end(key)
            self._hits += 1
            return value

    def put(self, key: Hashable, value: T) -> None:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
            self._d[key] = (time.monotonic(), value)
            while len(self._d) > self.max_size:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def get_stats(self) -> CacheStats:
        return CacheStats(
            size=len(self._d),
            max_size=self.max_size,
            hits=self._hits,
            misses=self._misses,
        )


class QueryCache(_LruTtl[Any]):
    """TTL'd search-result cache keyed by the full query signature."""

    def __init__(self, max_size: int = 10_000, ttl_seconds: float = 3600.0):
        super().__init__(max_size, ttl_seconds)


class VectorCache(_LruTtl[np.ndarray]):
    """Embedding memo keyed by text (ref default: 1000 entries)."""

    def __init__(self, max_size: int = 1000):
        super().__init__(max_size, ttl_seconds=None)
