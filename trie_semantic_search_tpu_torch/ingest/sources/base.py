"""Data-source interface and shared source infrastructure (copy of
``trie_semantic_search_tpu/ingest/sources/base.py``): the async
``DataSource`` (bulk ``fetch_cases`` as the pipeline drives it, single-case
``fetch_case`` and id listings as the incremental run does), its health,
info, rate limits and stats, and a min-interval rate limiter.
"""

from __future__ import annotations

import abc
import asyncio
import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Optional

from ...core.types import CaseMetadata

CasePayload = tuple[CaseMetadata, str]  # (metadata, full_text)


@dataclass
class SourceHealth:
    healthy: bool
    message: str = ""
    last_check: Optional[datetime] = None
    response_time_ms: Optional[float] = None


@dataclass
class SourceInfo:
    name: str
    description: str
    base_url: str = ""
    requires_auth: bool = False
    supports_incremental: bool = True


@dataclass
class RateLimits:
    requests_per_minute: int = 60
    requests_per_hour: int = 3600
    concurrent_requests: int = 5


@dataclass
class SourceStats:
    cases_fetched: int = 0
    requests_made: int = 0
    errors: int = 0
    rate_limit_hits: int = 0
    bytes_downloaded: int = 0
    last_fetch: Optional[datetime] = None


@dataclass
class SourceConfig:
    """Free-form per-source settings."""

    name: str = ""
    enabled: bool = True
    settings: dict[str, Any] = field(default_factory=dict)


class RateLimiter:
    """Keeps at least ``60 / requests_per_minute`` seconds between
    requests."""

    def __init__(self, requests_per_minute: int = 60):
        self.min_interval = 60.0 / max(1, requests_per_minute)
        self._last = 0.0
        self._lock = asyncio.Lock()

    async def acquire(self) -> None:
        async with self._lock:
            now = time.monotonic()
            wait = self.min_interval - (now - self._last)
            if wait > 0:
                await asyncio.sleep(wait)
            self._last = time.monotonic()


class DataSource(abc.ABC):
    """Async data-source interface."""

    def __init__(self) -> None:
        self.stats = SourceStats()

    # -- identity -----------------------------------------------------------

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @property
    def description(self) -> str:
        return self.get_source_info().description

    @abc.abstractmethod
    def get_source_info(self) -> SourceInfo: ...

    def get_rate_limits(self) -> RateLimits:
        return RateLimits()

    def get_source_config(self) -> SourceConfig:
        return SourceConfig(name=self.name)

    def get_stats(self) -> SourceStats:
        return self.stats

    # -- health -------------------------------------------------------------

    @abc.abstractmethod
    async def health_check(self) -> SourceHealth: ...

    # -- fetching -----------------------------------------------------------

    @abc.abstractmethod
    async def fetch_cases(self, limit: Optional[int] = None) -> list[CasePayload]:
        """Bulk fetch (the shape the pipeline drives)."""

    async def fetch_case(self, case_id: str) -> Optional[CasePayload]:
        """Single-case fetch by source-native id."""
        return None

    async def list_available_cases(self, limit: Optional[int] = None) -> list[str]:
        """Source-native ids available for fetch."""
        return []

    async def list_updated_cases(self, since: datetime, limit: Optional[int] = None) -> list[str]:
        """Ids updated after ``since`` (the incremental ingest watermark)."""
        return []

    async def search_cases(self, query: str, limit: Optional[int] = None) -> list[str]:
        """Source-side search returning source-native ids."""
        return []
