"""Data sources: the async interface and the CAP, CourtListener and mock
sources."""

from .base import (
    CasePayload,
    DataSource,
    RateLimiter,
    RateLimits,
    SourceConfig,
    SourceHealth,
    SourceInfo,
    SourceStats,
)
from .cap import CapDataSource
from .courtlistener import CourtListenerDataSource
from .mock import MockDataSource

__all__ = [
    "CapDataSource",
    "CasePayload",
    "CourtListenerDataSource",
    "DataSource",
    "MockDataSource",
    "RateLimiter",
    "RateLimits",
    "SourceConfig",
    "SourceHealth",
    "SourceInfo",
    "SourceStats",
]
