"""Ingestion: sources, validation, cache, pipeline, manager (host code; no
device)."""

from .cache import CacheManager, IngestCacheStats, content_key
from .manager import (
    IngestionJob,
    IngestionJobType,
    IngestionManager,
    IngestionStats,
    JobStatus,
)
from .pipeline import IngestionPipeline, MemoryStats, PipelineStats, make_pipeline
from .validation import (
    CaseValidator,
    ValidationIssue,
    ValidationResult,
    ValidationRule,
    ValidationSeverity,
)

__all__ = [
    "CacheManager",
    "CaseValidator",
    "IngestCacheStats",
    "IngestionJob",
    "IngestionJobType",
    "IngestionManager",
    "IngestionPipeline",
    "IngestionStats",
    "JobStatus",
    "MemoryStats",
    "PipelineStats",
    "ValidationIssue",
    "ValidationResult",
    "ValidationRule",
    "ValidationSeverity",
    "content_key",
    "make_pipeline",
]
