"""Error types the port raises (copies of the JAX package's
``core/errors.py`` classes of the same names, fields and messages)."""

from __future__ import annotations

from typing import Any, Optional

CATEGORY_NETWORK = "network"
CATEGORY_INGESTION = "ingestion"
CATEGORY_CONFIG = "config"
CATEGORY_INTERNAL = "internal"
CATEGORY_VALIDATION = "validation"
CATEGORY_TRIE = "trie"
CATEGORY_VECTOR = "vector"
CATEGORY_STORAGE = "storage"
CATEGORY_INDEX = "index"
CATEGORY_SEARCH = "search"


class SearchError(Exception):
    """Base error: a message plus structured fields."""

    category: str = CATEGORY_INTERNAL
    recoverable: bool = False
    suggestion: Optional[str] = None

    def __init__(self, message: str = "", **fields: Any):
        self.fields = fields
        super().__init__(message or self.__class__.__name__)

    @property
    def message(self) -> str:
        return str(self)

    def is_recoverable(self) -> bool:
        """Whether a retry may succeed (the ingest pipeline's retry loop
        reads it)."""
        return self.recoverable

    def recovery_suggestion(self) -> Optional[str]:
        return self.suggestion

    def to_json(self) -> dict[str, Any]:
        return {
            "error": self.__class__.__name__,
            "message": self.message,
            "category": self.category,
            "recoverable": self.recoverable,
            "suggestion": self.recovery_suggestion(),
            **{k: v for k, v in self.fields.items() if _jsonable(v)},
        }


def _jsonable(v: Any) -> bool:
    return isinstance(v, (str, int, float, bool, type(None), list, dict))


class NetworkError(SearchError):
    """Network-related error."""

    category = CATEGORY_NETWORK
    recoverable = True
    suggestion = "Check network connectivity; the operation will be retried"

    def __init__(self, details: str = "", **kw: Any):
        super().__init__(f"Network error: {details}", details=details, **kw)


class RateLimitExceeded(SearchError):
    """Upstream source rate limit hit."""

    category = CATEGORY_NETWORK
    recoverable = True
    suggestion = "Back off and retry after the rate-limit window"

    def __init__(self, source: str = "", **kw: Any):
        super().__init__(f"Rate limit exceeded for {source}", source=source, **kw)


class SourceUnavailable(SearchError):
    """Data source down or not registered."""

    category = CATEGORY_NETWORK
    recoverable = True
    suggestion = "Retry later or switch to an alternate data source"

    def __init__(self, source: str = "", details: str = "", **kw: Any):
        super().__init__(
            f"Data source '{source}' is unavailable: {details}",
            source=source,
            details=details,
            **kw,
        )


class ParseError(SearchError):
    """Failed to parse upstream data."""

    category = CATEGORY_INGESTION

    def __init__(self, source: str = "", details: str = "", **kw: Any):
        super().__init__(
            f"Failed to parse data from {source}: {details}",
            source=source,
            details=details,
            **kw,
        )


class ConfigError(SearchError):
    """Configuration error."""

    category = CATEGORY_CONFIG
    suggestion = "Fix the configuration file or environment overrides"


class SerializationFailed(SearchError):
    """Serialization failure (``{data_type, reason}`` or a message)."""

    category = CATEGORY_STORAGE

    def __init__(self, message: str = "", data_type: str = "", reason: str = "", **kw: Any):
        if not message and (data_type or reason):
            message = f"Serialization failed for {data_type}: {reason}"
        super().__init__(
            f"Serialization failed: {message}" if not message.startswith("Serialization") else message,
            data_type=data_type,
            reason=reason,
            **kw,
        )


class ValidationFailed(SearchError):
    """Field validation failure."""

    category = CATEGORY_VALIDATION

    def __init__(self, field: str = "", reason: str = "", **kw: Any):
        super().__init__(
            f"Validation failed for field '{field}': {reason}",
            field=field,
            reason=reason,
            **kw,
        )


class DatabaseError(SearchError):
    """Embedded database (sqlite) error."""

    category = CATEGORY_STORAGE
    recoverable = True
    suggestion = "Check database file integrity and available disk space"


class AutomatonCompilationFailed(SearchError):
    """Trie freeze failure."""

    category = CATEGORY_TRIE

    def __init__(self, reason: str = "", **kw: Any):
        super().__init__(
            f"Automaton compilation failed: {reason}", reason=reason, **kw
        )


class EmbeddingGenerationFailed(SearchError):
    category = CATEGORY_VECTOR

    def __init__(self, text_preview: str = "", reason: str = "", **kw: Any):
        super().__init__(
            f"Embedding generation failed: {text_preview} - {reason}",
            text_preview=text_preview,
            reason=reason,
            **kw,
        )


class VectorIndexConstructionFailed(SearchError):
    category = CATEGORY_VECTOR

    def __init__(self, reason: str = "", **kw: Any):
        super().__init__(
            f"Vector index construction failed: {reason}", reason=reason, **kw
        )


class AnnSearchError(SearchError):
    category = CATEGORY_VECTOR

    def __init__(self, details: str = "", **kw: Any):
        super().__init__(f"ANN search error: {details}", details=details, **kw)


class IndexCorrupted(SearchError):
    category = CATEGORY_INDEX
    suggestion = "Rebuild the index from storage"

    def __init__(self, index_type: str = "", details: str = "", **kw: Any):
        super().__init__(
            f"Index corrupted: {index_type} - {details}",
            index_type=index_type,
            details=details,
            **kw,
        )


class DatabaseConnectionFailed(SearchError):
    category = CATEGORY_STORAGE
    recoverable = True
    suggestion = "Check the database path and file permissions"

    def __init__(self, db_path: str = "", reason: str = "", **kw: Any):
        super().__init__(
            f"Database connection failed: {db_path} - {reason}",
            db_path=db_path,
            reason=reason,
            **kw,
        )


class StorageCorruption(SearchError):
    category = CATEGORY_STORAGE
    suggestion = "Restore from the most recent backup"

    def __init__(self, location: str = "", details: str = "", **kw: Any):
        super().__init__(
            f"Storage corruption detected: {location} - {details}",
            location=location,
            details=details,
            **kw,
        )


class InvalidSearchQuery(SearchError):
    category = CATEGORY_SEARCH

    def __init__(self, query: str = "", reason: str = "", **kw: Any):
        super().__init__(
            f"Invalid search query: {query} - {reason}", query=query, reason=reason, **kw
        )
