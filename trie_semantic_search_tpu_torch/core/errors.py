"""Error taxonomy (copy of the JAX package's ``core/errors.py``).

The reference's error enum (``errors.rs``) as an exception hierarchy: every
variant a subclass of :class:`SearchError` with the same structured fields
and message, and the classification surface as ``category``,
``is_recoverable`` and ``recovery_suggestion``; ``to_json`` gives the same
dict as the JAX class of the same name. ``XlaRuntimeError`` (and its alias
``OnnxRuntimeError``) has no counterpart: it wraps JAX/XLA runtime
failures, and this package runs none.
"""

from __future__ import annotations

from typing import Any, Optional

# ---------------------------------------------------------------------------
# Categories (ref: errors.rs:235-273 — used for metrics bucketing)
# ---------------------------------------------------------------------------

CATEGORY_IO = "io"
CATEGORY_NETWORK = "network"
CATEGORY_INGESTION = "ingestion"
CATEGORY_CONFIG = "config"
CATEGORY_INTERNAL = "internal"
CATEGORY_VALIDATION = "validation"
CATEGORY_TEXT = "text_processing"
CATEGORY_TRIE = "trie"
CATEGORY_VECTOR = "vector"
CATEGORY_STORAGE = "storage"
CATEGORY_INDEX = "index"
CATEGORY_SEARCH = "search"
CATEGORY_API = "api"
CATEGORY_RESOURCE = "resource"


class SearchError(Exception):
    """Base error for every subsystem (ref: ``errors.rs:40``).

    Attributes:
        category: metrics bucket (ref ``category()``, ``errors.rs:235-273``).
        recoverable: whether a retry may succeed (ref ``is_recoverable()``,
            ``errors.rs:222-232``).
    """

    category: str = CATEGORY_INTERNAL
    recoverable: bool = False
    #: Default operator hint (ref ``recovery_suggestion()``, errors.rs:276-286)
    suggestion: Optional[str] = None

    def __init__(self, message: str = "", **fields: Any):
        self.fields = fields
        super().__init__(message or self.__class__.__name__)

    @property
    def message(self) -> str:
        return str(self)

    def is_recoverable(self) -> bool:
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


# ---------------------------------------------------------------------------
# Generic / infrastructure errors
# ---------------------------------------------------------------------------


class IoError(SearchError):
    """I/O error (ref: errors.rs:43)."""

    category = CATEGORY_IO
    recoverable = True
    suggestion = "Check file permissions and disk space"


class NetworkError(SearchError):
    """Network-related error (ref: errors.rs:47)."""

    category = CATEGORY_NETWORK
    recoverable = True
    suggestion = "Check network connectivity; the operation will be retried"

    def __init__(self, details: str = "", **kw: Any):
        super().__init__(f"Network error: {details}", details=details, **kw)


class RateLimitExceeded(SearchError):
    """Upstream source rate limit hit (ref: errors.rs:51)."""

    category = CATEGORY_NETWORK
    recoverable = True
    suggestion = "Back off and retry after the rate-limit window"

    def __init__(self, source: str = "", **kw: Any):
        super().__init__(f"Rate limit exceeded for {source}", source=source, **kw)


class SourceUnavailable(SearchError):
    """Data source down (ref: errors.rs:58)."""

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
    """Failed to parse upstream data (ref: errors.rs:62)."""

    category = CATEGORY_INGESTION

    def __init__(self, source: str = "", details: str = "", **kw: Any):
        super().__init__(
            f"Failed to parse data from {source}: {details}",
            source=source,
            details=details,
            **kw,
        )


class ConfigError(SearchError):
    """Configuration error (ref: errors.rs:66)."""

    category = CATEGORY_CONFIG
    suggestion = "Fix the configuration file or environment overrides"


class InternalError(SearchError):
    """Internal invariant violation (ref: errors.rs:70)."""

    category = CATEGORY_INTERNAL


class SerializationFailed(SearchError):
    """Serialization failure (ref: errors.rs:74; the reference also mis-uses
    ``{data_type, reason}`` at storage.rs:104-107 — both shapes accepted)."""

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
    """Field validation failure (ref: errors.rs:78)."""

    category = CATEGORY_VALIDATION

    def __init__(self, field: str = "", reason: str = "", **kw: Any):
        super().__init__(
            f"Validation failed for field '{field}': {reason}",
            field=field,
            reason=reason,
            **kw,
        )


class UnsupportedOperation(SearchError):
    """Unsupported operation (ref: errors.rs:82)."""

    category = CATEGORY_INTERNAL

    def __init__(self, operation: str = "", **kw: Any):
        super().__init__(f"Operation '{operation}' is not supported", operation=operation, **kw)


class DatabaseError(SearchError):
    """Embedded DB error (ref: errors.rs:86 — sled; here sqlite)."""

    category = CATEGORY_STORAGE
    recoverable = True
    suggestion = "Check database file integrity and available disk space"


# ---------------------------------------------------------------------------
# Ingestion errors (ref: errors.rs:110-117)
# ---------------------------------------------------------------------------


class InvalidCaseFormat(SearchError):
    category = CATEGORY_INGESTION

    def __init__(self, file: str = "", details: str = "", **kw: Any):
        super().__init__(
            f"Invalid case format in {file}: {details}", file=file, details=details, **kw
        )


class IngestionNetworkError(SearchError):
    category = CATEGORY_INGESTION
    recoverable = True
    suggestion = "Retried automatically per ingestion.retry_attempts"

    def __init__(self, details: str = "", **kw: Any):
        super().__init__(f"Network error during ingestion: {details}", details=details, **kw)


# ---------------------------------------------------------------------------
# Text processing errors (ref: errors.rs:117-126)
# ---------------------------------------------------------------------------


class TokenizationFailed(SearchError):
    category = CATEGORY_TEXT

    def __init__(self, text_preview: str = "", reason: str = "", **kw: Any):
        super().__init__(
            f"Tokenization failed: {text_preview} - {reason}",
            text_preview=text_preview,
            reason=reason,
            **kw,
        )


class TextNormalizationError(SearchError):
    category = CATEGORY_TEXT

    def __init__(self, details: str = "", **kw: Any):
        super().__init__(f"Text normalization error: {details}", details=details, **kw)


class UnsupportedEncoding(SearchError):
    category = CATEGORY_TEXT

    def __init__(self, encoding: str = "", **kw: Any):
        super().__init__(f"Unsupported text encoding: {encoding}", encoding=encoding, **kw)


# ---------------------------------------------------------------------------
# Trie errors (ref: errors.rs:130-136)
# ---------------------------------------------------------------------------


class TrieConstructionFailed(SearchError):
    category = CATEGORY_TRIE

    def __init__(self, reason: str = "", **kw: Any):
        super().__init__(f"Trie construction failed: {reason}", reason=reason, **kw)


class TrieLookupError(SearchError):
    category = CATEGORY_TRIE

    def __init__(self, query: str = "", details: str = "", **kw: Any):
        super().__init__(
            f"Trie lookup error: {query} - {details}", query=query, details=details, **kw
        )


class AutomatonCompilationFailed(SearchError):
    """Array-automaton freeze failure — the analogue of the reference's
    FST compilation error (ref: errors.rs:136)."""

    category = CATEGORY_TRIE

    def __init__(self, reason: str = "", **kw: Any):
        super().__init__(f"Automaton compilation failed: {reason}", reason=reason, **kw)


# Back-compat alias matching the reference variant name.
FstCompilationFailed = AutomatonCompilationFailed


# ---------------------------------------------------------------------------
# Vector / embedding errors (ref: errors.rs:140-155)
# ---------------------------------------------------------------------------


class EmbeddingModelNotFound(SearchError):
    category = CATEGORY_VECTOR
    suggestion = "Check vector.model.model_path, or run with randomly initialised weights"

    def __init__(self, model_path: str = "", **kw: Any):
        super().__init__(f"Embedding model not found: {model_path}", model_path=model_path, **kw)


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
        super().__init__(f"Vector index construction failed: {reason}", reason=reason, **kw)


class AnnSearchError(SearchError):
    """Partitioned-ANN search error — analogue of the reference's HNSW search
    error (ref: errors.rs:152)."""

    category = CATEGORY_VECTOR

    def __init__(self, details: str = "", **kw: Any):
        super().__init__(f"ANN search error: {details}", details=details, **kw)


HnswSearchError = AnnSearchError


# ---------------------------------------------------------------------------
# Storage errors (ref: errors.rs:159-168)
# ---------------------------------------------------------------------------


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


class InsufficientDiskSpace(SearchError):
    category = CATEGORY_RESOURCE
    suggestion = "Free disk space or raise storage.max_db_size_gb"

    def __init__(self, required_gb: float = 0, available_gb: float = 0, **kw: Any):
        super().__init__(
            f"Insufficient disk space: required {required_gb}GB, available {available_gb}GB",
            required_gb=required_gb,
            available_gb=available_gb,
            **kw,
        )


# ---------------------------------------------------------------------------
# Index errors (ref: errors.rs:172-178)
# ---------------------------------------------------------------------------


class IndexNotFound(SearchError):
    category = CATEGORY_INDEX
    suggestion = "Run `build-index` to (re)create index artifacts"

    def __init__(self, index_name: str = "", **kw: Any):
        super().__init__(f"Index not found: {index_name}", index_name=index_name, **kw)


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


# ---------------------------------------------------------------------------
# Search errors (ref: errors.rs:181-190)
# ---------------------------------------------------------------------------


class SearchTimeout(SearchError):
    category = CATEGORY_SEARCH
    recoverable = True
    suggestion = "Narrow the query or raise search.search_timeout_ms"

    def __init__(self, timeout_ms: int = 0, **kw: Any):
        super().__init__(
            f"Search timeout: query took longer than {timeout_ms}ms",
            timeout_ms=timeout_ms,
            **kw,
        )


class InvalidSearchQuery(SearchError):
    category = CATEGORY_SEARCH

    def __init__(self, query: str = "", reason: str = "", **kw: Any):
        super().__init__(
            f"Invalid search query: {query} - {reason}", query=query, reason=reason, **kw
        )


class SearchCapacityExceeded(SearchError):
    category = CATEGORY_SEARCH
    recoverable = True
    suggestion = "Retry with backoff; consider adding chips to the mesh"

    def __init__(self, current_load: float = 0, details: str = "", **kw: Any):
        super().__init__(
            f"Search capacity exceeded: {current_load}% - {details}",
            current_load=current_load,
            details=details,
            **kw,
        )


# ---------------------------------------------------------------------------
# API errors (ref: errors.rs:194-204)
# ---------------------------------------------------------------------------


class InvalidApiRequest(SearchError):
    category = CATEGORY_API

    def __init__(self, details: str = "", **kw: Any):
        super().__init__(f"Invalid API request: {details}", details=details, **kw)


class AuthenticationFailed(SearchError):
    category = CATEGORY_API
    suggestion = "Provide a valid API key (server.api_key)"

    def __init__(self, reason: str = "", **kw: Any):
        super().__init__(f"Authentication failed: {reason}", reason=reason, **kw)


class ApiRateLimitExceeded(SearchError):
    category = CATEGORY_API
    recoverable = True
    suggestion = "Slow down client request rate"

    def __init__(self, requests_per_minute: int = 0, **kw: Any):
        super().__init__(
            f"Rate limit exceeded: {requests_per_minute} RPM exceeded",
            requests_per_minute=requests_per_minute,
            **kw,
        )


class PayloadTooLarge(SearchError):
    category = CATEGORY_API

    def __init__(self, size_mb: float = 0, limit_mb: float = 0, **kw: Any):
        super().__init__(
            f"Request payload too large: {size_mb}MB exceeds limit of {limit_mb}MB",
            size_mb=size_mb,
            limit_mb=limit_mb,
            **kw,
        )


# ---------------------------------------------------------------------------
# Resource errors (ref: errors.rs:207-218)
# ---------------------------------------------------------------------------


class MemoryAllocationFailed(SearchError):
    category = CATEGORY_RESOURCE
    recoverable = True
    suggestion = "Reduce batch size or enable cache purging"

    def __init__(self, requested_mb: float = 0, **kw: Any):
        super().__init__(
            f"Memory allocation failed: {requested_mb}MB", requested_mb=requested_mb, **kw
        )


class ThreadPoolExhausted(SearchError):
    category = CATEGORY_RESOURCE
    recoverable = True

    def __init__(self, active_threads: int = 0, max_threads: int = 0, **kw: Any):
        super().__init__(
            f"Thread pool exhausted: {active_threads}/{max_threads}",
            active_threads=active_threads,
            max_threads=max_threads,
            **kw,
        )


class ResourceUnavailable(SearchError):
    category = CATEGORY_RESOURCE
    recoverable = True

    def __init__(self, resource: str = "", reason: str = "", **kw: Any):
        super().__init__(
            f"System resource unavailable: {resource} - {reason}",
            resource=resource,
            reason=reason,
            **kw,
        )


# ---------------------------------------------------------------------------
# Helpers mirroring the reference macros (ref: errors.rs:323-345)
# ---------------------------------------------------------------------------


def internal_error(fmt: str, *args: Any) -> InternalError:
    """Analogue of the ``internal_error!`` macro (ref: errors.rs:323-331)."""
    return InternalError(fmt.format(*args) if args else fmt)


def validation_error(field: str, fmt: str, *args: Any) -> ValidationFailed:
    """Analogue of the ``validation_error!`` macro (ref: errors.rs:334-345)."""
    return ValidationFailed(field=field, reason=fmt.format(*args) if args else fmt)


#: All error classes, for introspection / tests.
ALL_ERRORS: tuple[type[SearchError], ...] = tuple(
    cls
    for cls in list(globals().values())
    if isinstance(cls, type) and issubclass(cls, SearchError) and cls is not SearchError
)
