"""Error types the serving slice raises (copies of the JAX package's
``core/errors.py`` classes of the same names and messages)."""

from __future__ import annotations

from typing import Any, Optional

CATEGORY_INTERNAL = "internal"
CATEGORY_TRIE = "trie"
CATEGORY_VECTOR = "vector"
CATEGORY_INDEX = "index"


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
