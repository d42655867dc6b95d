"""Search engine, fused hybrid search, snippets and host caches.

``engine`` and ``fused`` import lazily (PEP 562): they depend on
:mod:`..index`, whose ``vector`` module imports :mod:`.cache` from this
package, so an eager import here would close an import cycle.
"""

from .cache import CacheStats, QueryCache, VectorCache
from .snippets import HighlightType, TextHighlight, generate_snippet

__all__ = [
    "CacheStats",
    "FusedHybridSearch",
    "HighlightType",
    "MatchType",
    "QueryCache",
    "SearchEngine",
    "SearchEngineStats",
    "SearchQuery",
    "SearchResult",
    "TextHighlight",
    "VectorCache",
    "generate_snippet",
]

_ENGINE_NAMES = {
    "MatchType",
    "SearchEngine",
    "SearchEngineStats",
    "SearchQuery",
    "SearchResult",
}


def __getattr__(name: str):
    if name in _ENGINE_NAMES:
        from . import engine

        return getattr(engine, name)
    if name == "FusedHybridSearch":
        from .fused import FusedHybridSearch

        return FusedHybridSearch
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
