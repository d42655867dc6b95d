"""Snippet and highlight generation (copy of ``trie_semantic_search_tpu/
search/snippets.py``): a context window around the first query-term hit
with word-boundary highlight spans, anchored on the matched sentence for
semantic-only hits.
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass
from enum import Enum
from typing import Optional, Sequence


class HighlightType(str, Enum):
    """ref: search.rs:96-102."""

    EXACT_MATCH = "exact_match"
    SEMANTIC_MATCH = "semantic_match"
    CASE_NAME = "case_name"
    CITATION = "citation"


@dataclass(slots=True)
class TextHighlight:
    """ref: search.rs:84-93 — span within the snippet."""

    start: int
    end: int
    highlight_type: HighlightType


@functools.lru_cache(maxsize=1024)
def _term_pattern(terms: Sequence[str]) -> Optional[re.Pattern[str]]:
    # cached: one query hydrates up to max_results snippets, each of
    # which needs the same compiled pattern (measured in the round-5
    # serving profile — hydration is the batch bottleneck on the 1-core
    # host). Callers pass a TUPLE (hashable).
    words = [re.escape(t) for t in terms if t]
    if not words:
        return None
    return re.compile(r"\b(" + "|".join(words) + r")\b", re.IGNORECASE)


def generate_snippet(
    text: str,
    query: str,
    window: int = 240,
    highlight_type: HighlightType = HighlightType.EXACT_MATCH,
    chunk_text: Optional[str] = None,
) -> tuple[str, list[TextHighlight]]:
    """Context window around the first query-term hit, with highlight spans
    for every term occurrence inside the window.

    When no term matches (semantic-only hits), anchors on ``chunk_text`` —
    the matched chunk's literal sentence (the caller replays the builder's
    chunking to produce it) — located in ``text`` by a whitespace-tolerant
    search; else falls back to the leading ``window`` characters.
    """
    if not text:
        return "", []
    pattern = _term_pattern(tuple(query.split()))
    anchor = None
    if pattern:
        m = pattern.search(text)
        if m:
            anchor = m.start()

    if anchor is None and chunk_text:
        pos = text.find(chunk_text)
        if pos < 0:
            # stored text has original whitespace; the chunk was extracted
            # from whitespace-collapsed text — search tolerantly
            loose = re.compile(
                r"\s+".join(re.escape(w) for w in chunk_text.split()[:8])
            )
            m2 = loose.search(text)
            pos = m2.start() if m2 else -1
        if pos >= 0:
            anchor = pos

    if anchor is None:
        snippet = text[:window]
        cut = snippet.rfind(" ")
        if 0 < cut < len(snippet) and len(text) > window:
            snippet = snippet[:cut]
        return (snippet + ("..." if len(text) > len(snippet) else ""), [])
    if pattern is None or not pattern.search(text):
        # paragraph-anchored, no term highlights
        start = anchor
        end = min(len(text), start + window)
        sp = text.rfind(" ", start, end)
        if sp > start and end < len(text):
            end = sp
        prefix = "..." if start > 0 else ""
        suffix = "..." if end < len(text) else ""
        return prefix + text[start:end] + suffix, []

    start = max(0, anchor - window // 3)
    end = min(len(text), start + window)
    # align to word boundaries
    if start > 0:
        sp = text.find(" ", start)
        if 0 <= sp < anchor:
            start = sp + 1
    if end < len(text):
        sp = text.rfind(" ", start, end)
        if sp > start:
            end = sp

    prefix = "..." if start > 0 else ""
    suffix = "..." if end < len(text) else ""
    body = text[start:end]
    snippet = prefix + body + suffix

    highlights: list[TextHighlight] = []
    if pattern:
        offset = len(prefix) - start
        for m in pattern.finditer(body):
            highlights.append(
                TextHighlight(
                    start=m.start() + len(prefix),
                    end=m.end() + len(prefix),
                    highlight_type=highlight_type,
                )
            )
    return snippet, highlights
