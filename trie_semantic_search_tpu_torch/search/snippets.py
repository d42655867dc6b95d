"""Snippet and highlight generation (port of ``trie_semantic_search_tpu/
search/snippets.py``, with the same output): a context window around the
first query-term hit with word-boundary highlight spans, anchored on the
matched sentence for semantic-only hits. Terms are matched in ASCII text
without a regex, since no two queries share a pattern to cache.
"""

from __future__ import annotations

import functools
import re
import string
from dataclasses import dataclass
from enum import Enum
from typing import Optional

from ..core.metrics import metrics


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


#: ``re``'s ``\w`` over ASCII
_WORD = frozenset(string.ascii_letters + string.digits + "_")


@functools.lru_cache(maxsize=1024)
def _term_pattern(terms: tuple[str, ...]) -> re.Pattern[str]:
    """The terms' regex, for input that is not all ASCII (``_term_spans``);
    cached, since one query hydrates up to ``max_results`` snippets."""
    return re.compile(r"\b(" + "|".join(map(re.escape, terms)) + r")\b", re.IGNORECASE)


@functools.lru_cache(maxsize=1024)
def _ascii_terms(terms: tuple[str, ...]) -> tuple[tuple[str, ...], tuple[tuple[bool, bool], ...]]:
    """Each distinct ASCII term lowercased, in query order, and whether its
    first and its last character is a word character. A later term equal
    to an earlier one under case folding never wins a match."""
    words = tuple(dict.fromkeys(t.lower() for t in terms))
    return words, tuple((t[0] in _WORD, t[-1] in _WORD) for t in words)


def _ascii_spans(low: str, terms: tuple[tuple[str, ...], tuple[tuple[bool, bool], ...]],
                 first: bool) -> list[tuple[int, int]]:
    """The spans of ``re.finditer`` (``first``: of ``re.search``) for
    ``\\b(t1|...|tn)\\b`` under ``re.IGNORECASE`` over lowercased ASCII
    ``low``, with no pattern compiled. A term matches at ``p`` when the
    character before ``p`` (none at 0) is a word character unlike the
    term's first, and the one after its end unlike its last; the leftmost
    start wins, then the term first in query order; matches do not overlap."""
    words, bounds = terms
    if not any(map(low.__contains__, words)):  # most texts: no term at all
        return []
    n = len(low)
    found: list[tuple[int, int, int]] = []  # (start, rank, end)
    for rank, (t, (w0, w1)) in enumerate(zip(words, bounds)):
        m = len(t)
        p = low.find(t)
        while p >= 0:
            q = p + m
            if (p > 0 and low[p - 1] in _WORD) != w0 and (q < n and low[q] in _WORD) != w1:
                found.append((p, rank, q))
                if first:
                    break
            p = low.find(t, p + 1)
    if first:
        if not found:
            return []
        p, _, q = min(found)
        return [(p, q)]
    spans: list[tuple[int, int]] = []
    pos = 0
    for p, _, q in sorted(found):
        if p >= pos:
            spans.append((p, q))
            pos = q
    return spans


def _term_spans(s: str, terms: tuple[str, ...], ascii_: bool, first: bool) -> list[tuple[int, int]]:
    """Word-bounded, case-insensitive spans of ``terms`` in ``s``.
    ``re``'s case folding maps some non-ASCII letters to ASCII ones (``ſ``
    to ``s``, the Kelvin sign to ``k``), which ``str.lower`` does not, so
    input that is not all ASCII takes the cached regex."""
    if ascii_:
        return _ascii_spans(s.lower(), _ascii_terms(terms), first)
    pattern = _term_pattern(terms)
    if first:
        m = pattern.search(s)
        return [m.span()] if m else []
    return [m.span() for m in pattern.finditer(s)]


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
    terms = tuple(query.split())
    ascii_ = text.isascii() and query.isascii()
    hit = None
    if terms:
        metrics.inc("snippet.terms_fast" if ascii_ else "snippet.terms_regex")
        spans = _term_spans(text, terms, ascii_, first=True)
        if spans:
            hit = spans[0][0]
    anchor = hit

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
    if hit is None:
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

    # the body is searched as a string of its own: its edges are boundaries
    highlights = [
        TextHighlight(start=s + len(prefix), end=e + len(prefix), highlight_type=highlight_type)
        for s, e in _term_spans(body, terms, ascii_, first=False)
    ]
    return snippet, highlights
