"""Minimal GraphQL executor for the one query field the API declares (port
of ``trie_semantic_search_tpu/api/graphql.py``; no GraphQL library)::

    query {
      search(query: "freedom of press", court: "SCOTUS", limit: 5) {
        caseName
        citation
        score
        snippet
      }
    }

A hand-written tokenizer and parser take the subset that schema needs: one
``search`` field, scalar arguments (inline literals or ``$variables``) and
a scalar selection set. Anything else raises :class:`GraphQLError` with a
clear message.

Supported surface:
  * optional ``query`` keyword + operation name + variable definitions
  * ``search(query: String!, court: String, limit: Int, dateFrom: String,
    dateTo: String)``
  * selection fields: ``caseName citation score snippet decisionDate
    matchType court`` (+ aliases via ``alias: field``)
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Awaitable, Callable, Optional

from ..search.engine import SearchQuery, SearchResult


class GraphQLError(ValueError):
    """Malformed or unsupported GraphQL document."""


_TOKEN = re.compile(
    r"""
    \s+|\#[^\n]*            # whitespace + comments (skipped)
    |(?P<str>"(?:\\.|[^"\\])*")
    |(?P<num>-?\d+(?:\.\d+)?)
    |(?P<name>[_A-Za-z][_0-9A-Za-z]*)
    |(?P<var>\$[_A-Za-z][_0-9A-Za-z]*)
    |(?P<punct>[{}():,!\[\]])
    """,
    re.VERBOSE,
)

#: selection field → extractor over a SearchResult
_FIELDS: dict[str, Callable[[SearchResult], object]] = {
    "caseName": lambda r: r.case_metadata.name,
    "citation": lambda r: r.case_metadata.citation,
    "score": lambda r: r.score,
    "snippet": lambda r: r.snippet,
    "decisionDate": lambda r: r.case_metadata.decision_date.isoformat(),
    "matchType": lambda r: r.match_type.value,
    "court": lambda r: r.case_metadata.court,
}


def _tokenize(doc: str) -> list[str]:
    out: list[str] = []
    pos = 0
    while pos < len(doc):
        m = _TOKEN.match(doc, pos)
        if m is None:
            raise GraphQLError(f"unexpected character at offset {pos}: {doc[pos]!r}")
        pos = m.end()
        for group in ("str", "num", "name", "var", "punct"):
            if m.group(group) is not None:
                out.append(m.group(group))
                break
    return out


class _Parser:
    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise GraphQLError("unexpected end of document")
        self.i += 1
        return self.toks[self.i - 1]

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise GraphQLError(f"expected {tok!r}, got {got!r}")


def _parse_value(p: _Parser, variables: dict) -> object:
    tok = p.next()
    if tok.startswith('"'):
        return tok[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    if tok.startswith("$"):
        name = tok[1:]
        if name not in variables:
            raise GraphQLError(f"variable ${name} not provided")
        return variables[name]
    if re.fullmatch(r"-?\d+", tok):
        return int(tok)
    if re.fullmatch(r"-?\d+\.\d+", tok):
        return float(tok)
    if tok in ("true", "false"):
        return tok == "true"
    if tok == "null":
        return None
    raise GraphQLError(f"unsupported value token {tok!r}")


def _skip_variable_definitions(p: _Parser) -> None:
    """Consume ``($x: String!, ...)`` after an operation name."""
    p.expect("(")
    depth = 1
    while depth:
        tok = p.next()
        if tok == "(":
            depth += 1
        elif tok == ")":
            depth -= 1


def parse_search_document(
    doc: str, variables: dict
) -> tuple[dict, list[tuple[str, str]]]:
    """Parse the supported document shape. Returns
    ``(search_args, [(output_key, field_name), ...])``."""
    p = _Parser(_tokenize(doc))
    if p.peek() == "query":
        p.next()
        if p.peek() not in ("{", "("):  # operation name
            p.next()
        if p.peek() == "(":
            _skip_variable_definitions(p)
    elif p.peek() in ("mutation", "subscription"):
        raise GraphQLError(f"unsupported operation type {p.peek()!r}")
    p.expect("{")
    field = p.next()
    if field != "search":
        raise GraphQLError(
            f"unsupported root field {field!r} (schema has: search)"
        )
    args: dict = {}
    if p.peek() == "(":
        p.next()
        while p.peek() != ")":
            name = p.next()
            p.expect(":")
            args[name] = _parse_value(p, variables)
            if p.peek() == ",":
                p.next()
        p.expect(")")
    p.expect("{")
    selections: list[tuple[str, str]] = []
    while p.peek() != "}":
        name = p.next()
        if p.peek() == ":":  # alias: field
            p.next()
            field_name = p.next()
            selections.append((name, field_name))
        else:
            selections.append((name, name))
        if p.peek() == ",":
            p.next()
    p.expect("}")  # close selection set
    p.expect("}")  # close query
    if p.peek() is not None:
        raise GraphQLError(f"unexpected trailing token {p.peek()!r}")
    if not selections:
        raise GraphQLError("empty selection set")
    for _key, fname in selections:
        if fname not in _FIELDS:
            raise GraphQLError(
                f"unknown field {fname!r} (known: {', '.join(sorted(_FIELDS))})"
            )
    return args, selections


async def execute_search_query(
    doc: str,
    variables: dict,
    run: Callable[[SearchQuery], Awaitable[list[SearchResult]]],
) -> dict:
    """Parse + execute the document against the engine runner. Returns the
    ``data`` payload (``{"search": [...]}``)."""
    args, selections = parse_search_document(doc, variables or {})
    if "query" not in args or not isinstance(args["query"], str):
        raise GraphQLError("search requires a String 'query' argument")
    allowed = {"query", "court", "limit", "dateFrom", "dateTo"}
    unknown = set(args) - allowed
    if unknown:
        raise GraphQLError(
            f"unknown argument(s) {sorted(unknown)} (known: {sorted(allowed)})"
        )
    date_range = None
    if args.get("dateFrom") or args.get("dateTo"):
        def _d(v):
            return _dt.date.fromisoformat(str(v)[:10]) if v else None

        try:
            date_range = (_d(args.get("dateFrom")), _d(args.get("dateTo")))
        except ValueError as e:
            raise GraphQLError(f"bad date: {e}") from e
    court = args.get("court")
    q = SearchQuery(
        query=args["query"],
        max_results=int(args["limit"]) if args.get("limit") is not None else None,
        court_filter=[str(court)] if court else None,
        date_range=date_range,
    )
    results = await run(q)
    return {
        "search": [
            {key: _FIELDS[fname](r) for key, fname in selections}
            for r in results
        ]
    }
