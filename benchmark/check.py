"""How ``correct`` is decided: the served answers of a seeded sample of the
window's queries against the plain reference's.

Two numbers are compared, each with its limit from the cell's
configuration file:

* ``score_gap``: the widest gap between a served semantic result's score
  and the reference's cosine of the chunk it served (the chunk its snippet
  names). It holds the encoder, the int8 probe or stream and the bf16
  rescore to the reference's float32.
* ``bad_results``: answers that say the wrong thing, counted (limit 0): a
  query that got no answer or a server error; results out of score order,
  past ``max_results`` or repeating a case; a case whose id, name,
  citation, court or date is not the store's; a lexical result the tries'
  rules do not give, or not at the boost; a lexical hit left out; a
  semantic result outside the filters, below ``min_similarity`` by more
  than the score limit, or whose snippet names no chunk of the case near
  the query. (The snippet's chunk is the one ``score_gap`` scores, so a
  snippet on the wrong chunk shows there.)

``recall_at_10`` is read here too, over the same sample: the share of the
reference's top results that the answer holds."""

from __future__ import annotations

import re
import uuid
from dataclasses import dataclass, field

from . import data

_MARK = re.compile(r"in part (\d+) of case (\d+)\.")
LEXICAL_TYPES = {"case_name", "citation", "exact"}


def _terms(query: str) -> re.Pattern:
    """The snippet's rule: a query word, whole, in any case."""
    words = [re.escape(t) for t in query.split() if t]
    return re.compile(r"\b(" + "|".join(words) + r")\b", re.IGNORECASE)


@dataclass
class Verdict:
    score_gap: float = 0.0
    bad_results: int = 0
    recall: float = 1.0
    queries: int = 0
    results: int = 0
    notes: list = field(default_factory=list)

    def bad(self, what: str) -> None:
        self.bad_results += 1
        if len(self.notes) < 8:
            self.notes.append(what)


def judge(queries: list, answers: dict, expected: dict, cases: data.Cases, near: float,
          min_similarity: float = 0.5, exact_weight: float = 2.0) -> Verdict:
    """``answers``: query index → the served results as ``to_json`` dicts,
    or None where the query got no answer or a server error;
    ``expected``: query index → the reference's ``Expected``. ``near`` is
    the score limit, the room a semantic result has at the threshold and
    between a case's chunks."""
    v = Verdict()
    shares = []
    for i, e in expected.items():
        q, got = queries[i], answers.get(i)
        v.queries += 1
        if got is None:
            v.bad(f"query {i}: no answer")
            shares.append(0.0)
            continue
        v.results += len(got)
        if len(got) > q.max_results:
            v.bad(f"query {i}: {len(got)} results past max_results {q.max_results}")
        scores = [r["score"] for r in got]
        if scores != sorted(scores, reverse=True):
            v.bad(f"query {i}: scores out of order")
        seen = set()
        for r in got:
            md = r["case_metadata"]
            c = uuid.UUID(md["id"]).int - 1
            if not 0 <= c < cases.n or c in seen:
                v.bad(f"query {i}: case {md['id']} unknown or repeated")
                continue
            seen.add(c)
            if (md["name"], md["citation"], md["court"], md["decision_date"]) != (
                    cases.name(c), cases.citation(c), cases.court(c), cases.date(c).isoformat()):
                v.bad(f"query {i}: case {c} hydrated with {md['name']!r}, {md['court']!r}")
            kind = r["match_type"]
            if kind in LEXICAL_TYPES:
                if kind not in e.lexical.get(c, ()) or r["score"] != exact_weight:
                    v.bad(f"query {i}: lexical {kind} hit on case {c} the tries do not give")
                continue
            m = _MARK.search(r.get("snippet") or "")  # the chunk its snippet is on
            sem = e.semantic.get(c)
            if sem is None:
                v.bad(f"query {i}: semantic hit on case {c} outside the filters or far below the threshold")
                continue
            chunk_scores = sem[2]
            if _terms(q.text).search(cases.text(c)):
                # the snippet anchors on the query's word, not on a chunk:
                # the served score has to be one of the case's chunks'
                j = min(chunk_scores, key=lambda k: abs(r["score"] - chunk_scores[k]))
            else:
                j = int(m.group(1)) if m and int(m.group(2)) == c else -1
            if j not in chunk_scores:
                v.bad(f"query {i}: case {c}'s snippet names no chunk near the query")
                continue
            # the approximate stage may find a case by another chunk than
            # its best; the served score must be that chunk's
            v.score_gap = max(v.score_gap, abs(r["score"] - chunk_scores[j]))
            if chunk_scores[j] < min_similarity - near:
                v.bad(f"query {i}: case {c} at {chunk_scores[j]:.4f} below the threshold")
        missing = [c for c in e.lexical if c not in seen]
        if missing and len(e.lexical) <= q.max_results:
            v.bad(f"query {i}: lexical hits {missing[:3]} left out")
        if e.top:
            top = {c for c, _s, _k in e.top}
            shares.append(len(top & seen) / len(top))
    v.recall = sum(shares) / len(shares) if shares else 1.0
    return v


def as_answers(expected: dict, cases: data.Cases) -> dict:
    """The reference's top results as served JSON (for a control computed in
    the program's place): each case hydrated from the cases, its snippet on
    its best chunk."""
    out = {}
    for i, e in expected.items():
        rows = []
        for c, s, kind in e.top:
            if kind == "lexical":
                mt = sorted(e.lexical[c])[0]
                snippet = cases.text(c)
            else:
                mt, snippet = "semantic", "..." + cases.sentence(c, e.semantic[c][0])
            rows.append({"case_metadata": {"id": str(data.case_uuid(c)), "name": cases.name(c),
                                           "citation": cases.citation(c), "court": cases.court(c),
                                           "decision_date": cases.date(c).isoformat()},
                         "score": s, "match_type": mt, "snippet": snippet})
        out[i] = rows
    return out
