"""The hybrid search, exactly and plainly: what every query should get.

For each query, from the benchmark's own inputs (cases, the seeded corpus
rows in bf16 as the configuration stores them, the planted rows, the
query's reference embedding):

* lexical hits at ``exact_weight``: a case whose name's word tokens equal
  the query's (name trie, exact), whose citation's whitespace tokens equal
  the query's (citation trie, exact), or whose opening words hold the
  query's word tokens as a run starting at one of its words (content trie,
  every window start);
* semantic hits: each case's best chunk by cosine (f32 products, no TF32)
  at or above ``min_similarity``;
* both inside the court and date filters; a case once, at its best; the
  top ``max_results`` by score, ties to the lower case row.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from .. import data
from . import exact_f32

_WORD = re.compile(r"\w+")


def word_tokens(text: str) -> list[str]:
    return _WORD.findall(text.lower())


@dataclass
class Expected:
    """One query's reference answer: ``top`` is ``[(case, score, kind)]``
    in rank order (``kind`` ``lexical`` or ``semantic``); ``semantic`` maps
    every case near or above the threshold to ``(best chunk, score,
    score of each chunk)``; ``lexical`` each lexical hit inside the
    filters to its match types."""

    top: list = field(default_factory=list)
    semantic: dict = field(default_factory=dict)
    lexical: dict = field(default_factory=dict)


class Lexical:
    """The three tries' match rules over the cases, by inverting how the
    names, citations and opening words were made."""

    def __init__(self, cases: data.Cases):
        self.cases = cases
        lex = cases.lex
        self.party = {w.lower(): i for i, w in enumerate(lex.party)}
        self.text_word = {w: i for i, w in enumerate(lex.text)}
        P = len(lex.party)
        self.pair_case = np.full(P * P, -1, np.int64)
        self.pair_case[cases.name_pair[:, 0] * P + cases.name_pair[:, 1]] = np.arange(cases.n)
        self.opening = cases.text_words[:, 0, : data.OPENING_WORDS].astype(np.int64)

    def hits(self, text: str) -> dict[int, set[str]]:
        """Case → the match types (``case_name``, ``citation``, ``exact``
        for the content trie) under which ``text`` finds it."""
        out: dict[int, set[str]] = {}
        toks = word_tokens(text)
        if len(toks) == 3 and toks[1] == "v" and toks[0] in self.party and toks[2] in self.party:
            c = int(self.pair_case[self.party[toks[0]] * len(self.party) + self.party[toks[2]]])
            if c >= 0:
                out.setdefault(c, set()).add("case_name")
        raw = text.split()
        if len(raw) == 3 and raw[1] == "U.S." and raw[0].isdigit() and raw[2].isdigit():
            c = (int(raw[0]) - 1) * 997 + int(raw[2]) - 1
            if 0 <= c < self.cases.n and data.citation(c).split() == raw:
                out.setdefault(c, set()).add("citation")
        if toks and all(t in self.text_word for t in toks) and len(toks) <= data.OPENING_WORDS:
            ids = np.asarray([self.text_word[t] for t in toks])
            n, W = len(ids), self.opening.shape[1]
            for s in range(W - n + 1):
                for c in np.nonzero((self.opening[:, s : s + n] == ids).all(axis=1))[0].tolist():
                    out.setdefault(c, set()).add("exact")
        return out


def passes(cases: data.Cases, c: int, court_filter, date_range) -> bool:
    if court_filter and cases.court(c) not in {x.strip() for x in court_filter}:
        return False
    if date_range:
        lo, hi = date_range
        d = cases.date(c)
        if (lo and d < lo) or (hi and d > hi):
            return False
    return True


def semantic_scores(torch, q_emb, corpus: dict, plan, floor: float) -> list[dict]:
    """For each query, ``{row: cosine}`` of every corpus row at or above
    ``floor``: the seeded rows regenerated slab by slab, the planted rows
    over them, each rounded to bf16 as stored, products in f32."""
    P, m, D, seed = corpus["partitions"], corpus["slots"], corpus["dim"], corpus["seed"]
    dev = q_emb.device
    prow = torch.as_tensor(plan.rows, device=dev)
    pvec = plan.vecs.to(torch.bfloat16).float()
    out: list[dict] = [dict() for _ in range(q_emb.shape[0])]
    with exact_f32(torch), torch.no_grad():
        for p0, _c, v in data.corpus_slabs(torch, P, m, D, seed, dev):
            r0 = p0 * m
            rows = v.reshape(-1, D).to(torch.bfloat16).float()
            sel = (prow >= r0) & (prow < r0 + rows.shape[0])
            if bool(sel.any()):
                rows[prow[sel] - r0] = pvec[sel]
            s = q_emb @ rows.T
            qi, ri = torch.nonzero(s >= floor, as_tuple=True)
            vals = s[qi, ri].tolist()
            for a, b, x in zip(qi.tolist(), (ri + r0).tolist(), vals):
                out[a][b] = x
    return out


def expected(queries: list, lexical: Lexical, row_scores: list[dict], chunks: int,
             min_similarity: float, exact_weight: float, near: float) -> list[Expected]:
    """Each query's :class:`Expected`; ``near`` keeps semantic cases down to
    ``min_similarity - near`` for the checks' tolerance."""
    cases = lexical.cases
    out = []
    for q, rs in zip(queries, row_scores):
        e = Expected()
        e.lexical = {c: kinds for c, kinds in lexical.hits(q.text).items()
                     if passes(cases, c, q.court_filter, q.date_range)}
        by_case: dict[int, dict[int, float]] = {}
        for row, s in rs.items():
            by_case.setdefault(row // chunks, {})[row % chunks] = s
        for c, ch in by_case.items():
            j = max(ch, key=lambda k: (ch[k], -k))
            if ch[j] >= min_similarity - near and passes(cases, c, q.court_filter, q.date_range):
                e.semantic[c] = (j, ch[j], ch)
        cand = [(exact_weight, c, "lexical") for c in e.lexical]
        cand += [(s, c, "semantic") for c, (_j, s, _ch) in e.semantic.items()
                 if c not in e.lexical and s >= min_similarity]
        cand.sort(key=lambda t: (-t[0], t[1]))
        e.top = [(c, s, k) for s, c, k in cand[: q.max_results]]
        out.append(e)
    return out


