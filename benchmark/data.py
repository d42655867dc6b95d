"""The benchmark's inputs, made from the seed: words, the WordPiece
vocabulary, the cases (names, citations, courts, dates, texts, opening
words), the seeded corpus rows laid out partition-major, and the queries
of a traffic mix.

Everything here is the benchmark's own and frozen: the program under test
receives what these functions make, and the plain reference recomputes
from the same functions, never from the program's state. The corpus
generator (:func:`corpus_slabs`, :func:`make_layout`) is copied from the
repository's chip smoke script so that the yardstick cannot move with it.
"""

from __future__ import annotations

import datetime as dt
import uuid
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

#: courts of the deployment: id 0 is "no court", then fifteen named ones
COURTS = ["", *[f"Court {i}" for i in range(15)]]
EPOCH = dt.date(1970, 1, 1)
#: BERT's special tokens, in the order of a published vocab file
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
#: tokens of the case texts and citations besides the words
FIXED_TOKENS = ["v", "u", "s", "in", "part", "of", "case", ".", ",", ":", "(", ")"]


# ---------------------------------------------------------------------------
# words and vocabulary (fixed: the same for every seed)
# ---------------------------------------------------------------------------


def _pseudo_words(n: int, rng: np.random.Generator) -> list[str]:
    """``n`` distinct pronounceable lowercase words of 2-4 syllables."""
    cons, vows = "bcdfghjklmnprstvz", "aeiou"
    syl = np.array([c + v for c in cons for v in vows] + [c + v + "n" for c in cons for v in vows])
    out: dict[str, None] = {}
    while len(out) < n:
        k = rng.integers(2, 5, 4 * n)
        picks = rng.integers(0, len(syl), (4 * n, 4))
        for kk, row in zip(k, picks):
            out.setdefault("".join(syl[row[:kk]]), None)
            if len(out) == n:
                break
    return list(out)


@dataclass(frozen=True)
class Lexicon:
    """Three disjoint word lists: query phrases, case texts, party names.
    A case text shares no word with any query, so a semantic hit's snippet
    anchors on its matched chunk and never on a query term."""

    query: tuple[str, ...]
    text: tuple[str, ...]
    party: tuple[str, ...]


def lexicon(n_query: int = 6144, n_text: int = 2048, n_party: int = 2048) -> Lexicon:
    words = _pseudo_words(n_query + n_text + n_party, np.random.default_rng(20240611))
    return Lexicon(tuple(words[:n_query]), tuple(words[n_query : n_query + n_text]),
                   tuple(words[n_query + n_text :]))


def vocabulary(lex: Lexicon, vocab_size: int) -> dict[str, int]:
    """The WordPiece vocabulary, trained on the corpus's words: the
    specials, every word whole, digits and letters with their ``##``
    continuations, padded with ``[unused<i>]`` entries to the encoder's
    published ``vocab_size`` so that every embedding row exists."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789")
    toks = SPECIALS + FIXED_TOKENS + chars + ["##" + c for c in chars] + \
        list(lex.query) + list(lex.text) + [w.lower() for w in lex.party]
    toks = list(dict.fromkeys(toks))
    if len(toks) > vocab_size:
        raise ValueError(f"{len(toks)} tokens do not fit a vocabulary of {vocab_size}")
    toks += [f"[unused{i}]" for i in range(vocab_size - len(toks))]
    return {t: i for i, t in enumerate(toks)}


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


@dataclass
class Cases:
    """Case ``c`` of ``n``: its name, citation, court id, date (days since
    1970-01-01), chunks per case and the word ids of its text. Names and
    citations are unique; case ``c`` owns corpus rows ``c*k .. c*k+k-1``."""

    n: int
    chunks: int
    lex: Lexicon
    name_pair: np.ndarray  # [n, 2] indices into lex.party
    court_ids: np.ndarray  # [n] int32
    dates: np.ndarray  # [n] int32
    text_words: np.ndarray  # [n, chunks, WORDS_PER_SENTENCE] int16 into lex.text

    def name(self, c: int) -> str:
        a, b = self.name_pair[c]
        return f"{self.lex.party[a].title()} v. {self.lex.party[b].title()}"

    def citation(self, c: int) -> str:
        return citation(c)

    def court(self, c: int) -> str:
        return COURTS[int(self.court_ids[c])]

    def date(self, c: int) -> dt.date:
        return EPOCH + dt.timedelta(days=int(self.dates[c]))

    def sentence(self, c: int, j: int) -> str:
        words = " ".join(self.lex.text[w] for w in self.text_words[c, j])
        return f"{words[0].upper()}{words[1:]} in part {j} of case {c}."

    def text(self, c: int) -> str:
        return " ".join(self.sentence(c, j) for j in range(self.chunks))

    def opening(self, c: int) -> list[str]:
        """The words the content trie holds for case ``c``: the first
        ``OPENING_WORDS`` words of its text."""
        return [self.lex.text[w] for w in self.text_words[c, 0, :OPENING_WORDS]]


WORDS_PER_SENTENCE, OPENING_WORDS = 6, 4


def citation(c: int) -> str:
    """A unique U.S. Reports-style citation of case ``c``."""
    return f"{1 + c // 997} U.S. {1 + c % 997}"


def case_columns(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Court id (0 = no court) and decision date of each case, over 68
    years from 1950."""
    case = np.arange(n, dtype=np.int64)
    return (case % len(COURTS)).astype(np.int32), (-7305 + (case * 7919) % 25000).astype(np.int32)


def make_cases(n: int, chunks: int, seed: int, lex: Optional[Lexicon] = None) -> Cases:
    lex = lex or lexicon()
    rng = np.random.default_rng([seed, 1])
    P = len(lex.party)
    if n > P * P:
        raise ValueError(f"{n} cases need more than {P}^2 distinct names")
    pairs = rng.choice(P * P, n, replace=False)
    court_ids, dates = case_columns(n)
    words = rng.integers(0, len(lex.text), (n, chunks, WORDS_PER_SENTENCE), dtype=np.int16)
    return Cases(n, chunks, lex, np.stack([pairs // P, pairs % P], axis=1), court_ids, dates, words)


def case_uuid(c: int) -> uuid.UUID:
    return uuid.UUID(int=c + 1)


# ---------------------------------------------------------------------------
# corpus rows (copied from the chip smoke script's corpus_slabs/make_corpus)
# ---------------------------------------------------------------------------


def corpus_slabs(torch, P: int, m: int, D: int, seed: int, device) -> Iterator[tuple]:
    """The clustered corpus in generation order, one 64-partition slab at a
    time: ``(first partition, centroids [slab, D], L2-normalised rows
    [slab, m, D])``. Each slab draws its centroids around 8 shared
    super-topics, rows scatter around their centroid, and 10% of rows copy
    their in-partition neighbour. Random numbers come from a generator on
    ``device``."""
    gdev = torch.device(device)
    g = torch.Generator(device=gdev).manual_seed(seed)
    slab = min(64, P)
    G = 8
    for p0 in range(0, P, slab):
        sup = torch.randn((G, D), generator=g, device=gdev)
        sup /= sup.norm(dim=-1, keepdim=True)
        c = sup[torch.arange(slab, device=gdev) // (slab // G)]
        c = c + 0.25 * torch.randn((slab, D), generator=g, device=gdev) / D**0.5
        c /= c.norm(dim=-1, keepdim=True)
        v = c[:, None, :] + 0.35 * torch.randn((slab, m, D), generator=g, device=gdev) / D**0.5
        v /= v.norm(dim=-1, keepdim=True)
        dup = torch.rand((slab, m), generator=g, device=gdev) < 0.10
        yield p0, c, torch.where(dup[..., None], torch.roll(v, 1, dims=1), v)


def quantize_rows(torch, v):
    """Symmetric int8 per row, as a built index holds its blocks."""
    scale = v.abs().amax(dim=-1) / 127.0
    return torch.clamp(torch.round(v / scale[..., None]), -127, 127).to(torch.int8), scale


@dataclass
class Layout:
    """The partition-major index a build would hold: row ``p*m + j`` in
    slot ``j`` of partition ``p``; int8 blocks with per-row scales and the
    rows in bf16 for the rescore, as segments of ``seg_rows``."""

    centroids: object
    part_int8: object
    part_scale: object
    segs: tuple
    seg_rows: int

    def write_rows(self, torch, rows, vecs) -> None:
        """Overwrite corpus rows (int64 ids) with f32 vectors in all three
        stores."""
        m = self.part_int8.shape[1]
        q, s = quantize_rows(torch, vecs)
        p, j = rows // m, rows % m
        self.part_int8[p, j] = q
        self.part_scale[p, j] = s
        bf = vecs.to(torch.bfloat16)
        si, so = rows // self.seg_rows, rows % self.seg_rows
        for seg in torch.unique(si).tolist():
            sel = si == seg
            self.segs[seg][so[sel]] = bf[sel]


def make_layout(torch, P: int, m: int, D: int, seed: int, device, seg_rows: int, row_align: int) -> Layout:
    N = P * m
    segs, lo = [], 0
    while lo < N:
        n = min(seg_rows, N - lo)
        segs.append(torch.zeros((-(-n // row_align) * row_align, D), dtype=torch.bfloat16, device=device))
        lo += n
    cents = torch.empty((P, D), device=device)
    part_int8 = torch.empty((P, m, D), dtype=torch.int8, device=device)
    part_scale = torch.empty((P, m), device=device)
    lay = Layout(cents, part_int8, part_scale, tuple(segs), seg_rows)
    for p0, c, v in corpus_slabs(torch, P, m, D, seed, device):
        slab = c.shape[0]
        cents[p0 : p0 + slab] = c
        q, s = quantize_rows(torch, v)
        part_int8[p0 : p0 + slab] = q
        part_scale[p0 : p0 + slab] = s
        flat = v.reshape(-1, D).to(torch.bfloat16)
        r0, off = p0 * m, 0
        while off < flat.shape[0]:
            si, so = divmod(r0 + off, seg_rows)
            take = min(flat.shape[0] - off, seg_rows - so)
            segs[si][so : so + take] = flat[off : off + take]
            off += take
    return lay


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


@dataclass
class Query:
    """One request of a traffic mix. ``kind`` is ``name``, ``citation`` or
    ``semantic``; ``target`` the named case (-1 for a phrase)."""

    text: str
    kind: str
    target: int = -1
    court_filter: Optional[list[str]] = None
    date_range: Optional[tuple[dt.date, dt.date]] = None
    max_results: int = 10

    def body(self) -> dict:
        """The JSON body of ``POST /search``."""
        out: dict = {"query": self.text, "max_results": self.max_results}
        if self.court_filter:
            out["court_filter"] = self.court_filter
        if self.date_range:
            out["date_range"] = [d.isoformat() for d in self.date_range]
        return out


def _cycle_shuffled(values, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` draws that repeat ``values`` evenly, in a seeded order: every
    seed gets the same multiset and only the order changes."""
    reps = -(-n // len(values))
    return rng.permutation(np.tile(np.asarray(values), reps)[: max(n, 0)])


def make_queries(mix: dict, n: int, cases: Cases, seed: int) -> list[Query]:
    """``n`` distinct queries of a traffic mix from its ``queries`` block:
    the share of names, citations and phrases, phrase lengths, filter
    shares and ``max_results``. Sizes repeat evenly (the same multiset for
    every seed); which cases, words, filters and order come from the seed."""
    qm = mix["queries"]
    rng = np.random.default_rng([seed, 2])
    lex = cases.lex
    per = qm["kinds_per_12"]  # e.g. {"name": 2, "citation": 2, "semantic": 8}
    kinds = _cycle_shuffled([k for k, c in per.items() for _ in range(c)], n, rng)
    lo, hi = qm["phrase_words"]
    lengths = iter(_cycle_shuffled(list(range(lo, hi + 1)), int(np.sum(kinds == "semantic")), rng))
    court_on = _cycle_shuffled([1] * qm["court_filter_per_10"] + [0] * (10 - qm["court_filter_per_10"]), n, rng)
    date_on = _cycle_shuffled([1] * qm["date_filter_per_10"] + [0] * (10 - qm["date_filter_per_10"]), n, rng)
    targets = rng.choice(cases.n, n, replace=False)
    out, seen = [], set()
    for i in range(n):
        kind, target = str(kinds[i]), -1
        if kind == "name":
            text, target = cases.name(int(targets[i])), int(targets[i])
        elif kind == "citation":
            text, target = cases.citation(int(targets[i])), int(targets[i])
        else:
            text = " ".join(lex.query[w] for w in rng.integers(0, len(lex.query), int(next(lengths))))
        if text in seen:
            raise ValueError(f"query {text!r} repeats")
        seen.add(text)
        cf = dr = None
        if court_on[i]:
            k = 1 + int(rng.integers(0, 3))
            cf = [COURTS[1 + int(x)] for x in rng.choice(len(COURTS) - 1, k, replace=False)]
        if date_on[i]:
            a = int(rng.integers(-7305, -7305 + 25000 - 3650))
            b = a + int(rng.integers(1825, 9125))
            dr = (EPOCH + dt.timedelta(days=a), EPOCH + dt.timedelta(days=b))
        out.append(Query(text, kind, target, cf, dr, int(qm["max_results"])))
    return out


def arrivals(rate: float, n: int, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``n`` Poisson arrivals at
    ``rate`` per second. The gaps are the exponential distribution's
    quantiles at evenly spaced probabilities, in a seeded order, so every
    seed offers the same gaps and the same total."""
    rng = np.random.default_rng([seed, 3])
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    return np.cumsum(rng.permutation(gaps)) - gaps.min()


# ---------------------------------------------------------------------------
# planted neighbours
# ---------------------------------------------------------------------------


@dataclass
class Plan:
    """Planted rows: query index, corpus row, the f32 vector written there
    (L2-normalised) and its target cosine to the query's reference
    embedding; ``deepest``, the largest rank of a planted case's partition
    in its query's order of centroids (0: the nearest)."""

    query: np.ndarray
    rows: np.ndarray
    vecs: object  # torch [R, D] f32 on the device
    tau: np.ndarray
    deepest: int = 0


def plant_targets(torch, q, tau, mu, rng_t, noise: float):
    """Vectors whose cosine to each query ``q [Q, D]`` is ``tau [Q]``: the
    query's part orthogonal to the embeddings' common direction ``mu``,
    plus seeded noise, plus as much of ``mu`` as reaches ``tau``. Keeping
    ``mu`` small keeps the rows' cosines to other queries low: a seeded
    encoder maps every text near ``mu``."""
    a = q @ mu
    u = q - a[:, None] * mu[None]
    u = u / u.norm(dim=1, keepdim=True)
    n = torch.randn(q.shape, generator=rng_t, device=q.device)
    n = n - (n @ mu)[:, None] * mu[None]
    n = n / n.norm(dim=1, keepdim=True)
    r0 = u + noise * n
    x, y, rr = (r0 * q).sum(1), r0 @ mu, (r0 * r0).sum(1)
    # (x + g a)^2 = tau^2 (rr + 2 g y + g^2): the root with x + g a > 0
    A = a * a - tau * tau
    B = 2 * (x * a - tau * tau * y)
    C = x * x - tau * tau * rr
    disc = torch.clamp(B * B - 4 * A * C, min=0).sqrt()
    g1, g2 = (-B + disc) / (2 * A), (-B - disc) / (2 * A)
    ok1 = (x + g1 * a) > 0
    g = torch.where(ok1 & ((g1.abs() <= g2.abs()) | ~((x + g2 * a) > 0)), g1, g2)
    r = r0 + g[:, None] * mu[None]
    return r / r.norm(dim=1, keepdim=True)


def plan_plants(torch, ref_q, semantic_idx: np.ndarray, plant: dict, layout: Layout, chunks: int, seed: int) -> Plan:
    """For each semantic query, ``cases`` cases (a seeded count from the
    mix) each get ``rows`` chunks near the query's reference embedding,
    at cosines from ``tau`` down by ``tau_step`` per chunk. A case's rows
    go where a clustered corpus keeps a query's near neighbours: into the
    partition nearest the query with a case group free, in the query's
    order of centroids (queries share their nearest partitions, which
    fill)."""
    dev = ref_q.device
    rng = np.random.default_rng([seed, 4])
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(0, 2**62)))
    S = len(semantic_idx)
    n_cases = _cycle_shuffled(plant["cases"], S, rng)
    per_case = []
    for s in range(S):
        per_case.append(_cycle_shuffled(plant["rows"], int(n_cases[s]), rng))
    qi = np.repeat(np.arange(S), n_cases)  # one entry per planted case
    rows_per = np.concatenate(per_case).astype(np.int64)
    lo, hi = plant["tau"]
    tau_case = lo + (hi - lo) * _cycle_shuffled(np.linspace(0, 1, 64), len(qi), rng)
    qv = ref_q[torch.as_tensor(semantic_idx[qi], device=dev)]
    mu = ref_q[torch.as_tensor(semantic_idx, device=dev)].mean(0)
    mu = mu / mu.norm()
    best = plant_targets(torch, qv, torch.as_tensor(tau_case, device=dev, dtype=torch.float32), mu, g,
                         plant["noise"])
    # each planted case: the partition nearest its query with a group free
    P, m = layout.part_int8.shape[:2]
    groups = m // chunks
    sq = ref_q[torch.as_tensor(semantic_idx, device=dev)]
    order = torch.cat([torch.topk(sq[i : i + 4096] @ layout.centroids.T, k=min(512, P), dim=1).indices
                       for i in range(0, S, 4096)]).to(torch.int32).cpu().numpy()
    part = np.full(len(qi), -1, np.int64)
    used = np.zeros(P, np.int64)
    deepest = 0
    for r in range(order.shape[1]):  # rank by rank: each partition takes cases in their order
        todo = np.nonzero(part < 0)[0]
        if not len(todo):
            break
        deepest = r
        p = order[qi[todo], r].astype(np.int64)
        srt = np.argsort(p, kind="stable")
        ps = p[srt]
        first = np.searchsorted(ps, ps, side="left")
        take = srt[(np.arange(len(ps)) - first) < (groups - used[ps])]
        part[todo[take]] = p[take]
        np.add.at(used, p[take], 1)
    if (part < 0).any():
        raise RuntimeError(f"{int((part < 0).sum())} planted cases find no room in their query's "
                           f"{order.shape[1]} nearest partitions")
    # each case's group within its partition: the k-th case a partition
    # takes gets group (k * stride + p) mod groups, a bijection that keeps
    # the courts spread
    stride = 97 if groups % 97 else 1
    k = np.empty(len(qi), np.int64)
    srt = np.argsort(part, kind="stable")
    k[srt] = np.arange(len(qi)) - np.searchsorted(part[srt], part[srt], side="left")
    slot = part * m + ((k * stride + part) % groups) * chunks
    rows, qs, taus, vec_parts = [], [], [], []
    for j in range(int(rows_per.max())):
        sel = np.nonzero(rows_per > j)[0]
        t = tau_case[sel] - plant["tau_step"] * j
        v = best[torch.as_tensor(sel, device=dev)] if j == 0 else plant_targets(
            torch, qv[torch.as_tensor(sel, device=dev)], torch.as_tensor(t, device=dev, dtype=torch.float32),
            mu, g, plant["noise"])
        rows.append(slot[sel] + j)
        qs.append(semantic_idx[qi[sel]])
        taus.append(t)
        vec_parts.append(v)
    return Plan(np.concatenate(qs), np.concatenate(rows), torch.cat(vec_parts), np.concatenate(taus), deepest)


