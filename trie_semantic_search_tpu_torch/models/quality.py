"""Retrieval-quality probes for the semantic encoder (port of
``trie_semantic_search_tpu/models/quality.py``: what the build-time quality
gate, the pooling selection and ``eval-retrieval`` call).

Held-out probes are derived from corpus sentences, never verbatim corpus
strings: the second half of a sentence (``"half"``), and a synonym-swap +
stopword-drop rewrite (``"paraphrase"``). :func:`build_probes` draws them
with the same numpy generator as the JAX package, so both packages build
the same probes from the same documents. :func:`evaluate_embedder_direct`
ranks a chunk sample by exact cosine and reports MRR and recall@{1,5,k} of
each probe's source case. :func:`evaluate_engine` scores the probes
through a whole ``SearchEngine``, and :func:`evaluate_stages` splits that
into the exact case-level oracle over every chunk and the ANN alone at the
index's tuned nprobe. :func:`pair_ranking_accuracy` is the full-matrix
InfoNCE accuracy of held-out sentence pairs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.scoring import l2_normalize

#: meaning-preserving legal-domain rewrites
SYNONYMS: dict[str, str] = {
    "attorney": "lawyer",
    "lawyer": "attorney",
    "judgment": "ruling",
    "ruling": "judgment",
    "statute": "law",
    "automobile": "car",
    "vehicle": "car",
    "defendant": "accused",
    "petitioner": "applicant",
    "counsel": "attorney",
    "court": "tribunal",
    "contract": "agreement",
    "evidence": "proof",
    "determined": "decided",
    "concluded": "decided",
    "held": "decided",
    "reversed": "overturned",
    "affirmed": "upheld",
    "unlawful": "illegal",
    "prohibited": "forbidden",
    "obtained": "acquired",
    "reasonable": "sensible",
    "principles": "doctrines",
    "framework": "structure",
}

_DROP_STOPWORDS = {
    "the", "a", "an", "of", "in", "on", "at", "to", "and", "or", "is",
    "was", "were", "be", "been", "that", "this", "it", "its", "by",
}


@dataclass
class Probe:
    query: str
    target_case_row: int
    kind: str  # "half" | "paraphrase"


def _paraphrase(sentence: str, rng: np.random.Generator) -> Optional[str]:
    """Synonym-swap + stopword-drop rewrite; None when no word was swapped
    (the probe would be a verbatim corpus string)."""
    out = []
    swapped = 0
    for w in sentence.split():
        lw = w.lower().strip(".,;:()")
        if lw in SYNONYMS:
            out.append(SYNONYMS[lw])
            swapped += 1
        elif lw in _DROP_STOPWORDS and rng.random() < 0.5:
            continue
        else:
            out.append(w)
    if swapped == 0:
        return None
    return " ".join(out)


def build_probes(
    docs: Sequence[tuple[int, Sequence[str]]],  # (case_row, sentences)
    max_probes: int = 256,
    seed: int = 0,
    min_tokens: int = 8,
) -> list[Probe]:
    """Held-out probes from corpus sentences: documents in a seeded random
    order, one sentence of at least ``min_tokens`` words each, its second
    half and (when a word swaps) its paraphrase."""
    rng = np.random.default_rng(seed)
    probes: list[Probe] = []
    for di in rng.permutation(len(docs)):
        case_row, sents = docs[di]
        long_sents = [s for s in sents if len(s.split()) >= min_tokens]
        if not long_sents:
            continue
        s = long_sents[int(rng.integers(0, len(long_sents)))]
        words = s.split()
        probes.append(Probe(" ".join(words[len(words) // 2 :]), int(case_row), "half"))
        p = _paraphrase(s, rng)
        if p is not None:
            probes.append(Probe(p, int(case_row), "paraphrase"))
        if len(probes) >= max_probes:
            break
    return probes[:max_probes]


def _aggregate(ranks: dict[str, list[float]], k: int, recall_1_5: bool = True) -> dict:
    """Per probe kind (and ``"all"``): n, MRR and recall@{1, 5,} k of the
    reciprocal ranks (0 for a miss), rounded to 4 places."""

    def agg(rr: list[float]) -> dict:
        a = np.asarray(rr, np.float64)
        out = {"n": int(len(a)), "mrr": round(float(a.mean()), 4)}
        if recall_1_5:
            out["recall_at_1"] = round(float((a >= 1.0).mean()), 4)
            out["recall_at_5"] = round(float((a >= 1 / 5).mean()), 4)
        out[f"recall_at_{k}"] = round(float((a > 0).mean()), 4)
        return out

    return {kind: agg(rr) for kind, rr in ranks.items()}


def _rank_of(p: Probe, ranked_cases: Sequence[int], k: int) -> float:
    """Reciprocal rank of ``p``'s source case in the first ``k`` entries."""
    for pos, c in enumerate(ranked_cases[:k]):
        if int(c) == p.target_case_row:
            return 1.0 / (pos + 1)
    return 0.0


def evaluate_engine(
    engine,  # search.engine.SearchEngine
    columns,  # storage.columns.MetadataColumns (case row <-> case id)
    probes: Sequence[Probe],
    k: int = 10,
    batch: int = 32,
) -> dict:
    """MRR and recall@{1,5,k} of each probe's source case through the whole
    engine: semantic-only queries (no prefix walk, ``min_similarity`` 0,
    no filters) in batches of ``batch``."""
    from ..core.types import SearchConfig
    from ..search.engine import SearchQuery

    id_to_row = {cid: i for i, cid in enumerate(columns.case_ids)}
    ranks: dict[str, list[float]] = {}
    cfg = SearchConfig(max_results=k, min_similarity=0.0, enable_prefix=False)
    for lo in range(0, len(probes), batch):
        chunk = probes[lo : lo + batch]
        results = engine.search_batch([SearchQuery(query=p.query, max_results=k, config=cfg) for p in chunk])
        for p, rs in zip(chunk, results):
            rank = _rank_of(p, [id_to_row.get(r.case_metadata.id, -1) for r in rs], k)
            ranks.setdefault(p.kind, []).append(rank)
            ranks.setdefault("all", []).append(rank)
    return _aggregate(ranks, k)


def evaluate_stages(engine, columns, probes: Sequence[Probe], k: int = 10) -> dict:
    """MRR stage by stage over the whole index, case-level with ties to the
    lower row: ``exact_full``, the exact cosine over every chunk (the
    tuner's oracle, :func:`..index.tuning.case_level_oracle`), and
    ``ann_only``, the ANN at the index's tuned nprobe with no lexical boost
    or merge (:func:`..index.tuning._served_cases`); ``tuned_nprobe`` too.
    The engine's own MRR is :func:`evaluate_engine`'s. An ANN that cannot
    probe gives ``ann_only_error`` instead."""
    from ..index.tuning import _served_cases, case_level_oracle

    vector = engine.vector_index
    embs = vector.embedder.embed([p.query for p in probes]).embedding
    chunk_case = np.asarray(vector.refs)[:, 0]

    def mrr_from_lists(lists: Sequence[Sequence[int]]) -> dict:
        ranks: dict[str, list[float]] = {}
        for p, served in zip(probes, lists):
            rank = _rank_of(p, served, k)
            ranks.setdefault(p.kind, []).append(rank)
            ranks.setdefault("all", []).append(rank)
        return _aggregate(ranks, k, recall_1_5=False)

    exact = case_level_oracle(vector.vectors, chunk_case, embs, k)
    nprobe = getattr(vector.ann, "tuned_nprobe", None) or getattr(vector.ann, "default_nprobe", 0)
    out = {"exact_full": mrr_from_lists(exact), "tuned_nprobe": int(nprobe)}
    try:
        out["ann_only"] = mrr_from_lists(_served_cases(vector.ann, chunk_case, embs, k, int(nprobe)))
    except Exception as e:  # an ANN without partitions to probe
        out["ann_only_error"] = str(e)
    return out


def evaluate_embedder_direct(
    embedder,  # models.embedder.Embedder
    chunk_texts: Sequence[str],
    chunk_cases: Sequence[int],
    probes: Sequence[Probe],
    k: int = 10,
) -> dict:
    """Embed the probes and the chunk sample with ``embedder``, rank the
    chunks by exact cosine (on the embedder's device) and score each probe
    by the reciprocal rank of its source case among the first ``k``
    distinct cases. Returns, per probe kind and ``"all"``: n, mrr and
    recall@1/5/k, rounded to 4 places."""
    dev = embedder.device

    def embed(texts) -> torch.Tensor:
        e = torch.as_tensor(embedder.embed(list(texts)).embedding, dtype=torch.float32, device=dev)
        return l2_normalize(e)

    corpus = embed(chunk_texts)
    cases = np.asarray(chunk_cases, np.int64)
    ranks: dict[str, list[float]] = {}
    for lo in range(0, len(probes), 64):
        chunk = probes[lo : lo + 64]
        scores = (embed([p.query for p in chunk]) @ corpus.T).cpu().numpy()  # [b, N]
        for row, p in zip(scores, chunk):
            seen: list[int] = []
            rank = 0.0
            for idx in np.argsort(-row, kind="stable"):
                c = int(cases[idx])
                if c in seen:
                    continue
                seen.append(c)
                if c == p.target_case_row:
                    rank = 1.0 / len(seen)
                    break
                if len(seen) >= k:
                    break
            ranks.setdefault(p.kind, []).append(rank)
            ranks.setdefault("all", []).append(rank)
    return _aggregate(ranks, k)


def pair_ranking_accuracy(
    embedder,
    pairs: Sequence[tuple[str, str]],  # held-out (anchor, positive) pairs
) -> float:
    """Share of held-out pairs whose positive outranks every other pair's
    positive by cosine (argmax on the host, the first index on ties)."""
    a = l2_normalize(torch.as_tensor(embedder.embed([p[0] for p in pairs]).embedding, dtype=torch.float32))
    b = l2_normalize(torch.as_tensor(embedder.embed([p[1] for p in pairs]).embedding, dtype=torch.float32))
    scores = a.numpy() @ b.numpy().T
    return float((scores.argmax(axis=1) == np.arange(len(pairs))).mean())
