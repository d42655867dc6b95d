"""Serving-grade nprobe tuning: case-level recall with query-shaped probes
(port of ``trie_semantic_search_tpu/index/tuning.py``).

``PartitionedANN.tune_nprobe`` measures the score recall of corpus rows
used as their own queries. On a real corpus that is degenerate: groups of
duplicate text embed alike, every returned duplicate ties the exact k-th
score, and the row-level tuner settles on nprobe 1 while the case-level
recall that serving reports falls far below its target. This tuner
measures what serving reports:

* **queries**: query-shaped probes (half sentences and paraphrases of
  stored text re-embedded by the serving encoder,
  :func:`build_probe_embeddings`), not corpus rows;
* **metric**: top-``k`` *case* set overlap against the exact full-corpus
  oracle (each case's best chunk score, the lower case row on ties);
* **search path**: ``ann.search`` row results deduplicated to cases. On
  the card that search runs the probe and rescore kernels
  (``PartitionedANN.search_route``).

The oracle stays numpy on the host, as in the JAX package: its tie sets
compare scores for exact f32 equality, and a GEMM on the card (or torch's
CPU GEMM) can make two bitwise-equal dot products differ, so its bits must
be numpy's.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

_log = logging.getLogger("tss_torch.index.tuning")


def tie_aware_recall(served: set, oracle_topk: set, tie_set: frozenset, above_set: frozenset) -> float:
    """Recall@k that forgives only substitutions within the exact boundary
    tie: ``(|served ∩ above| + min(k - |above|, |served ∩ boundary|)) / k``,
    where ``above`` holds the oracle cases scoring strictly above the k-th
    score (each one required) and ``boundary`` those scoring bitwise equal
    to it (any ``k - |above|`` of them are equally right)."""
    k_slots = max(len(oracle_topk), 1)
    boundary = tie_set - above_set
    credit = len(served & above_set) + min(k_slots - len(above_set), len(served & boundary))
    return credit / k_slots


def case_level_oracle(
    vectors: np.ndarray,  # [N, D] f32 (memmap ok)
    chunk_case: np.ndarray,  # [N] case row of each chunk
    query_embs: np.ndarray,  # [Q, D] (need not be normalized)
    k: int = 10,
    slab: int = 262_144,
    return_scores: bool = False,
    return_tie_sets: bool = False,
    return_above_sets: bool = False,
) -> "list[list[int]] | tuple":
    """Exact top-``k`` case rows per query: each case's best chunk score
    over the whole corpus, ties to the lower case row. The corpus streams
    in slabs of ``slab`` rows. Optionally also, per query: the k-th score
    (``return_scores``), the cases scoring ``>=`` it (``return_tie_sets``)
    and the cases scoring ``>`` it (``return_above_sets``). Membership
    compares entries of one f32 score array, never with a tolerance."""
    q = np.asarray(query_embs, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    Q = len(q)
    C = int(chunk_case.max()) + 1 if len(chunk_case) else 0
    best = np.full((Q, C), -np.inf, np.float32)
    cc_all = np.asarray(chunk_case, np.int64)
    mono = bool(np.all(np.diff(cc_all) >= 0))
    for lo in range(0, len(vectors), slab):
        v = np.array(vectors[lo : lo + slab], np.float32)
        v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        s = q @ v.T  # [Q, slab]
        cc = cc_all[lo : lo + slab]
        if mono and len(cc):
            # chunk → case is nondecreasing in build order: a segment max
            # by reduceat
            starts = np.concatenate([[0], np.flatnonzero(np.diff(cc)) + 1])
            m = np.maximum.reduceat(s, starts, axis=1)
            best[:, cc[starts]] = np.maximum(best[:, cc[starts]], m)
        else:
            for b in range(Q):
                np.maximum.at(best[b], cc, s[b])
    out = []
    kth: list[float] = []
    tie_sets: list[frozenset] = []
    above_sets: list[frozenset] = []
    rows = np.arange(C)
    for b in range(Q):
        order = np.lexsort((rows, -best[b]))[:k]
        out.append([int(r) for r in order])
        kb = float(best[b][order[-1]]) if len(order) else -np.inf
        kth.append(kb)
        if return_tie_sets:
            tie_sets.append(frozenset(
                int(r) for r in np.flatnonzero(best[b] >= kb)
            ) if len(order) else frozenset())
        if return_above_sets:
            above_sets.append(frozenset(
                int(r) for r in np.flatnonzero(best[b] > kb)
            ) if len(order) else frozenset())
    if return_scores or return_tie_sets or return_above_sets:
        res: list = [out]
        if return_scores:
            res.append(kth)
        if return_tie_sets:
            res.append(tie_sets)
        if return_above_sets:
            res.append(above_sets)
        return tuple(res)
    return out


def _served_cases(
    ann, chunk_case: np.ndarray, query_embs: np.ndarray, k: int, nprobe: int,
    row_overfetch: int = 16,
) -> list[list[int]]:
    """Top-``k`` distinct cases through ``ann.search`` at ``nprobe``: fetch
    ``k * row_overfetch`` rows (duplicate-heavy corpora repeat cases) and
    deduplicate in score order."""
    k_rows = min(k * row_overfetch, ann.num_vectors)
    _, idx = ann.search(np.asarray(query_embs, np.float32), k_rows, nprobe=nprobe)
    out = []
    for r in np.asarray(idx):
        seen: list[int] = []
        for row in r:
            if row < 0:
                continue
            c = int(chunk_case[row])
            if c not in seen:
                seen.append(c)
                if len(seen) >= k:
                    break
        out.append(seen)
    return out


def tune_nprobe_case_recall(
    ann,  # index.ann.PartitionedANN (built)
    chunk_case: np.ndarray,  # [N] chunk → case row
    vectors: np.ndarray,  # [N, D] f32 corpus (memmap ok)
    query_embs: np.ndarray,  # [Q, D] query-shaped probe embeddings
    k: int = 10,
    target_recall: float = 0.95,
    max_nprobe: Optional[int] = None,
    min_recall: Optional[float] = None,
    tie_exact_floor: bool = True,
) -> int:
    """The smallest ``nprobe`` whose case-level recall@k against the exact
    oracle reaches ``target_recall``, kept in ``ann.tuned_nprobe`` (the
    artifact's own field, not the shared config).

    ``min_recall`` also bounds the worst single probe: an nprobe is
    accepted only when the mean reaches ``target_recall`` and every probe
    reaches ``min_recall``. With ``tie_exact_floor`` (default) that floor
    is tie-aware (:func:`tie_aware_recall`: a served case that ties the
    oracle's k-th score bitwise counts); the mean stays strict set overlap.

    The sweep doubles nprobe from 1 up to the cap, then refines once at the
    midpoint. The cap is ``max_nprobe`` (default ``P // 2``), clamped below
    ``num_vectors / m``: past that ``ann.search`` demotes to the exact brute
    scan, and the sweep would measure the oracle's recall. When the target
    is out of reach within the cap, the sweep settles on the smallest
    nprobe whose mean passes and whose worst probe is within 1e-3 of the
    best worst seen (a plateau more probes do not lift), else on the cap.

    Each step is logged with its recall, the route ``ann.search`` took
    (``PartitionedANN.search_route``) and its seconds.
    """
    P = int(ann.centroids.shape[0])
    cap = min(max_nprobe or max(8, P // 2), P)
    m = int(ann.part_rows.shape[1]) if ann.part_rows is not None else 0
    if m > 0 and ann.num_vectors > m:
        cap = max(1, min(cap, (ann.num_vectors - 1) // m))
    t0 = time.perf_counter()
    oracle_lists, tie_sets, above_sets = case_level_oracle(
        vectors, chunk_case, query_embs, k, return_tie_sets=True, return_above_sets=True,
    )
    _log.info("case-level oracle: %d probes over %d rows in %.3f s",
              len(oracle_lists), len(vectors), time.perf_counter() - t0)
    oracle = [set(o) for o in oracle_lists]

    # (strict mean, strict worst, floor worst) per nprobe; the floor worst
    # is tie-aware with tie_exact_floor
    measured: dict[int, tuple[float, float, float]] = {}

    def measure(nprobe: int) -> tuple[float, float, float]:
        if nprobe not in measured:
            t = time.perf_counter()
            served = _served_cases(ann, chunk_case, query_embs, k, nprobe)
            per = np.asarray([len(set(s) & o) / max(len(o), 1) for s, o in zip(served, oracle)])
            per_tie = np.asarray([
                tie_aware_recall(set(s), o, t_, a)
                for s, t_, a, o in zip(served, tie_sets, above_sets, oracle)
            ])
            mean, worst = float(per.mean()), float(per.min())
            floor_worst = float(per_tie.min()) if tie_exact_floor else worst
            _log.info(
                "case recall@%d at nprobe=%d: mean %.4f min %.4f (tie-aware min %.4f); "
                "route %s, %.3f s",
                k, nprobe, mean, worst, float(per_tie.min()),
                ann.search_route(len(oracle), nprobe), time.perf_counter() - t,
            )
            measured[nprobe] = (mean, worst, floor_worst)
        return measured[nprobe]

    def accept_at(nprobe: int) -> bool:
        mean, _worst, floor_worst = measure(nprobe)
        if mean < target_recall:
            return False
        return min_recall is None or floor_worst >= min_recall

    if accept_at(1):
        hi = 1
    else:
        n, lo, hi = 1, 1, None
        while True:
            n = min(n * 2, cap)
            if accept_at(n):
                hi = n
                break
            lo = n
            if n >= cap:
                break
        if hi is None:  # the target is out of reach within the cap: settle
            # a worst-probe recall that stays flat as nprobe doubles comes
            # from the ranking (ties, case dedup), not from the probes
            best_worst = max(w for _m, _s, w in measured.values())
            ok = [
                n for n, (mn, _s, w) in measured.items()
                if mn >= target_recall and w >= best_worst - 1e-3
            ]
            if min_recall is not None and ok:
                hi = min(ok)
                _log.warning(
                    "min-recall floor %.2f unreachable at nprobe<=%d (best attainable worst "
                    "%.2f); settling on mean-target nprobe=%d",
                    min_recall, cap, best_worst, hi,
                )
            else:
                hi = cap
                _log.warning(
                    "case recall target %.2f (min %s) unreachable at nprobe<=%d; settling on "
                    "the cap", target_recall, min_recall, cap,
                )
        elif hi - lo > 1:  # one midpoint refine (also when hi == cap)
            mid = (lo + hi) // 2
            if accept_at(mid):
                hi = mid
    ann.tuned_nprobe = int(hi)
    return int(hi)


def build_probe_embeddings(
    storage,  # storage.store.StorageManager
    text_processor,  # text.processor.TextProcessor
    embed_fn,  # Callable[[list[str]], np.ndarray]  (texts → [n, D])
    max_cases: int = 200,
    max_probes: int = 64,
) -> Optional[np.ndarray]:
    """Query-shaped probe embeddings from the first ``max_cases`` stored
    cases: half-sentence and paraphrase probes
    (:func:`..models.quality.build_probes`) embedded by ``embed_fn``, the
    serving encoder. None when the corpus yields no probe."""
    from ..models.quality import build_probes

    docs = []
    for row, _meta, text in storage.iter_cases_rowid():
        if len(docs) >= max_cases:
            break
        if text:
            docs.append((row, text_processor.extract_sentences(text_processor.normalize_text(text))))
    probes = build_probes(docs, max_probes=max_probes)
    if not probes:
        return None
    return np.asarray(embed_fn([p.query for p in probes]), np.float32)
