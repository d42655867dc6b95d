"""Hybrid search engine: trie lexical + semantic vector, merged, ranked and
hydrated into the results a user sees.

Port of ``trie_semantic_search_tpu/search/engine.py``, with the same query
semantics:

  * validation: query length within [min, max]
  * TTL query cache on the batch path (only misses run)
  * the fused device path (:class:`~.fused.FusedHybridSearch`, default):
    one step per batch with the device k bucketed to 32/64/128, then one
    batched storage prefetch and host hydration
  * the staged path (``use_fused_device_path=False``, or a query that
    turns off the prefix or semantic side): the batched trie walk, the
    vector index's staged search, then merge, dedup by case, court and date
    filters on the metadata columns, sort and truncation on the host
  * snippets anchored on the matched sentence, replaying the builder's
    normalize → sentence split, and highlights
  * warmup over the serve-time batch and token-length buckets,
    health_check and get_stats

The index, the fused state and the encoder live on ``device`` (default
``"cuda"``). With a ``mesh`` (:mod:`..parallel.mesh`) the fused state is
sharded over the mesh's devices and every full hybrid batch takes the fused
path, as in the JAX package.
"""

from __future__ import annotations

import datetime as _dt
import logging
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Sequence

import numpy as np

from ..core.config import Config
from ..core.errors import InvalidSearchQuery
from ..core.metrics import metrics
from ..core.types import CaseMetadata, SearchConfig
from ..device import DeviceLike, resolve_device
from ..index.trie import TrieIndex
from ..index.vector import VectorIndex
from ..storage.columns import MetadataColumns, date_to_int
from ..storage.store import StorageManager
from ..text.processor import TextProcessor
from ..utils import BATCH_BUCKETS, batch_bucket
from .cache import CacheStats, QueryCache, _LruTtl
from .fused import FusedHybridSearch
from .snippets import HighlightType, TextHighlight, generate_snippet

_log = logging.getLogger("tss_torch.search")


class MatchType(str, Enum):
    """Where a result came from."""

    EXACT = "exact"
    PREFIX = "prefix"
    SEMANTIC = "semantic"
    CASE_NAME = "case_name"
    CITATION = "citation"


@dataclass(slots=True)
class SearchQuery:
    """One request: the text, a result limit, court and date filters."""

    query: str
    max_results: Optional[int] = None
    court_filter: Optional[list[str]] = None
    date_range: Optional[tuple[Optional[_dt.date], Optional[_dt.date]]] = None
    config: SearchConfig = field(default_factory=SearchConfig)


@dataclass(slots=True)
class SearchResult:
    """One hydrated hit."""

    case_metadata: CaseMetadata
    score: float
    match_type: MatchType
    snippet: str = ""
    highlights: list[TextHighlight] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "case_metadata": self.case_metadata.to_json(),
            "score": self.score,
            "match_type": self.match_type.value,
            "snippet": self.snippet,
            "highlights": [
                {"start": h.start, "end": h.end, "highlight_type": h.highlight_type.value}
                for h in self.highlights
            ],
        }


@dataclass
class SearchEngineStats:

    total_cases_indexed: int = 0
    vector_index_stats: Optional[object] = None
    trie_stats: Optional[dict] = None
    cache_stats: Optional[CacheStats] = None
    queries_served: int = 0
    #: probe-path queries re-run through the exact layout stream because
    #: their served top-k boundary was flat (fused.FusedHybridSearch
    #: flat-boundary escalation)
    escalated_queries: int = 0


class SearchEngine:
    """Hybrid engine over frozen indexes, on ``device`` (default
    ``"cuda"``; indexes passed in keep their own device)."""

    def __init__(
        self,
        config: Config,
        storage: StorageManager,
        trie_index: Optional[TrieIndex] = None,
        vector_index: Optional[VectorIndex] = None,
        columns: Optional[MetadataColumns] = None,
        device: DeviceLike = None,
        mesh=None,  # parallel.mesh.Mesh: sharded serving over its devices
    ):
        self.config = config
        self.storage = storage
        self.device = resolve_device(device)
        self.mesh = mesh
        self.trie_index = trie_index or TrieIndex(config.trie, device=self.device)
        self.vector_index = vector_index or VectorIndex(config.vector, device=self.device)
        self.columns = columns or MetadataColumns.build(
            storage.fetch_filter_columns()
        )
        self.query_cache = QueryCache(
            max_size=config.search.query_cache_size,
            ttl_seconds=config.search.query_cache_ttl_seconds,
        )
        # snippet anchoring must replay the builder's exact chunking
        self._text_processor = TextProcessor(config.text_processing)
        # hot cases repeat the normalize → sentence-split replay of every
        # semantic result, the metadata select and the text decompress:
        # LRU caches, cleared on swap_indexes with the query cache
        self._sentences_cache: _LruTtl[list[str]] = _LruTtl(max_size=8192)
        self._meta_cache: _LruTtl = _LruTtl(max_size=16384)
        self._text_cache: _LruTtl[str] = _LruTtl(max_size=8192)
        self._queries_served = 0
        self._fused = None  # lazily-built FusedHybridSearch
        #: the server runs batches from two worker threads beside warmup:
        #: the lazy fused state is built once and the served count adds up
        self._lock = threading.Lock()
        #: set by :meth:`warmup` when every serve-time shape ran
        self.is_warm = False

    def _sentences_of(self, case_id, text: str) -> list[str]:
        """Builder-pipeline sentence split of a case text, LRU-cached
        (snippet anchoring replays normalize→sentences for every semantic
        hit; hot cases repeat across queries). Keyed by (case id, text
        length) so a case text rewritten in storage without an index swap
        cannot serve a stale split."""
        key = (case_id, len(text))
        cached = self._sentences_cache.get(key)
        if cached is not None:
            return cached
        sents = self._text_processor.extract_sentences(
            self._text_processor.normalize_text(text)
        )
        self._sentences_cache.put(key, sents)
        return sents

    # -- index swap (lock-free hot reload) ------------------------------------

    def swap_indexes(
        self,
        trie_index: Optional[TrieIndex] = None,
        vector_index: Optional[VectorIndex] = None,
        columns: Optional[MetadataColumns] = None,
    ) -> None:
        """Atomic replacement of frozen artifacts (single assignment per
        attribute; readers see old or new, never a mix of a given index)."""
        with self._lock:
            if trie_index is not None:
                self.trie_index = trie_index
            if vector_index is not None:
                self.vector_index = vector_index
            if columns is not None:
                self.columns = columns
            self._fused = None  # rebind to the new artifacts on demand
        self.is_warm = False  # the new artifacts have not served yet
        self.query_cache.clear()
        self._sentences_cache.clear()  # reindex may have rewritten texts
        self._meta_cache.clear()
        self._text_cache.clear()

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Run the serve-time shape set once before users arrive, as the
        JAX package's warmup does (there it compiles every shape; here it
        builds the kernel library, fills the allocator's pools and loads
        the encoder's pages). The axes:

        * batch bucket: ``utils.BATCH_BUCKETS``, the ladder every device
          entry point pads to, and the micro-batcher's ``batch_max`` bucket,
        * filtered and unfiltered,
        * every embedder token-length bucket (16, 32, ...,
          max_sequence_length), sized through the live tokenizer,
        * device k 32 (every max_results up to 24), and the two
          flat-boundary escalation streams.

        Runs throwaway queries past the query cache. A failed batch is
        logged and leaves ``is_warm`` False; warmup never raises."""
        if batch_sizes is None:
            batch_sizes = sorted({
                *BATCH_BUCKETS,
                batch_bucket(self.config.server.batch_max),
            })
        probes = self._length_bucket_probes()
        wide_dates = (_dt.date(1700, 1, 1), _dt.date(2100, 1, 1))
        ok = True
        for b in batch_sizes:
            for probe in probes:
                for filtered in (False, True):
                    qs = [
                        SearchQuery(
                            query=f"{probe} {i}",
                            config=SearchConfig(),
                            court_filter=(
                                ["__warmup__"] if filtered else None
                            ),
                            date_range=wide_dates if filtered else None,
                        )
                        for i in range(b)
                    ]
                    try:
                        self._execute_batch(qs)
                    except Exception as e:  # warmup must never block serving
                        ok = False
                        _log.warning(
                            "warmup batch %d (filtered=%s) failed: %s",
                            b, filtered, e,
                        )
        # flat-boundary escalation programs (2 extra shapes at the fixed
        # ESCALATE_BUCKET; k=32 is the serving k bucket for any sane
        # max_results — same bucketing as _execute_batch_fused)
        if self.config.search.use_fused_device_path:
            try:
                self._get_fused().warm_escalation(
                    k=32,
                    overfetch=self.config.search.fused_overfetch,
                    recall_target=self.config.search.fused_recall_target,
                )
            except Exception as e:
                ok = False
                _log.warning("escalation warmup failed: %s", e)
        self.is_warm = ok

    def _length_bucket_probes(self) -> tuple[str, ...]:
        """One probe text per embedder token-length bucket (16, 32, ...,
        max_sequence_length), sized through the LIVE tokenizer so each
        lands inside its bucket even after warmup appends a ``" {i}"``
        suffix. Embedders without a tokenizer (test/harness doubles) fall
        back to a short + long probe pair."""
        emb = getattr(self.vector_index, "embedder", None)
        tok = getattr(emb, "tokenizer", None)
        cfg = getattr(emb, "config", None)
        if tok is None or cfg is None:
            return (
                "warmup probe query",
                "a longer warmup probe query exercising the next token "
                "length bucket of the embedding model pipeline for serving",
            )
        max_len = cfg.max_sequence_length
        word = "process"
        try:
            _, m = tok.encode(" ".join([word] * 8), max_len)
            per_word = max(1, (int(sum(m)) - 2 + 7) // 8)
        except Exception:
            per_word = 1
        probes, bucket = [], 16
        while True:
            # land at ~bucket-6 tokens: inside (bucket/2, bucket] with
            # margin for the " {i}" suffix warmup appends
            n_words = max(1, (bucket - 6) // per_word)
            probes.append(" ".join([word] * n_words))
            if bucket >= max_len:
                break
            bucket *= 2
        return tuple(probes)

    # -- public API ----------------------------------------------------------

    def search(self, query: str) -> list[SearchResult]:
        return self.search_with_params(
            SearchQuery(
                query=query,
                max_results=self.config.search.default_max_results,
            )
        )

    def search_with_params(self, query: SearchQuery) -> list[SearchResult]:
        return self.search_batch([query])[0]

    def search_batch(self, queries: Sequence[SearchQuery]) -> list[list[SearchResult]]:
        """Batched hot path: one device step per stage for the whole batch
        (the micro-batching API layer feeds this). The TTL query cache sits
        on this path: repeated queries never reach the device, and only the
        cache misses form the batch."""
        queries = list(queries)
        for q in queries:
            self.validate_query(q)
        use_cache = self.config.search.enable_query_cache
        results: list[Optional[list[SearchResult]]] = [None] * len(queries)
        miss_idx = list(range(len(queries)))
        keys: list[Optional[str]] = [None] * len(queries)
        if use_cache:
            miss_idx = []
            for i, q in enumerate(queries):
                keys[i] = self._cache_key(q)
                cached = self.query_cache.get(keys[i])
                if cached is not None:
                    results[i] = cached
                else:
                    miss_idx.append(i)
        if miss_idx:
            with metrics.timed("search_batch"):
                fresh = self._execute_batch([queries[i] for i in miss_idx])
            for j, i in enumerate(miss_idx):
                results[i] = fresh[j]
                if use_cache:
                    self.query_cache.put(keys[i], fresh[j])
        metrics.inc("queries", len(queries))
        with self._lock:
            self._queries_served += len(queries)
        return results  # type: ignore[return-value]

    # -- hybrid execution ------------------------------------------------------

    def _get_fused(self):
        with self._lock:
            if self._fused is None:
                self._fused = FusedHybridSearch(
                    self.trie_index,
                    self.vector_index,
                    self.columns,
                    ann_mode=self.config.search.fused_ann_mode,
                    mesh=self.mesh,
                    flat_escalate_eps=(
                        self.config.search.fused_flat_escalate_eps
                        if self.config.search.fused_flat_escalate else 0.0
                    ),
                )
            return self._fused

    #: fused-path SRC_* code → MatchType (the staged path's span types)
    _SRC_MATCH_TYPE = {
        0: MatchType.SEMANTIC,
        1: MatchType.CASE_NAME,
        2: MatchType.CITATION,
        3: MatchType.EXACT,
    }

    def _execute_batch_fused(
        self, queries: list[SearchQuery]
    ) -> list[list[SearchResult]]:
        """Fused device path: scan + filters + boost + dedup by case + top-k
        in one ``query_batch`` step, then host hydration of at most
        max_results rows. The device returns k *distinct* cases, so k only
        needs slack for hydration failures, not a chunks-per-case
        multiplier."""
        texts = [q.query for q in queries]
        with metrics.timed("fused_embed"):
            embs = self.vector_index.generate_embeddings(texts)
        fused = self._get_fused()
        max_limit = max(
            (q.max_results or q.config.max_results) for q in queries
        )
        # Device k bucketed to {32, 64, 128} (the JAX package's rule: k is
        # a compiled shape there). Any max_results <= 24 shares k=32, and
        # both packages return the same rows for the same request.
        k_req = min(128, max(16, max_limit + 8))
        k_bucket = 32
        while k_bucket < k_req:
            k_bucket <<= 1
        with metrics.timed("fused_device"):
            vals, chunks, cases, srcs = fused.query_batch(
                embs,
                texts,
                court_filters=[q.court_filter for q in queries],
                date_ranges=[q.date_range for q in queries],
                min_similarity=[q.config.min_similarity for q in queries],
                exact_weight=[q.config.exact_match_weight for q in queries],
                k=k_bucket,
                overfetch=self.config.search.fused_overfetch,
                recall_target=self.config.search.fused_recall_target,
            )
        # batch-prefetch hydration state for every result row the device
        # returned: one sqlite IN(...) select for metadata and one for
        # texts instead of a round trip per result.
        rows_needed = sorted({
            int(r)
            for b in range(len(queries))
            for r, s in zip(cases[b], vals[b])
            if r >= 0 and np.isfinite(s)
        })
        meta_miss = [
            r for r in rows_needed
            if r < len(self.columns) and self._meta_cache.get(r) is None
        ]
        if meta_miss:
            fetched = self.storage.get_case_metadata_many(
                [self.columns.case_ids[r] for r in meta_miss]
            )
            for r in meta_miss:
                m = fetched.get(str(self.columns.case_ids[r]))
                if m is not None:
                    self._meta_cache.put(r, m)
            text_miss = [
                str(self.columns.case_ids[r]) for r in meta_miss
                if self._text_cache.get(str(self.columns.case_ids[r])) is None
            ]
            for cid, txt in self.storage.get_case_texts_many(
                text_miss
            ).items():
                self._text_cache.put(cid, txt)

        results: list[list[SearchResult]] = []
        for b, q in enumerate(queries):
            limit = q.max_results or q.config.max_results
            out: list[SearchResult] = []
            for score, chunk, case_row, src in zip(
                vals[b], chunks[b], cases[b], srcs[b]
            ):
                if case_row < 0 or not np.isfinite(score):
                    continue
                meta = self._hydrate(int(case_row))
                if meta is None:
                    continue
                mtype = self._SRC_MATCH_TYPE.get(int(src), MatchType.SEMANTIC)
                para = int(fused.chunk_para[int(chunk)]) if chunk >= 0 else -1
                out.append(self._result(q, meta, score, mtype, para))
                if len(out) >= limit:
                    break
            results.append(out)
        return results

    def _execute_batch(self, queries: list[SearchQuery]) -> list[list[SearchResult]]:
        if (
            (self.config.search.use_fused_device_path or self.mesh is not None)
            and self.vector_index.vectors is not None
            and len(self.vector_index.vectors)
            and all(
                q.config.enable_prefix and q.config.enable_semantic
                for q in queries
            )
        ):
            return self._execute_batch_fused(queries)
        B = len(queries)
        texts = [q.query for q in queries]

        # Stage 1: batched trie walk across all three tries (device).
        trie_rows = trie_valid = None
        if any(q.config.enable_prefix for q in queries):
            trie_rows, trie_valid = self.trie_index.search_batch_rows(texts)

        # Stage 2: batched semantic scan (device). ANN feed = top-50
        # clamped by vector.max_ann_results.
        sem_hits = None
        if any(q.config.enable_semantic for q in queries):
            ann_k = max(1, min(50, self.config.vector.max_ann_results))
            sem_hits = self.vector_index.search_batch(texts, top_k=ann_k)

        # Stage 3: merge / dedup / filter / truncate per query (host; ≤~200
        # candidate rows per query by construction).
        results: list[list[SearchResult]] = []
        # search_batch_rows concatenates [name | citation | content] spans of
        # equal width; the span a hit came from determines its MatchType.
        span = trie_rows.shape[1] // 3 if trie_rows is not None else 0
        span_types = (MatchType.CASE_NAME, MatchType.CITATION, MatchType.EXACT)
        for b, q in enumerate(queries):
            cands: dict[int, tuple[float, MatchType, int]] = {}  # row → (score, type, para)
            if trie_rows is not None and q.config.enable_prefix:
                cols = np.nonzero(trie_valid[b])[0]
                for col in cols:
                    row = int(trie_rows[b][col])
                    if row not in cands:
                        mtype = span_types[min(col // span, 2)]
                        cands[row] = (q.config.exact_match_weight, mtype, 0)
            if sem_hits is not None and q.config.enable_semantic:
                for hit in sem_hits[b]:
                    if hit.similarity_score < q.config.min_similarity:
                        continue
                    prev = cands.get(hit.row)
                    if prev is None:  # dedup by case id
                        cands[hit.row] = (
                            hit.similarity_score,
                            MatchType.SEMANTIC,
                            hit.paragraph_index,
                        )
            rows = self._apply_filters(list(cands.keys()), q)
            scored = sorted(
                ((cands[r][0], r) for r in rows),
                key=lambda t: (-t[0], t[1]),  # deterministic ties by row id
            )
            limit = q.max_results or q.config.max_results
            out: list[SearchResult] = []
            for score, row in scored[:limit]:
                meta = self._hydrate(row)
                if meta is None:
                    continue
                _, mtype, para = cands[row]
                out.append(self._result(q, meta, score, mtype, para))
            results.append(out)
        return results

    #: match type → highlight type of its snippet (semantic otherwise)
    _HIGHLIGHT = {
        MatchType.EXACT: HighlightType.EXACT_MATCH,
        MatchType.CASE_NAME: HighlightType.CASE_NAME,
        MatchType.CITATION: HighlightType.CITATION,
    }

    def _result(
        self, q: SearchQuery, meta: CaseMetadata, score: float, mtype: MatchType, para: int
    ) -> SearchResult:
        """One hydrated hit with its snippet and highlights. Semantic hits
        anchor the snippet on the matched chunk: ``para`` indexes the
        *processed* sentence list (min-length filtered, wrapped,
        whitespace-collapsed), so the builder's normalize → sentences
        pipeline is replayed on the stored text; raw offsets would drift
        whenever a short sentence was filtered out."""
        text = self._case_text_of(meta.id) or meta.full_text
        chunk_text = None
        if mtype == MatchType.SEMANTIC and text:
            sents = self._sentences_of(meta.id, text)
            if 0 <= para < len(sents):
                chunk_text = sents[para]
        snippet, highlights = generate_snippet(
            text or meta.name, q.query,
            highlight_type=self._HIGHLIGHT.get(mtype, HighlightType.SEMANTIC_MATCH),
            chunk_text=chunk_text,
        )
        return SearchResult(
            case_metadata=meta, score=float(score), match_type=mtype,
            snippet=snippet, highlights=highlights,
        )

    # -- filters, on the int metadata columns ----------------------------------

    def _apply_filters(self, rows: list[int], q: SearchQuery) -> list[int]:
        if not rows:
            return rows
        arr = np.asarray(rows, np.int64)
        arr = arr[(arr >= 0) & (arr < len(self.columns))]
        keep = np.ones(len(arr), bool)
        if q.court_filter:
            wanted = {
                self.columns.court_vocab.get(c.strip(), -2) for c in q.court_filter
            }
            court_ids = self.columns.court_ids[arr]
            keep &= np.isin(court_ids, list(wanted))
        if q.date_range:
            lo, hi = self.columns.encode_date_range(q.date_range)
            dates = self.columns.dates[arr]
            keep &= (dates >= lo) & (dates <= hi)
        return [int(r) for r in arr[keep]]

    def _hydrate(self, row: int) -> Optional[CaseMetadata]:
        if row < 0 or row >= len(self.columns):
            return None
        meta = self._meta_cache.get(row)
        if meta is None:
            meta = self.storage.get_case_metadata(self.columns.case_ids[row])
            if meta is not None:
                self._meta_cache.put(row, meta)
        return meta

    def _case_text_of(self, case_id) -> Optional[str]:
        """LRU'd ``storage.get_case_text`` (gzip decompress per call).
        Keys normalise to ``str`` — CaseId is a UUID, but the batch
        prefetch fills the cache from sqlite's string ids."""
        key = str(case_id)
        text = self._text_cache.get(key)
        if text is None:
            text = self.storage.get_case_text(case_id)
            if text is not None:
                self._text_cache.put(key, text)
        return text

    # -- validation ------------------------------------------------------------

    def validate_query(self, query: SearchQuery) -> None:
        n = len(query.query)
        if n < self.config.search.min_query_length:
            raise InvalidSearchQuery(
                query=query.query,
                reason=f"Query too short: minimum {self.config.search.min_query_length} characters",
            )
        if n > self.config.search.max_query_length:
            raise InvalidSearchQuery(
                query=query.query,
                reason=f"Query too long: maximum {self.config.search.max_query_length} characters",
            )

    def _cache_key(self, q: SearchQuery) -> str:
        parts = [q.query, str(q.max_results), str(q.court_filter)]
        if q.date_range:
            parts.append(
                f"{date_to_int(q.date_range[0]) if q.date_range[0] else ''}-"
                f"{date_to_int(q.date_range[1]) if q.date_range[1] else ''}"
            )
        parts.append(
            f"{q.config.min_similarity}:{q.config.exact_match_weight}:"
            f"{q.config.enable_semantic}:{q.config.enable_prefix}:{q.config.max_results}"
        )
        return "|".join(parts)

    # -- ops surface -----------------------------------------------------------

    def health_check(self) -> None:
        self.storage.health_check()
        # indexes are plain frozen arrays; verify they answer
        _ = self.trie_index.get_stats()

    def get_stats(self) -> SearchEngineStats:
        return SearchEngineStats(
            total_cases_indexed=len(self.columns),
            vector_index_stats=self.vector_index.get_stats(),
            trie_stats=self.trie_index.get_stats(),
            cache_stats=self.query_cache.get_stats(),
            queries_served=self._queries_served,
            escalated_queries=(
                self._fused.escalated if self._fused is not None else 0
            ),
        )
