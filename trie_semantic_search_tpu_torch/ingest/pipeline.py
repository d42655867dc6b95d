"""Ingestion pipeline: fetch → validate → process → store, with a cache
(port of ``trie_semantic_search_tpu/ingest/pipeline.py``, the same
per-case dataflow and batch orchestration):

* per case (:meth:`IngestionPipeline.process_single_case`): the duplicate
  check on (name, citation) → the processed-case cache → validation →
  ``TextProcessor.process_text`` → metadata enhancement (word count,
  citations and judges backfilled from the extraction) → the store, with
  the duplicate check repeated under a lock → the cache
* batches of ``batch_size`` cases, each case in a worker thread
  (``asyncio.to_thread``) under a ``max_concurrent_jobs`` semaphore; a
  sleep of ``rate_limit_delay_ms`` between batches; pause and resume at
  batch boundaries; a memory watchdog every 10 batches that clears the
  memory cache over ``max_memory_usage_mb``
* the fetch retried ``retry_attempts`` times on recoverable errors
* stats: processed, failed and skipped counts, cache hits, rate, ETA and
  memory. The workers update them under a lock of their own (the JAX
  package increments them from its workers without one).
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..core.config import Config, IngestionConfig, TextProcessingConfig
from ..core.errors import SearchError, SourceUnavailable
from ..core.types import CaseMetadata
from ..storage.store import StorageManager
from ..text.processor import EntityType, TextProcessor
from ..utils import SystemUtils
from .cache import CacheManager, content_key
from .sources.base import CasePayload, DataSource
from .validation import CaseValidator

_log = logging.getLogger("tss_torch.ingest.pipeline")


@dataclass
class MemoryStats:
    rss_bytes: Optional[int] = None
    cache_purges: int = 0


@dataclass
class PipelineStats:
    total_cases: int = 0
    processed: int = 0
    skipped_duplicates: int = 0
    failed_validation: int = 0
    failed_processing: int = 0
    cache_hits: int = 0
    batches_completed: int = 0
    started_at: Optional[_dt.datetime] = None
    finished_at: Optional[_dt.datetime] = None
    elapsed_seconds: float = 0.0
    cases_per_second: float = 0.0
    eta_seconds: Optional[float] = None
    memory: MemoryStats = field(default_factory=MemoryStats)


class IngestionPipeline:
    def __init__(
        self,
        config: IngestionConfig,
        storage: StorageManager,
        text_config: Optional[TextProcessingConfig] = None,
        cache_manager: Optional[CacheManager] = None,
    ):
        self.config = config
        self.storage = storage
        self.text_processor = TextProcessor(text_config or TextProcessingConfig())
        self.validator = CaseValidator(config.validation)
        self.cache = cache_manager or CacheManager(config.cache)
        self.stats = PipelineStats()
        self._job_sem = asyncio.Semaphore(max(1, config.max_concurrent_jobs))
        self._shutdown = asyncio.Event()
        # pause gate between batches: set = running, cleared = paused
        self._resume = asyncio.Event()
        self._resume.set()
        self._inflight: set[asyncio.Task] = set()
        # the duplicate check and the store as one step: two workers with
        # the same case would otherwise both pass the check and store it
        self._store_lock = threading.Lock()
        self._stats_lock = threading.Lock()

    def _count(self, name: str) -> None:
        """One more in the stats counter ``name`` (workers call this)."""
        with self._stats_lock:
            setattr(self.stats, name, getattr(self.stats, name) + 1)

    # -- the run ------------------------------------------------------------

    async def run_ingestion(self, source: DataSource, limit: Optional[int] = None) -> PipelineStats:
        self.stats = PipelineStats(started_at=_dt.datetime.now(_dt.timezone.utc))
        self._shutdown.clear()  # a cancel() applies only to the run it interrupts
        t0 = time.perf_counter()

        health = await source.health_check()
        if not health.healthy:
            raise SourceUnavailable(source=source.name, details=health.message)

        cases = await self._fetch_with_retries(source, limit)
        self.stats.total_cases = len(cases)
        _log.info("fetched %d cases from %s", len(cases), source.name)

        bs = max(1, self.config.batch_size)
        batches = [cases[i : i + bs] for i in range(0, len(cases), bs)]
        for bi, batch in enumerate(batches):
            if not self._resume.is_set():
                _log.info("ingestion paused before batch %d", bi)
                # wake on resume or on shutdown (a cancel() during a pause
                # still ends the run)
                rt = asyncio.create_task(self._resume.wait())
                st = asyncio.create_task(self._shutdown.wait())
                _, pending = await asyncio.wait({rt, st}, return_when=asyncio.FIRST_COMPLETED)
                for t in pending:
                    t.cancel()
                _log.info("ingestion resumed at batch %d", bi)
            if self._shutdown.is_set():
                _log.warning("shutdown requested; stopping after %d batches", bi)
                break
            await self._process_batch(batch)
            self.stats.batches_completed += 1
            self._update_progress(t0)
            if (bi + 1) % 10 == 0:
                self._check_memory()
            if self.config.rate_limit_delay_ms and bi + 1 < len(batches):
                await asyncio.sleep(self.config.rate_limit_delay_ms / 1000)

        self.cache.flush()
        self.storage.flush()
        self.stats.finished_at = _dt.datetime.now(_dt.timezone.utc)
        self.stats.elapsed_seconds = time.perf_counter() - t0
        if self.stats.elapsed_seconds > 0:
            self.stats.cases_per_second = self.stats.processed / self.stats.elapsed_seconds
        self.stats.eta_seconds = 0.0
        return self.stats

    async def _fetch_with_retries(self, source: DataSource, limit: Optional[int]) -> list[CasePayload]:
        """``retry_attempts`` fetches ``retry_delay_seconds`` apart; only a
        recoverable error is retried."""
        attempts = max(1, self.config.retry_attempts)
        delay = self.config.retry_delay_seconds
        for attempt in range(attempts):
            try:
                return await source.fetch_cases(limit)
            except SearchError as e:
                if not e.is_recoverable() or attempt == attempts - 1:
                    raise
                _log.warning(
                    "fetch from %s failed (attempt %d/%d): %s; retrying in %ss",
                    source.name, attempt + 1, attempts, e, delay,
                )
                await asyncio.sleep(delay)
        raise AssertionError("unreachable: the last attempt returns or raises")

    async def _process_batch(self, batch: list[CasePayload]) -> None:
        """Every case of the batch in a worker thread, at most
        ``max_concurrent_jobs`` at a time; a case that raises is counted
        and logged, and the others go on."""

        async def run_one(payload: CasePayload) -> None:
            async with self._job_sem:
                try:
                    await asyncio.to_thread(self.process_single_case, *payload)
                except Exception as e:  # one bad case must not stop the batch
                    self._count("failed_processing")
                    _log.warning("case %r failed: %s", payload[0].name, e)

        tasks = [asyncio.ensure_future(run_one(p)) for p in batch]
        self._inflight.update(tasks)
        try:
            await asyncio.gather(*tasks)
        finally:
            self._inflight.difference_update(tasks)

    # -- per case -----------------------------------------------------------

    def process_single_case(self, metadata: CaseMetadata, text: str) -> str:
        """Returns the outcome: "stored" | "duplicate" | "invalid"."""
        # 1. duplicate fast path (unlocked; checked again under the lock)
        if self.storage.find_case_id(metadata.name, metadata.citation) is not None:
            self._count("skipped_duplicates")
            return "duplicate"

        # 2. processed-case cache
        key = content_key(metadata.name, text)
        cached = self.cache.get_processed_case(key)
        if cached is not None:
            meta = CaseMetadata.from_json(cached["metadata"])
            meta.id = metadata.id  # fresh identity, cached enrichment
            if not self._store_once(meta, text):
                return "duplicate"
            self._count("cache_hits")
            self._count("processed")
            return "stored"

        # 3. validate
        result = self.validator.validate_case(metadata, text)
        if not result.passed:
            self._count("failed_validation")
            _log.debug("validation failed for %r: %s", metadata.name,
                       "; ".join(i.message for i in result.errors))
            return "invalid"

        # 4. text processing + metadata enhancement
        processed = self.text_processor.process_text(text)
        self._enhance_metadata(metadata, processed)

        # 5. store (the duplicate check repeated under the lock)
        if not self._store_once(metadata, text):
            return "duplicate"

        # 6. cache the enriched result
        doc = metadata.to_json()
        doc.pop("full_text", None)
        self.cache.store_processed_case(key, {"metadata": doc})
        self._count("processed")
        return "stored"

    def _store_once(self, metadata: CaseMetadata, text: str) -> bool:
        """The duplicate check and the store under one lock. False when
        another worker stored this (name, citation) first."""
        with self._store_lock:
            if self.storage.find_case_id(metadata.name, metadata.citation) is not None:
                self._count("skipped_duplicates")
                return False
            self.storage.store_case_metadata(metadata)
            self.storage.store_case_text(metadata.id, text)
            return True

    def _enhance_metadata(self, metadata: CaseMetadata, processed) -> None:
        """Word count, citations from the extraction, judges from the
        entities, where the source left them empty."""
        if not metadata.word_count:
            metadata.word_count = processed.stats.word_count
        if not metadata.citations and processed.citations:
            metadata.citations = [c.normalized for c in processed.citations]
            if not metadata.citation:
                metadata.citation = metadata.citations[0]
        if not metadata.judges:
            judges = []
            for e in processed.entities:
                if e.entity_type == EntityType.JUDGE and e.text not in judges:
                    judges.append(e.text)
            metadata.judges = judges[:10]

    # -- watchdog and progress ----------------------------------------------

    def _check_memory(self) -> None:
        rss = SystemUtils.memory_usage()
        self.stats.memory.rss_bytes = rss
        limit = self.config.max_memory_usage_mb * 1024 * 1024
        if rss is not None and rss > limit:
            _log.warning("memory %s over limit %s; purging caches",
                         SystemUtils.format_bytes(rss), SystemUtils.format_bytes(limit))
            self.cache.clear_memory_cache()
            self.stats.memory.cache_purges += 1

    def _update_progress(self, t0: float) -> None:
        elapsed = time.perf_counter() - t0
        done = self.stats.processed + self.stats.skipped_duplicates
        if elapsed > 0 and done > 0:
            rate = done / elapsed
            remaining = max(0, self.stats.total_cases - done)
            self.stats.cases_per_second = rate
            self.stats.eta_seconds = remaining / rate if rate > 0 else None

    # -- operations ---------------------------------------------------------

    def get_stats(self) -> PipelineStats:
        return self.stats

    def health_check(self) -> None:
        self.storage.health_check()
        self.cache.health_check()

    def pause(self) -> None:
        """Hold ingestion at the next batch boundary (cases in flight
        finish; nothing new starts until :meth:`resume`)."""
        self._resume.clear()

    def resume(self) -> None:
        self._resume.set()

    @property
    def paused(self) -> bool:
        return not self._resume.is_set()

    async def shutdown(self) -> None:
        """Stop at the next batch boundary, wait for the cases in flight,
        flush the caches and the store."""
        self._shutdown.set()
        if self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)
        self.cache.flush()
        self.storage.flush()


def make_pipeline(config: Config, storage: StorageManager) -> IngestionPipeline:
    return IngestionPipeline(config.ingestion, storage, text_config=config.text_processing)
