"""Ingestion manager: jobs, the source registry, and the bulk and
incremental runs (port of ``trie_semantic_search_tpu/ingest/
manager.py``):

* jobs (:class:`IngestionJob`) of five types (bulk from every source or
  one, incremental from every source or one, reprocess) through the
  states queued → running → completed / failed / cancelled / paused
* sources registered and looked up by name
* the bulk run (the pipeline's batches) and the incremental run, which
  starts from each source's last-update watermark and fetches the
  updated cases one by one under a ``max_concurrent_downloads`` semaphore
* reprocessing of every stored case, pause, resume and cancel, and the
  ``on_ingest_complete`` hook after a job that stored something (where a
  caller rebuilds its indexes).
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import enum
import itertools
import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.config import Config
from ..core.errors import SourceUnavailable
from ..storage.store import StorageManager
from .cache import CacheManager
from .pipeline import IngestionPipeline, PipelineStats
from .sources.base import CasePayload, DataSource

_log = logging.getLogger("tss_torch.ingest.manager")


class IngestionJobType(str, enum.Enum):
    BULK_ALL = "bulk_all"
    BULK_SOURCE = "bulk_source"
    INCREMENTAL_ALL = "incremental_all"
    INCREMENTAL_SOURCE = "incremental_source"
    REPROCESS = "reprocess"


class JobStatus(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"
    PAUSED = "paused"


#: job ids, numbered from 1 in each process as in the JAX package
_job_ids = itertools.count(1)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


@dataclass
class IngestionJob:
    job_type: IngestionJobType
    source: Optional[str] = None
    limit: Optional[int] = None
    id: int = field(default_factory=lambda: next(_job_ids))
    status: JobStatus = JobStatus.QUEUED
    created_at: _dt.datetime = field(default_factory=_now)
    started_at: Optional[_dt.datetime] = None
    finished_at: Optional[_dt.datetime] = None
    error: Optional[str] = None
    stats: Optional[PipelineStats] = None


@dataclass
class IngestionStats:
    """Totals across jobs."""

    jobs_run: int = 0
    jobs_failed: int = 0
    total_processed: int = 0
    total_skipped: int = 0
    total_failed_validation: int = 0
    last_run: Optional[_dt.datetime] = None


class IngestionManager:
    def __init__(
        self,
        config: Config,
        storage: StorageManager,
        pipeline: Optional[IngestionPipeline] = None,
        cache_manager: Optional[CacheManager] = None,
        on_ingest_complete: Optional[Callable[[], None]] = None,
    ):
        self.config = config
        self.storage = storage
        self.cache = cache_manager or CacheManager(config.ingestion.cache)
        self.pipeline = pipeline or IngestionPipeline(
            config.ingestion, storage, text_config=config.text_processing, cache_manager=self.cache,
        )
        self.sources: dict[str, DataSource] = {}
        self.jobs: list[IngestionJob] = []
        self.stats = IngestionStats()
        self._dl_sem = asyncio.Semaphore(max(1, config.ingestion.max_concurrent_downloads))
        #: called after a job that stored cases: the index rebuild hook
        self.on_ingest_complete = on_ingest_complete

    # -- registry -----------------------------------------------------------

    def register_source(self, source: DataSource) -> None:
        self.sources[source.name] = source

    def get_source(self, name: str) -> DataSource:
        try:
            return self.sources[name]
        except KeyError:
            raise SourceUnavailable(source=name, details="not registered") from None

    # -- job execution ------------------------------------------------------

    async def run_job(self, job: IngestionJob) -> IngestionJob:
        """Run ``job`` to its end; a failure is recorded in the job (status
        FAILED, ``error``), not raised."""
        self.jobs.append(job)
        job.status = JobStatus.PAUSED if self.pipeline.paused else JobStatus.RUNNING
        job.started_at = _now()
        try:
            if job.job_type == IngestionJobType.REPROCESS:
                job.stats = await asyncio.to_thread(self._reprocess_all)
                job.status = JobStatus.COMPLETED
                self.stats.jobs_run += 1
                self.stats.last_run = _now()
                if self.on_ingest_complete and job.stats.processed:
                    self.on_ingest_complete()
                return job
            if job.job_type in (IngestionJobType.BULK_ALL, IngestionJobType.INCREMENTAL_ALL):
                targets = list(self.sources.values())
            else:
                targets = [self.get_source(job.source or "")]
            incremental = job.job_type in (
                IngestionJobType.INCREMENTAL_ALL, IngestionJobType.INCREMENTAL_SOURCE,
            )
            agg = PipelineStats()
            for src in targets:
                stats = await self._ingest_source(src, job.limit, incremental)
                agg.total_cases += stats.total_cases
                agg.processed += stats.processed
                agg.skipped_duplicates += stats.skipped_duplicates
                agg.failed_validation += stats.failed_validation
                agg.failed_processing += stats.failed_processing
            job.stats = agg
            job.status = (
                JobStatus.CANCELLED if self.pipeline._shutdown.is_set() else JobStatus.COMPLETED
            )
            self.stats.jobs_run += 1
            self.stats.total_processed += agg.processed
            self.stats.total_skipped += agg.skipped_duplicates
            self.stats.total_failed_validation += agg.failed_validation
            self.stats.last_run = _now()
            if self.on_ingest_complete and agg.processed:
                self.on_ingest_complete()
        except Exception as e:  # the job records its failure; the manager goes on
            job.status = JobStatus.FAILED
            job.error = str(e)
            self.stats.jobs_failed += 1
            _log.error("ingestion job %d failed: %s", job.id, e)
        finally:
            job.finished_at = _now()
        return job

    async def ingest_bulk(
        self, source_name: Optional[str] = None, limit: Optional[int] = None
    ) -> IngestionJob:
        """Every case of one source (or of every source)."""
        job = IngestionJob(
            job_type=IngestionJobType.BULK_SOURCE if source_name else IngestionJobType.BULK_ALL,
            source=source_name,
            limit=limit,
        )
        return await self.run_job(job)

    async def check_for_updates(
        self, source_name: Optional[str] = None, limit: Optional[int] = None
    ) -> IngestionJob:
        """Incremental ingest from each source's last watermark."""
        job = IngestionJob(
            job_type=IngestionJobType.INCREMENTAL_SOURCE
            if source_name
            else IngestionJobType.INCREMENTAL_ALL,
            source=source_name,
            limit=limit,
        )
        return await self.run_job(job)

    async def cancel(self) -> None:
        """Stop ingestion at the next batch boundary: the running job
        finishes as CANCELLED."""
        await self.pipeline.shutdown()

    def pause(self) -> None:
        """Hold running jobs at the next batch boundary and mark them
        PAUSED."""
        self.pipeline.pause()
        for job in self.jobs:
            if job.status == JobStatus.RUNNING:
                job.status = JobStatus.PAUSED

    def resume(self) -> None:
        """Release paused jobs back to RUNNING."""
        self.pipeline.resume()
        for job in self.jobs:
            if job.status == JobStatus.PAUSED:
                job.status = JobStatus.RUNNING

    async def reprocess(self) -> IngestionJob:
        """Text processing and metadata enhancement again over every
        stored case."""
        return await self.run_job(IngestionJob(job_type=IngestionJobType.REPROCESS))

    def _reprocess_all(self) -> PipelineStats:
        stats = PipelineStats()
        for meta, text in self.storage.iter_cases():
            stats.total_cases += 1
            try:
                processed = self.pipeline.text_processor.process_text(text)
                # the enriched fields derived again from scratch
                meta.word_count = processed.stats.word_count
                if processed.citations:
                    meta.citations = [c.normalized for c in processed.citations]
                    if not meta.citation:
                        meta.citation = meta.citations[0]
                self.pipeline._enhance_metadata(meta, processed)
                self.storage.store_case_metadata(meta)
                stats.processed += 1
            except Exception as e:  # one bad case must not stop the job
                stats.failed_processing += 1
                _log.warning("reprocess failed for %s: %s", meta.id, e)
        self.storage.flush()
        return stats

    # -- internals ----------------------------------------------------------

    async def _ingest_source(
        self, source: DataSource, limit: Optional[int], incremental: bool
    ) -> PipelineStats:
        if incremental:
            since = self.cache.get_last_update(source.name)
            if since is not None:
                return await self._ingest_updates(source, since, limit)
        stats = await self.pipeline.run_ingestion(source, limit)
        self.cache.set_last_update(source.name, _now())
        return stats

    async def _ingest_updates(
        self, source: DataSource, since: _dt.datetime, limit: Optional[int]
    ) -> PipelineStats:
        """The cases updated since the watermark, one at a time through the
        pipeline's per-case flow; then the watermark moves to now."""
        updated = await source.list_updated_cases(since, limit)
        if not updated:
            _log.info("%s: no updates since %s", source.name, since)
            self.cache.set_last_update(source.name, _now())
            return PipelineStats()
        payloads = await self._fetch_concurrent(source, updated)
        stats = PipelineStats(total_cases=len(payloads))
        for p in payloads:
            try:
                outcome = await asyncio.to_thread(self.pipeline.process_single_case, *p)
                if outcome == "stored":
                    stats.processed += 1
                elif outcome == "duplicate":
                    stats.skipped_duplicates += 1
                else:
                    stats.failed_validation += 1
            except Exception as e:  # one bad case must not stop the job
                stats.failed_processing += 1
                _log.warning("incremental case failed: %s", e)
        self.cache.set_last_update(source.name, _now())
        return stats

    async def _fetch_concurrent(self, source: DataSource, ids: list[str]) -> list[CasePayload]:
        """Single-case downloads under the download semaphore; a failed
        download is logged and left out."""

        async def one(cid: str) -> Optional[CasePayload]:
            async with self._dl_sem:
                try:
                    return await source.fetch_case(cid)
                except Exception as e:  # one failed download must not stop the rest
                    _log.warning("fetch %s failed: %s", cid, e)
                    return None

        results = await asyncio.gather(*(one(c) for c in ids))
        return [r for r in results if r is not None]

    # -- operations ---------------------------------------------------------

    def get_stats(self) -> IngestionStats:
        return self.stats

    def get_jobs(self) -> list[IngestionJob]:
        return list(self.jobs)

    async def shutdown(self) -> None:
        await self.pipeline.shutdown()
