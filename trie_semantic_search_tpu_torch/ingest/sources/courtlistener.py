"""CourtListener data source (port of ``trie_semantic_search_tpu/ingest/
sources/courtlistener.py``), against the REST v3 shape of the config's
``api_url``:

* ``GET /search/?type=o`` for discovery (opinion search results)
* ``GET /opinions/{id}/`` and its cluster for one case's full data
* token auth (``Authorization: Token <key>``), 429 back-off, and an
  injectable transport (an ``httpx.AsyncClient``).
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import logging
import re
import time
from typing import Any, Optional

import httpx

from ...core.config import CourtListenerConfig
from ...core.errors import NetworkError, ParseError, RateLimitExceeded
from ...core.types import CaseMetadata, Jurisdiction, new_case_id
from .base import CasePayload, DataSource, RateLimiter, RateLimits, SourceHealth, SourceInfo

_log = logging.getLogger("tss_torch.ingest.courtlistener")

_TAG_RE = re.compile(r"<[^>]+>")


def _strip_html(text: str) -> str:
    return _TAG_RE.sub(" ", text).replace("&amp;", "&").replace("&nbsp;", " ").strip()


class CourtListenerDataSource(DataSource):
    def __init__(
        self,
        config: Optional[CourtListenerConfig] = None,
        client: Optional[httpx.AsyncClient] = None,
        requests_per_minute: int = 60,
        page_size: int = 50,
        backoff_seconds: float = 60.0,
    ):
        super().__init__()
        self.config = config or CourtListenerConfig()
        headers = {}
        if self.config.api_key:
            headers["Authorization"] = f"Token {self.config.api_key}"
        self.client = client or httpx.AsyncClient(
            headers=headers, timeout=30.0, follow_redirects=True
        )
        self.rate_limiter = RateLimiter(requests_per_minute)
        self.page_size = page_size
        self.backoff_seconds = backoff_seconds

    @property
    def name(self) -> str:
        return "courtlistener"

    def get_source_info(self) -> SourceInfo:
        return SourceInfo(
            name="courtlistener",
            description="CourtListener (Free Law Project) REST v3",
            base_url=self.config.api_url,
            requires_auth=self.config.api_key is not None,
            supports_incremental=True,
        )

    def get_rate_limits(self) -> RateLimits:
        return RateLimits(
            requests_per_minute=int(60 / self.rate_limiter.min_interval),
            concurrent_requests=1,
        )

    # -- HTTP ---------------------------------------------------------------

    async def _get(self, url: str) -> dict[str, Any]:
        await self.rate_limiter.acquire()
        self.stats.requests_made += 1
        try:
            resp = await self.client.get(url)
        except httpx.HTTPError as e:
            self.stats.errors += 1
            raise NetworkError(f"CourtListener request: {e}") from e
        if resp.status_code == 429:
            self.stats.rate_limit_hits += 1
            await asyncio.sleep(self.backoff_seconds)
            raise RateLimitExceeded("CourtListener API")
        if resp.status_code >= 400:
            self.stats.errors += 1
            raise NetworkError(f"HTTP {resp.status_code}: {resp.text[:200]}")
        self.stats.bytes_downloaded += len(resp.content)
        try:
            return resp.json()
        except ValueError as e:
            raise ParseError(source="CourtListener API", details=str(e)) from e

    def _url(self, path: str) -> str:
        return self.config.api_url.rstrip("/") + "/" + path.lstrip("/")

    async def _page_ids(self, path: str) -> list[str]:
        page = await self._get(self._url(path))
        return [str(r["id"]) for r in page.get("results", []) if "id" in r]

    # -- fetching -----------------------------------------------------------

    async def fetch_cases(self, limit: Optional[int] = None) -> list[CasePayload]:
        out: list[CasePayload] = []
        url: Optional[str] = self._url(f"search/?type=o&page_size={self.page_size}")
        while url:
            page = await self._get(url)
            for hit in page.get("results", []):
                try:
                    out.append(self.convert_search_hit(hit))
                except ParseError as e:
                    self.stats.errors += 1
                    _log.warning("skipping malformed CL case: %s", e)
                if limit is not None and len(out) >= limit:
                    break
            if limit is not None and len(out) >= limit:
                break
            url = page.get("next")
        self.stats.cases_fetched += len(out)
        self.stats.last_fetch = _dt.datetime.now(_dt.timezone.utc)
        return out

    async def fetch_case(self, case_id: str) -> Optional[CasePayload]:
        op = await self._get(self._url(f"opinions/{case_id}/"))
        cluster: dict[str, Any] = {}
        cluster_url = op.get("cluster")
        if cluster_url:
            try:
                cluster = await self._get(cluster_url)
            except NetworkError:
                cluster = {}
        return self.convert_opinion(op, cluster)

    async def list_available_cases(self, limit: Optional[int] = None) -> list[str]:
        url: Optional[str] = self._url(f"search/?type=o&page_size={self.page_size}")
        ids: list[str] = []
        while url:
            page = await self._get(url)
            ids.extend(str(r["id"]) for r in page.get("results", []) if "id" in r)
            if limit is not None and len(ids) >= limit:
                return ids[:limit]
            url = page.get("next")
        return ids

    async def list_updated_cases(self, since: _dt.datetime, limit: Optional[int] = None) -> list[str]:
        ids = await self._page_ids(f"search/?type=o&filed_after={since.date().isoformat()}"
                                   f"&page_size={self.page_size}")
        return ids[:limit] if limit else ids

    async def search_cases(self, query: str, limit: Optional[int] = None) -> list[str]:
        q = httpx.QueryParams({"q": query})["q"]
        ids = await self._page_ids(f"search/?type=o&q={q}&page_size={self.page_size}")
        return ids[:limit] if limit else ids

    async def health_check(self) -> SourceHealth:
        t0 = time.perf_counter()
        try:
            await self._get(self._url("search/?type=o&page_size=1"))
            return SourceHealth(
                healthy=True,
                message="CourtListener API reachable",
                last_check=_dt.datetime.now(_dt.timezone.utc),
                response_time_ms=(time.perf_counter() - t0) * 1000,
            )
        except Exception as e:  # any failure is an unhealthy source, reported
            return SourceHealth(
                healthy=False, message=str(e), last_check=_dt.datetime.now(_dt.timezone.utc)
            )

    # -- conversion ---------------------------------------------------------

    @staticmethod
    def convert_search_hit(hit: dict[str, Any]) -> CasePayload:
        try:
            name = hit.get("caseName") or hit["case_name"]
        except KeyError as e:
            raise ParseError(source="CourtListener hit", details=str(e)) from e
        date_str = hit.get("dateFiled") or hit.get("date_filed") or ""
        try:
            decision_date = _dt.date.fromisoformat(date_str[:10])
        except ValueError as e:
            raise ParseError(source="CourtListener dateFiled", details=str(e)) from e
        citations = hit.get("citation") or []
        if isinstance(citations, str):
            citations = [citations]
        meta = CaseMetadata(
            id=new_case_id(),
            name=name,
            citation=citations[0] if citations else "",
            court=hit.get("court") or hit.get("court_citation_string", ""),
            decision_date=decision_date,
            judges=[j for j in (hit.get("judge") or "").split(";") if j.strip()],
            citations=list(citations),
            jurisdiction=Jurisdiction.federal(),
            docket_number=hit.get("docketNumber") or hit.get("docket_number"),
            source_url=hit.get("absolute_url"),
        )
        text = _strip_html(hit.get("snippet") or hit.get("text") or "")
        if not text:
            text = f"Case: {name}\nCourt: {meta.court}\nDate: {date_str}"
        return meta, text

    @staticmethod
    def convert_opinion(op: dict[str, Any], cluster: dict[str, Any]) -> CasePayload:
        name = cluster.get("case_name") or f"Opinion {op.get('id', '')}"
        date_str = cluster.get("date_filed") or "1970-01-01"
        try:
            decision_date = _dt.date.fromisoformat(date_str[:10])
        except ValueError:
            decision_date = _dt.date(1970, 1, 1)
        citations = [
            f"{c.get('volume', '')} {c.get('reporter', '')} {c.get('page', '')}".strip()
            for c in cluster.get("citations", [])
        ]
        meta = CaseMetadata(
            id=new_case_id(),
            name=name,
            citation=citations[0] if citations else "",
            court=str(cluster.get("court", "") or ""),
            decision_date=decision_date,
            judges=[j for j in (cluster.get("judges") or "").split(",") if j.strip()],
            citations=citations,
            jurisdiction=Jurisdiction.federal(),
            docket_number=cluster.get("docket"),
            source_url=op.get("absolute_url"),
        )
        text = (
            op.get("plain_text")
            or _strip_html(op.get("html") or "")
            or f"Case: {name}\nDate: {date_str}"
        )
        return meta, text

    async def aclose(self) -> None:
        await self.client.aclose()
