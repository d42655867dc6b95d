"""Caselaw Access Project (CAP) data source (port of
``trie_semantic_search_tpu/ingest/sources/cap.py``, the same API contract
and case conversion):

* token auth header (``Authorization: Token <key>``)
* paginated ``GET /cases/?jurisdiction=&decision_date_min/max=&page_size=&
  full_case=true``, following ``next``
* 429 → a rate-limit hit, a back-off sleep, then ``RateLimitExceeded``
* a min-interval rate limiter between requests
* CAP's case JSON → ``(CaseMetadata, full_text)``: head matter, PARTIES and
  ATTORNEYS lines and one ``OPINION (TYPE) by author:`` block per opinion.

The transport is injectable (an ``httpx.AsyncClient``), so the tests run
against an ``httpx.MockTransport``.
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import logging
import time
from typing import Any, Optional

import httpx

from ...core.config import CapConfig
from ...core.errors import NetworkError, ParseError, RateLimitExceeded
from ...core.types import CaseMetadata, Jurisdiction, new_case_id
from .base import CasePayload, DataSource, RateLimiter, RateLimits, SourceHealth, SourceInfo

_log = logging.getLogger("tss_torch.ingest.cap")


class CapDataSource(DataSource):
    def __init__(
        self,
        config: Optional[CapConfig] = None,
        client: Optional[httpx.AsyncClient] = None,
        requests_per_minute: int = 60,
        backoff_seconds: float = 60.0,
        page_size: int = 100,
        jurisdictions: Optional[list[str]] = None,
        date_range: Optional[tuple[Optional[_dt.date], Optional[_dt.date]]] = None,
        fetch_full_text: bool = True,
    ):
        super().__init__()
        self.config = config or CapConfig()
        headers = {}
        if self.config.api_key:
            headers["Authorization"] = f"Token {self.config.api_key}"
        self.client = client or httpx.AsyncClient(
            headers=headers, timeout=30.0, follow_redirects=True
        )
        self.rate_limiter = RateLimiter(requests_per_minute)
        self.backoff_seconds = backoff_seconds
        self.page_size = page_size
        self.jurisdictions = jurisdictions or []
        self.date_range = date_range
        self.fetch_full_text = fetch_full_text

    # -- identity -----------------------------------------------------------

    @property
    def name(self) -> str:
        return "cap"

    def get_source_info(self) -> SourceInfo:
        return SourceInfo(
            name="cap",
            description="Harvard Caselaw Access Project",
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

    def _cases_url(self) -> str:
        return self.config.api_url.rstrip("/") + "/cases/"

    def _first_page_url(self) -> str:
        params = []
        if self.jurisdictions:
            params.append("jurisdiction=" + ",".join(self.jurisdictions))
        if self.date_range:
            start, end = self.date_range
            if start:
                params.append(f"decision_date_min={start.isoformat()}")
            if end:
                params.append(f"decision_date_max={end.isoformat()}")
        params.append(f"page_size={self.page_size}")
        if self.fetch_full_text:
            params.append("full_case=true")
        return self._cases_url() + "?" + "&".join(params)

    async def _fetch_page(self, url: str) -> dict[str, Any]:
        await self.rate_limiter.acquire()
        self.stats.requests_made += 1
        try:
            resp = await self.client.get(url)
        except httpx.HTTPError as e:
            self.stats.errors += 1
            raise NetworkError(f"CAP API request: {e}") from e
        if resp.status_code == 429:
            self.stats.rate_limit_hits += 1
            _log.warning("CAP API rate limit hit, backing off")
            await asyncio.sleep(self.backoff_seconds)
            raise RateLimitExceeded("CAP API")
        if resp.status_code >= 400:
            self.stats.errors += 1
            raise NetworkError(f"HTTP {resp.status_code}: {resp.text[:200]}")
        self.stats.bytes_downloaded += len(resp.content)
        try:
            return resp.json()
        except ValueError as e:
            raise ParseError(source="CAP API", details=str(e)) from e

    async def _ids(self, url: Optional[str], limit: Optional[int]) -> list[str]:
        """Case ids of every page from ``url`` on, at most ``limit``."""
        ids: list[str] = []
        while url:
            page = await self._fetch_page(url)
            ids.extend(str(r["id"]) for r in page.get("results", []) if "id" in r)
            if limit is not None and len(ids) >= limit:
                return ids[:limit]
            url = page.get("next")
        return ids

    # -- fetching -----------------------------------------------------------

    async def fetch_cases(self, limit: Optional[int] = None) -> list[CasePayload]:
        out: list[CasePayload] = []
        url: Optional[str] = self._first_page_url()
        while url:
            page = await self._fetch_page(url)
            for raw in page.get("results", []):
                try:
                    out.append(self.convert_cap_case(raw))
                except ParseError as e:
                    self.stats.errors += 1
                    _log.warning("skipping malformed CAP case: %s", e)
                if limit is not None and len(out) >= limit:
                    break
            if limit is not None and len(out) >= limit:
                break
            url = page.get("next")
        self.stats.cases_fetched += len(out)
        self.stats.last_fetch = _dt.datetime.now(_dt.timezone.utc)
        return out

    async def fetch_case(self, case_id: str) -> Optional[CasePayload]:
        raw = await self._fetch_page(self._cases_url() + f"{case_id}/?full_case=true")
        return self.convert_cap_case(raw)

    async def list_available_cases(self, limit: Optional[int] = None) -> list[str]:
        return await self._ids(self._first_page_url(), limit)

    async def list_updated_cases(self, since: _dt.datetime, limit: Optional[int] = None) -> list[str]:
        url = (f"{self._cases_url()}?last_updated__gte={since.date().isoformat()}"
               f"&page_size={self.page_size}")
        return await self._ids(url, limit)

    async def search_cases(self, query: str, limit: Optional[int] = None) -> list[str]:
        q = httpx.QueryParams({"q": query})["q"]
        page = await self._fetch_page(f"{self._cases_url()}?search={q}&page_size={self.page_size}")
        ids = [str(r["id"]) for r in page.get("results", []) if "id" in r]
        return ids[:limit] if limit else ids

    # -- health -------------------------------------------------------------

    async def health_check(self) -> SourceHealth:
        t0 = time.perf_counter()
        try:
            await self._fetch_page(self._cases_url() + "?page_size=1")
            return SourceHealth(
                healthy=True,
                message="CAP API reachable",
                last_check=_dt.datetime.now(_dt.timezone.utc),
                response_time_ms=(time.perf_counter() - t0) * 1000,
            )
        except Exception as e:  # any failure is an unhealthy source, reported
            return SourceHealth(
                healthy=False, message=str(e), last_check=_dt.datetime.now(_dt.timezone.utc)
            )

    # -- conversion ---------------------------------------------------------

    @staticmethod
    def convert_cap_case(raw: dict[str, Any]) -> CasePayload:
        try:
            decision_date = _dt.date.fromisoformat(raw["decision_date"])
        except (KeyError, ValueError) as e:
            raise ParseError(source="CAP decision_date", details=str(e)) from e
        try:
            name = raw["name"]
            court_name = raw.get("court", {}).get("name", "")
        except (TypeError, AttributeError) as e:
            raise ParseError(source="CAP case", details=str(e)) from e

        citations = [c.get("cite", "") for c in raw.get("citations", []) if c.get("cite")]

        slug = (raw.get("jurisdiction") or {}).get("slug", "")
        if slug == "us":
            jurisdiction = Jurisdiction.federal()
        elif len(slug) == 2:
            jurisdiction = Jurisdiction.state(slug.upper())
        else:
            jurisdiction = Jurisdiction.federal()

        casebody = raw.get("casebody") or {}
        data = casebody.get("data") or {}
        judges = list(data.get("judges", []))
        analysis = raw.get("analysis") or {}

        metadata = CaseMetadata(
            id=new_case_id(),
            name=name,
            citation=citations[0] if citations else "",
            court=court_name,
            decision_date=decision_date,
            judges=judges,
            citations=citations,
            jurisdiction=jurisdiction,
            docket_number=raw.get("docket_number"),
            source_url=raw.get("url"),
            word_count=int(analysis.get("word_count") or 0),
        )

        if data:
            parts: list[str] = []
            if data.get("head_matter"):
                parts.append(data["head_matter"])
            if data.get("parties"):
                parts.append("PARTIES: " + "; ".join(data["parties"]))
            if data.get("attorneys"):
                parts.append("ATTORNEYS: " + "; ".join(data["attorneys"]))
            for op in data.get("opinions", []):
                head = f"OPINION ({op.get('type', 'majority').upper()})"
                if op.get("author"):
                    head += f" by {op['author']}"
                parts.append(head + ":\n\n" + op.get("text", ""))
            full_text = "\n\n".join(parts)
        else:
            full_text = f"Case: {name}\nCourt: {court_name}\nDate: {raw['decision_date']}"
        return metadata, full_text

    async def aclose(self) -> None:
        await self.client.aclose()
