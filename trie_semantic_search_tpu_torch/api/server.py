"""REST API server on aiohttp (port of ``trie_semantic_search_tpu/api/
server.py``, the same routes, payloads and status codes):

* ``POST /search`` — ``{query, max_results, court_filter, date_range}`` →
  ``{results, total_results, query_time_ms, pagination}``
* ``GET /search?query=&limit=&court=&date_from=&date_to=`` — the
  query-string form → ``{query, results: [{case_name, citation,
  decision_date, snippet, score, match_type}]}``
* ``POST /graphql`` — the ``search`` field of :mod:`.graphql`
* ``GET /health`` — per-component status (503 when one is unhealthy)
* ``GET /stats`` — engine, index, cache, batcher and storage statistics
* ``GET /completions?prefix=`` — trie prefix completions
* ``POST /admin/reindex?mode=full|incremental`` — rebuild in the
  background (``build_indexes`` or ``update_indexes``, then the quality
  gate and ``save_artifacts``) and swap the result into the live engine
* ``GET /`` — HTML landing page

Middleware: API key (``X-API-Key`` or ``Authorization: Bearer``; health
and landing page exempt, 401), a fixed-window per-client rate limit (429),
CORS headers, and the payload limit (413). Searches go through the
:class:`BatchingQueue` into the engine's batched path, under the search
timeout (504) and the batcher's load shedding (503).
"""

from __future__ import annotations

import asyncio
import datetime as _dt
import json
import logging
import time
from typing import Optional

from aiohttp import web

from .. import __version__
from ..core.errors import InvalidSearchQuery, SearchError
from ..core.types import AppState
from ..search.engine import SearchQuery
from .batching import BatchingQueue, QueueFullError

_log = logging.getLogger("tss_torch.api")


def _parse_date(v) -> Optional[_dt.date]:
    if v is None:
        return None
    if isinstance(v, str):
        return _dt.date.fromisoformat(v[:10])
    raise ValueError(f"bad date: {v!r}")


class _RateLimiterMiddleware:
    """Fixed-window per-client request limiter (``server.rate_limit_rpm``)."""

    def __init__(self, rpm: int):
        self.rpm = rpm
        self._counts: dict[str, tuple[int, int]] = {}

    def allow(self, client: str) -> bool:
        window = int(time.monotonic() // 60)
        count, win = self._counts.get(client, (0, window))
        if win != window:
            count = 0
        count += 1
        self._counts[client] = (count, window)
        if len(self._counts) > 10_000:  # bound memory
            self._counts = {
                k: v for k, v in self._counts.items() if v[1] == window
            }
        return count <= self.rpm


class ApiServer:
    """The HTTP surface over one :class:`~..core.types.AppState`."""

    def __init__(self, app_state: AppState):
        self.state = app_state
        cfg = app_state.config
        self.batcher = BatchingQueue(
            run_batch=app_state.search_engine.search_batch,
            max_batch=cfg.server.batch_max,
            window_ms=cfg.server.batch_window_ms,
            max_pending=cfg.server.batch_max_pending,
            inflight=cfg.server.batch_inflight,
        )
        self.rate_limiter = _RateLimiterMiddleware(cfg.server.rate_limit_rpm)
        self.started_at = time.monotonic()
        self.app = web.Application(
            middlewares=[self._middleware],
            client_max_size=cfg.server.max_payload_size_mb * 1024 * 1024,
        )
        self.app.router.add_post("/search", self.search_handler)
        self.app.router.add_get("/search", self.search_get_handler)
        self.app.router.add_post("/graphql", self.graphql_handler)
        self.app.router.add_get("/health", self.health_handler)
        self.app.router.add_get("/stats", self.stats_handler)
        self.app.router.add_get("/completions", self.completions_handler)
        self.app.router.add_post("/admin/reindex", self.reindex_handler)
        self.app.router.add_get("/", self.index_handler)
        self._reindexing = False
        self._reindex_task: Optional[asyncio.Task] = None
        self.app.on_startup.append(lambda _app: self.batcher.start())
        self.app.on_cleanup.append(lambda _app: self.batcher.stop())

    # -- middleware: auth, rate limit, CORS ---------------------------------

    @staticmethod
    def _cors(resp: web.StreamResponse) -> web.StreamResponse:
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Headers"] = "Content-Type, X-API-Key"
        resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
        return resp

    @web.middleware
    async def _middleware(self, request: web.Request, handler):
        cfg = self.state.config.server
        # CORS preflight: answer before auth/rate-limit so browsers can
        # actually reach the API (preflights never carry credentials)
        if cfg.enable_cors and request.method == "OPTIONS":
            return self._cors(web.Response(status=204))
        # API key (exempt health + landing page)
        if cfg.api_key and request.path not in ("/health", "/"):
            supplied = request.headers.get("X-API-Key") or request.headers.get(
                "Authorization", ""
            ).removeprefix("Bearer ").strip()
            if supplied != cfg.api_key:
                resp = web.json_response(
                    {"error": "Authentication failed", "message": "invalid API key"},
                    status=401,
                )
                return self._cors(resp) if cfg.enable_cors else resp
        client = request.remote or "unknown"
        if not self.rate_limiter.allow(client):
            resp = web.json_response(
                {"error": "Rate limit exceeded",
                 "message": f"{cfg.rate_limit_rpm} RPM exceeded"},
                status=429,
            )
            return self._cors(resp) if cfg.enable_cors else resp
        try:
            resp = await handler(request)
        except web.HTTPException as e:
            if cfg.enable_cors:
                self._cors(e)
            raise
        if cfg.enable_cors:
            self._cors(resp)
        return resp

    # -- handlers -----------------------------------------------------------

    async def search_handler(self, request: web.Request) -> web.Response:
        """``POST /search``: one query through the batcher."""
        t0 = time.perf_counter()
        try:
            body = await request.json()
        except (json.JSONDecodeError, ValueError):
            return web.json_response(
                {"error": "Invalid API request", "message": "body must be JSON"},
                status=400,
            )
        if not isinstance(body, dict) or "query" not in body:
            return web.json_response(
                {"error": "Invalid API request", "message": "missing 'query'"},
                status=400,
            )
        try:
            date_range = None
            if body.get("date_range"):
                lo, hi = body["date_range"]
                date_range = (_parse_date(lo), _parse_date(hi))
            q = SearchQuery(
                query=str(body["query"]),
                max_results=body.get("max_results"),
                court_filter=body.get("court_filter"),
                date_range=date_range,
            )
        except (ValueError, TypeError) as e:
            return web.json_response(
                {"error": "Invalid API request", "message": str(e)}, status=400
            )

        try:
            self.state.search_engine.validate_query(q)
            # the search timeout budget (search.search_timeout_ms)
            timeout_s = self.state.config.search.search_timeout_ms / 1000
            results = await asyncio.wait_for(self.batcher.submit(q), timeout_s)
        except QueueFullError:
            # load shedding: fail fast instead of queueing into a timeout
            return self._overloaded_response()
        except asyncio.TimeoutError:
            return web.json_response(
                {
                    "error": "Search timeout",
                    "message": f"query took longer than "
                    f"{self.state.config.search.search_timeout_ms}ms",
                },
                status=504,
            )
        except InvalidSearchQuery as e:
            return web.json_response(
                {"error": "Invalid search query", "message": str(e)}, status=400
            )
        except SearchError as e:
            _log.error("search error: %s", e)
            return web.json_response(
                {"error": "Search failed", "message": str(e)}, status=500
            )

        query_time_ms = int((time.perf_counter() - t0) * 1000)
        payload = {
            "results": [r.to_json() for r in results],
            "total_results": len(results),
            "query_time_ms": query_time_ms,
            "pagination": {
                "page": 1,
                "per_page": len(results),
                "total_pages": 1,
                "has_next": False,
                "has_prev": False,
            },
        }
        return web.json_response(payload)

    def _overloaded_response(self) -> web.Response:
        """503 + Retry-After for shed load (batcher backlog at max_pending)."""
        resp = web.json_response(
            {
                "error": "Server overloaded",
                "message": f"{self.batcher.depth()} requests already queued; "
                "retry shortly",
            },
            status=503,
        )
        # hint: backlog drains at ~1 batch per exec; 1 s is conservative
        resp.headers["Retry-After"] = "1"
        return resp

    async def _execute_query(self, q: SearchQuery):
        """Validate + run through the micro-batcher under the configured
        timeout budget (shared by the POST, GET and GraphQL handlers).
        Raises :class:`QueueFullError` when load must be shed."""
        self.state.search_engine.validate_query(q)
        timeout_s = self.state.config.search.search_timeout_ms / 1000
        return await asyncio.wait_for(self.batcher.submit(q), timeout_s)

    async def search_get_handler(self, request: web.Request) -> web.Response:
        """``GET /search?query=freedom+of+speech&limit=10`` →
        ``{query, results: [{case_name, citation, decision_date, snippet,
        score, match_type}]}``. Optional ``court`` (repeatable) and
        ``date_from``/``date_to`` filters mirror the POST body."""
        query = request.query.get("query") or request.query.get("q")
        if not query:
            return web.json_response(
                {"error": "Invalid API request", "message": "missing 'query'"},
                status=400,
            )
        try:
            limit = int(request.query.get("limit", "10"))
            courts = request.query.getall("court", []) or None
            date_range = None
            if request.query.get("date_from") or request.query.get("date_to"):
                date_range = (
                    _parse_date(request.query.get("date_from")),
                    _parse_date(request.query.get("date_to")),
                )
            q = SearchQuery(
                query=query, max_results=limit, court_filter=courts,
                date_range=date_range,
            )
        except (ValueError, TypeError) as e:
            return web.json_response(
                {"error": "Invalid API request", "message": str(e)}, status=400
            )
        try:
            results = await self._execute_query(q)
        except QueueFullError:
            return self._overloaded_response()
        except InvalidSearchQuery as e:
            return web.json_response(
                {"error": "Invalid search query", "message": str(e)}, status=400
            )
        except asyncio.TimeoutError:
            return web.json_response({"error": "Search timeout"}, status=504)
        return web.json_response(
            {
                "query": query,
                "results": [
                    {
                        "case_name": r.case_metadata.name,
                        "citation": r.case_metadata.citation,
                        "decision_date": r.case_metadata.decision_date.isoformat(),
                        "snippet": r.snippet,
                        "score": r.score,
                        "match_type": r.match_type.value,
                    }
                    for r in results
                ],
            }
        )

    async def graphql_handler(self, request: web.Request) -> web.Response:
        """``POST /graphql``: the ``search(query, court, limit, dateFrom,
        dateTo)`` field with scalar selections (:mod:`.graphql`), in the
        standard envelope ``{"query": "..."} → {"data": ...}`` /
        ``{"errors": ...}``."""
        from .graphql import GraphQLError, execute_search_query

        try:
            body = await request.json()
        except (json.JSONDecodeError, ValueError):
            return web.json_response(
                {"errors": [{"message": "body must be JSON"}]}, status=400
            )
        document = (body or {}).get("query", "")
        variables = (body or {}).get("variables") or {}

        async def run(q: SearchQuery):
            return await self._execute_query(q)

        try:
            data = await execute_search_query(document, variables, run)
        except GraphQLError as e:
            return web.json_response(
                {"errors": [{"message": str(e)}]}, status=400
            )
        except QueueFullError:
            return self._overloaded_response()
        except InvalidSearchQuery as e:
            return web.json_response(
                {"errors": [{"message": str(e)}]}, status=400
            )
        except asyncio.TimeoutError:
            return web.json_response(
                {"errors": [{"message": "search timeout"}]}, status=504
            )
        return web.json_response({"data": data})

    async def health_handler(self, request: web.Request) -> web.Response:
        """``GET /health``: each component's probe; 503 unless all pass."""
        components = {}
        overall = "healthy"
        try:
            self.state.storage.health_check()
            components["storage"] = "healthy"
        except Exception as e:
            components["storage"] = f"unhealthy: {e}"
            overall = "degraded"
        try:
            self.state.search_engine.health_check()
            components["search_engine"] = "healthy"
        except Exception as e:
            components["search_engine"] = f"unhealthy: {e}"
            overall = "degraded"
        try:
            _ = self.state.search_engine.trie_index.get_stats()
            components["trie_index"] = "healthy"
        except Exception as e:
            components["trie_index"] = f"unhealthy: {e}"
            overall = "degraded"
        try:
            _ = self.state.search_engine.vector_index.get_stats()
            components["vector_index"] = "healthy"
        except Exception as e:
            components["vector_index"] = f"unhealthy: {e}"
            overall = "degraded"
        return web.json_response(
            {
                "status": overall,
                "version": __version__,
                "uptime_seconds": int(time.monotonic() - self.started_at),
                "components": components,
            },
            status=200 if overall == "healthy" else 503,
        )

    async def stats_handler(self, request: web.Request) -> web.Response:
        """``GET /stats``."""
        import dataclasses

        def as_dict(x):
            if dataclasses.is_dataclass(x) and not isinstance(x, type):
                return {k: as_dict(v) for k, v in dataclasses.asdict(x).items()}
            if isinstance(x, dict):
                return {k: as_dict(v) for k, v in x.items()}
            return x

        from ..core.metrics import metrics

        engine_stats = self.state.search_engine.get_stats()
        storage_stats = self.state.storage.get_stats()
        return web.json_response(
            {
                "metrics": metrics.snapshot(),
                "engine": {
                    "total_cases_indexed": engine_stats.total_cases_indexed,
                    "queries_served": engine_stats.queries_served,
                    "escalated_queries": engine_stats.escalated_queries,
                    "is_warm": getattr(
                        self.state.search_engine, "is_warm", False
                    ),
                    "trie": engine_stats.trie_stats,
                    "vector": as_dict(engine_stats.vector_index_stats),
                    "query_cache": as_dict(engine_stats.cache_stats),
                },
                "batching": {**self.batcher.stats, "depth": self.batcher.depth()},
                "storage": as_dict(storage_stats),
            }
        )

    async def completions_handler(self, request: web.Request) -> web.Response:
        prefix = request.query.get("prefix", "")
        limit = int(request.query.get("limit", "10"))
        if not prefix:
            return web.json_response(
                {"error": "Invalid API request", "message": "missing 'prefix'"},
                status=400,
            )
        comps = self.state.search_engine.trie_index.get_completions(prefix, limit)
        return web.json_response({"prefix": prefix, "completions": comps})

    async def reindex_handler(self, request: web.Request) -> web.Response:
        """``POST /admin/reindex``: rebuild the index artifacts from the
        store in the background, save them, and swap them into the live
        engine (readers see the old or the new indexes, never a mix).

        ``?mode=incremental`` indexes only the cases stored since the live
        artifacts were built (``update_indexes``: no re-embedding of old
        chunks, no k-means), on forks of the live indexes; ``full`` (the
        default) runs ``build_indexes`` with the live encoder. 202 when
        started, 409 while one runs."""
        mode = request.query.get("mode", "full")
        if mode not in ("full", "incremental"):
            return web.json_response(
                {"error": "Invalid API request",
                 "message": f"mode must be full|incremental, got {mode!r}"},
                status=400,
            )
        if self._reindexing:
            return web.json_response(
                {"status": "already_running"}, status=409
            )
        self._reindexing = True

        async def _rebuild() -> None:
            try:
                from ..index.builder import (
                    BuildReport,
                    BuiltIndexes,
                    build_indexes,
                    save_artifacts,
                    update_indexes,
                )

                engine = self.state.search_engine
                if mode == "incremental":
                    live = BuiltIndexes(
                        trie=engine.trie_index,
                        vector=engine.vector_index,
                        columns=engine.columns,
                        report=BuildReport(cases=len(engine.columns)),
                    )
                    built = await asyncio.to_thread(
                        update_indexes, live, self.state.storage,
                        self.state.config,
                    )
                else:
                    built = await asyncio.to_thread(
                        build_indexes,
                        self.state.storage,
                        self.state.config,
                        embedder=engine.vector_index.embedder,
                        device=engine.device,
                    )
                await asyncio.to_thread(
                    save_artifacts, built, self.state.config,
                    storage=self.state.storage,
                )
                engine.swap_indexes(built.trie, built.vector, built.columns)
                _log.info(
                    "%s reindex complete: %d cases, %d chunks",
                    mode, built.report.cases, built.report.content_chunks,
                )
            except Exception:  # the server keeps serving the old indexes
                _log.exception("background reindex failed")
            finally:
                self._reindexing = False

        self._reindex_task = asyncio.create_task(_rebuild())
        return web.json_response({"status": "started", "mode": mode}, status=202)

    async def index_handler(self, request: web.Request) -> web.Response:
        """``GET /``: HTML landing page listing the endpoints."""
        html = f"""<!DOCTYPE html>
<html>
<head><title>Legal Search Engine (GPU port)</title>
<style>
body {{ font-family: system-ui, sans-serif; margin: 3em auto; max-width: 46em; }}
code {{ background: #f0f0f0; padding: 0.15em 0.4em; border-radius: 4px; }}
li {{ margin: 0.5em 0; }}
</style></head>
<body>
<h1>Trie + Semantic Legal Search (PyTorch/CUDA port)</h1>
<p>Hybrid legal case-law search: array-trie lexical matching fused with
MiniLM semantic retrieval on an NVIDIA GPU. Version {__version__}.</p>
<h2>Endpoints</h2>
<ul>
<li><code>POST /search</code> — {{"query": "...", "max_results": 10,
"court_filter": [...], "date_range": ["1950-01-01", "1970-01-01"]}}</li>
<li><code>GET /search?query=freedom+of+speech&amp;limit=10</code> — query-string form</li>
<li><code>POST /graphql</code> — {{"query": "query {{ search(query: \\"...\\", limit: 5)
{{ caseName citation score snippet }} }}"}}</li>
<li><code>GET /health</code> — component health</li>
<li><code>GET /stats</code> — engine / index / storage statistics</li>
<li><code>GET /completions?prefix=brown</code> — trie prefix completions</li>
</ul>
</body></html>"""
        return web.Response(text=html, content_type="text/html")

    # -- lifecycle ----------------------------------------------------------

    async def run(self) -> None:
        """Bind ``server.host:server.port`` and serve until cancelled."""
        cfg = self.state.config.server
        runner = web.AppRunner(self.app)
        await runner.setup()
        site = web.TCPSite(runner, cfg.host, cfg.port)
        await site.start()
        _log.info("API server listening on %s:%d", cfg.host, cfg.port)
        try:
            while True:
                await asyncio.sleep(3600)
        finally:
            await runner.cleanup()
