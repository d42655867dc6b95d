"""The port's HTTP server and micro-batcher against the JAX package's, on
the CPU.

Both servers run over the same sqlite store and the same artifacts (the
JAX package built and saved them: ``torch_engine_fixtures.art``), through
the aiohttp test client, with the JAX encoder's query vectors shared into
the port's embedding cache (the encoders agree only to a bf16 tolerance).
Every route must answer with the JAX server's status and JSON body,
``query_time_ms`` and ``uptime_seconds`` aside; scores within 1e-5; case
ids, order, match types and snippets equal. Over seven cases both engines
serve the fused brute mode, which reaches no Pallas kernel on the JAX side
(``tests/test_torch_engine.py`` holds the other modes with the kernels in
interpret mode).
"""

import asyncio
import copy
import re
import shutil
import sys
import threading
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from torch_engine_fixtures import (  # noqa: F401  (fixtures)
    CASES,
    COURTS,
    art,
    engines,
    share_embeddings,
)

from trie_semantic_search_tpu.api.batching import BatchingQueue as JaxBatchingQueue
from trie_semantic_search_tpu.api.batching import QueueFullError as JaxQueueFullError
from trie_semantic_search_tpu.api.server import ApiServer as JaxApiServer
from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu.core.types import AppState as JaxAppState
from trie_semantic_search_tpu.core.types import CaseMetadata as JaxCaseMetadata
from trie_semantic_search_tpu_torch.api.batching import BatchingQueue, QueueFullError
from trie_semantic_search_tpu_torch.api.server import ApiServer
from trie_semantic_search_tpu_torch.core.types import AppState, CaseMetadata
from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
from trie_semantic_search_tpu_torch.search.engine import SearchQuery

torch.set_num_threads(1)

POSTS = [
    {"query": "brown v. board of education"},
    {"query": "384 U.S. 436 (1966)"},
    {"query": "right to remain silent", "max_results": 3},
    {"query": "contract breach damages", "court_filter": [COURTS[1], COURTS[2]]},
    {"query": "fourth amendment search and seizure", "date_range": ["1960-01-01", "1968-01-01"]},
    {"query": "the court", "court_filter": [COURTS[0]], "date_range": ["1950-01-01", None]},
    {"query": "miranda v. arizona", "court_filter": ["No Such Court"]},
    {"query": "counsel for indigent defendants", "max_results": 2},
    {"query": "duty of care negligence damages awarded by the jury"},
    {"query": "gideon v. wainwright", "max_results": 1},
]
GETS = [
    {"query": "brown v. board of education", "limit": "5"},
    {"q": "right to remain silent"},
    {"query": "right to remain silent", "court": COURTS[0], "date_from": "1950-01-01",
     "date_to": "1970-01-01"},
    {"query": "contract breach", "court": [COURTS[1], COURTS[2]], "limit": "2"},
]
GRAPHQL = [
    {"query": 'query { search(query: "brown v. board of education", '
              f'court: "{COURTS[0]}", limit: 5) {{ caseName citation score snippet }} }}'},
    {"query": "query Q($q: String!) { search(query: $q) { name: caseName matchType decisionDate "
              "court } }", "variables": {"q": "miranda v. arizona"}},
    {"query": '{ search(query: "separate but equal", dateFrom: "1950-01-01", dateTo: "1960-01-01")'
              " { caseName score } }"},
    {"query": 'query { search(query: "x y") { nope } }'},
    {"query": "query { cases { id } }"},
    {"query": "mutation { search(query: \"abc\") { score } }"},
    {"query": 'query { search(court: "x") { score } }'},
    {"query": 'query { search(query: "abc", page: 2) { score } }'},
    {"query": 'query { search(query: "abc" { score } }'},
    {"query": "query { search(query: $missing) { score } }"},
    {"query": 'query { search(query: "a") { score } }'},
]
QUERIES = [b["query"] for b in POSTS] + [g.get("query", g.get("q")) for g in GETS] + [
    "brown v. board of education", "miranda v. arizona", "separate but equal", "x y", "abc",
]
VOLATILE = {"query_time_ms", "uptime_seconds"}


def _same(got, want, path="$"):
    """JSON equality, scores (floats) within 1e-5, the volatile keys aside."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            if k not in VOLATILE:
                _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= 1e-5, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _servers(jeng, peng, edit=None):
    """One server per package over the engines, each with a copy of its
    engine's config (``edit`` applied to both)."""
    jcfg, pcfg = copy.deepcopy(jeng.config), copy.deepcopy(peng.config)
    if edit:
        edit(jcfg)
        edit(pcfg)
    return (JaxApiServer(JaxAppState(config=jcfg, search_engine=jeng, storage=jeng.storage)),
            ApiServer(AppState(config=pcfg, search_engine=peng, storage=peng.storage)))


def _drive(servers, body):
    """Run ``body(*clients)`` with a test client per server."""
    async def go():
        clients = [TestClient(TestServer(s.app)) for s in servers]
        for c in clients:
            await c.start_server()
        try:
            return await body(*clients)
        finally:
            for c in clients:
                await c.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


async def _call(client, method, path, **kw):
    resp = await client.request(method, path, **kw)
    ctype = resp.headers.get("Content-Type", "")
    body = await (resp.json() if ctype.startswith("application/json") else resp.text())
    return resp.status, body, resp.headers


async def _both(jc, pc, method, path, **kw):
    """The same request to both servers: equal status and body."""
    js, jb, jh = await _call(jc, method, path, **kw)
    ps, pb, ph = await _call(pc, method, path, **kw)
    assert ps == js, (method, path, kw, ps, js, pb, jb)
    if isinstance(jb, str):
        assert pb == jb, (method, path)
    else:
        _same(pb, jb, f"{method} {path} {kw}")
    return ps, pb, ph


@pytest.fixture()
def pair(art):
    jeng, peng = engines(art)
    share_embeddings(jeng, peng, QUERIES)
    return jeng, peng


def test_routes_match_jax(pair):
    """Every route and its 400 paths: the JAX server's status and body."""
    jeng, peng = pair

    async def body(jc, pc):
        served = 0
        for b in POSTS:
            status, got, _ = await _both(jc, pc, "POST", "/search", json=b)
            assert status == 200
            served += got["total_results"]
        assert served > len(POSTS)
        _, got, _ = await _both(jc, pc, "POST", "/search", json=POSTS[0])
        assert got["results"][0]["match_type"] == "case_name" and got["results"][0]["score"] == 2.0
        for params in GETS:
            status, got, _ = await _both(jc, pc, "GET", "/search", params=params)
            assert status == 200 and got["results"]
        for doc in GRAPHQL:
            await _both(jc, pc, "POST", "/graphql", json=doc)
        for prefix in ("brown", "miranda v", "347", "separate", "zzz"):
            await _both(jc, pc, "GET", "/completions", params={"prefix": prefix, "limit": "3"})
        status, got, _ = await _both(jc, pc, "GET", "/health")
        assert status == 200 and got["status"] == "healthy" and set(got["components"].values()) == {"healthy"}
        bad = [("POST", "/search", dict(json={"query": "a"})),
               ("POST", "/search", dict(json={})),
               ("POST", "/search", dict(json=["query"])),
               ("POST", "/search", dict(data=b"not json")),
               ("POST", "/search", dict(json={"query": "x" * 2000})),
               ("POST", "/search", dict(json={"query": "ok query", "date_range": ["bad"]})),
               ("POST", "/search", dict(json={"query": "ok query", "date_range": [5, None]})),
               ("GET", "/search", {}),
               ("GET", "/search", dict(params={"query": "z"})),
               ("GET", "/search", dict(params={"query": "ok query", "limit": "ten"})),
               ("GET", "/search", dict(params={"query": "ok query", "date_from": "1950-13-01"})),
               ("POST", "/graphql", dict(data=b"not json")),
               ("GET", "/completions", {}),
               ("POST", "/admin/reindex", dict(params={"mode": "bogus"}))]
        for method, path, kw in bad:
            status, _, _ = await _both(jc, pc, method, path, **kw)
            assert status == 400, (method, path, kw)
        status, _, headers = await _both(jc, pc, "OPTIONS", "/search")
        assert status == 204 and headers["Access-Control-Allow-Origin"] == "*"
        js, jpage, _ = await _call(jc, "GET", "/")
        ps, ppage, ph = await _call(pc, "GET", "/")
        assert ps == js == 200 and ph["Access-Control-Allow-Origin"] == "*"
        codes = re.compile(r"<li><code>(.*?)</code>")
        assert codes.findall(ppage) == codes.findall(jpage) and len(codes.findall(ppage)) == 6
        assert "GPU port" in re.search(r"<title>(.*)</title>", ppage).group(1)
        js, jst, _ = await _call(jc, "GET", "/stats")
        ps, pst, _ = await _call(pc, "GET", "/stats")
        assert ps == js == 200 and pst.keys() == jst.keys()
        assert pst["metrics"].keys() == jst["metrics"].keys()
        _same(pst["engine"], jst["engine"], "engine")
        assert pst["batching"].keys() == jst["batching"].keys()
        assert pst["batching"]["items"] == jst["batching"]["items"] > 0
        for d in (pst, jst):
            d["storage"].pop("db_size_bytes")
        _same(pst["storage"], jst["storage"], "storage")

    _drive(_servers(jeng, peng), body)


def _auth(c):
    c.server.api_key = "sekrit"


def _rate(c):
    c.server.rate_limit_rpm = 3


def _payload(c):
    c.server.max_payload_size_mb = 1


def _shed(c):
    c.server.batch_max_pending = 0


def _timeout(c):
    c.search.search_timeout_ms = 1


@pytest.mark.parametrize("case", ["401", "429", "413", "503", "504"])
def test_error_paths_match_jax(pair, case):
    """API key (401, health exempt), rate limit (429), payload limit
    (413), load shedding (503 + Retry-After) and the search timeout (504)
    on the POST, GET and GraphQL routes: the JAX server's answers."""
    jeng, peng = pair
    edit = {"401": _auth, "429": _rate, "413": _payload, "503": _shed, "504": _timeout}[case]
    routes = [("POST", "/search", dict(json=POSTS[0])),
              ("GET", "/search", dict(params=GETS[0])),
              ("POST", "/graphql", dict(json=GRAPHQL[0]))]

    async def body(jc, pc):
        if case == "401":
            for method, path, kw in routes:
                status, _, _ = await _both(jc, pc, method, path, **kw)
                assert status == 401
            for headers in ({"X-API-Key": "sekrit"}, {"Authorization": "Bearer sekrit"}):
                status, _, _ = await _both(jc, pc, "POST", "/search", json=POSTS[0], headers=headers)
                assert status == 200
            assert (await _both(jc, pc, "GET", "/health"))[0] == 200
        elif case == "429":
            codes = [(await _both(jc, pc, "GET", "/completions" if i % 2 else "/health",
                                  params={"prefix": "brown"}))[0] for i in range(5)]
            assert codes[:3] == [200] * 3 and codes[3:] == [429] * 2
        elif case == "413":
            # a body of exactly the limit (aiohttp refuses at >= the limit):
            # each server reads all of it before answering, so the "actual
            # body size" in both 413 texts is the whole body, whatever the
            # chunks the reads returned; a longer body made that size
            # depend on where the read crossed the limit
            limit = 1024 * 1024
            raw = b'{"query": "' + b"x" * (limit - 13) + b'"}'
            assert len(raw) == limit
            status, text, _ = await _both(jc, pc, "POST", "/search", data=raw,
                                          headers={"Content-Type": "application/json"})
            assert status == 413
            assert f"actual body size {limit}" in text
        else:
            want = 503 if case == "503" else 504
            for method, path, kw in routes:
                status, _, headers = await _both(jc, pc, method, path, **kw)
                assert status == want
                if case == "503":
                    assert headers["Retry-After"] == "1"

    _drive(_servers(jeng, peng, edit), body)


def test_concurrent_burst_matches_single(art):
    """20 concurrent requests (each of 10 bodies twice) coalesce in the
    batcher (two batches in flight, worker threads switching every
    microsecond) and answer what each body answers alone, in both
    packages; the served count adds up."""
    jeng, peng = engines(art, enable_query_cache=False)
    share_embeddings(jeng, peng, QUERIES)

    def wide_window(c):
        c.server.batch_window_ms = 50.0

    servers = _servers(jeng, peng, wide_window)

    async def body(jc, pc):
        single = [(await _both(jc, pc, "POST", "/search", json=b))[1] for b in POSTS]
        out = []
        for client in (jc, pc):
            out.append(await asyncio.gather(*[_call(client, "POST", "/search", json=POSTS[i % 10])
                                              for i in range(20)]))
        return single, out

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        single, (jburst, pburst) = _drive(servers, body)
    finally:
        sys.setswitchinterval(switch)
    for burst in (jburst, pburst):
        for i, (status, got, _) in enumerate(burst):
            assert status == 200
            _same(got, single[i % 10], f"burst[{i}]")
    stats = servers[1].batcher.stats
    assert stats["items"] == 30 and stats["batches"] < 20  # coalesced
    assert peng.get_stats().queries_served == jeng.get_stats().queries_served == 30


def test_batch_path_counts_under_threads(art):
    """The counters the batch workers share add up under contention: eight
    threads serving at once, and eight threads counting kernel launches."""
    _, peng = engines(art, enable_query_cache=False)
    qs = [SearchQuery(query=b["query"]) for b in POSTS]
    want = [[r.to_json() for r in rs] for rs in peng.search_batch(qs)]
    served0 = peng.get_stats().queries_served
    errors, results = [], []

    def worker():
        try:
            results.append([[r.to_json() for r in rs] for rs in peng.search_batch(qs)])
        except Exception as e:  # surfaced below
            errors.append(e)

    def counter():
        for _ in range(20_000):
            sk._count_launch("gather_rescore")

    saved = dict(sk.LAUNCHES)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sk.reset_launch_counts()
        threads = [threading.Thread(target=f) for f in [worker] * 8 + [counter] * 8]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert sk.LAUNCHES["gather_rescore"] == 8 * 20_000
    finally:
        sys.setswitchinterval(switch)
        sk.LAUNCHES.update(saved)
    assert not errors and results == [want] * 8
    assert peng.get_stats().queries_served == served0 + 8 * len(qs)


def _copy_art(art, dst):
    """A copy of the store and artifacts with a config pointing at it."""
    shutil.copytree(art["root"], dst)
    cfg = JaxConfig.from_file(art["toml"])
    cfg.storage.db_path = str(dst / "db.sqlite")
    cfg.trie.index_path = str(dst / "trie")
    cfg.vector.hnsw.index_path = str(dst / "vec")
    cfg.vector.quality_gate = "warn"
    cfg.save_to_file(dst / "config.toml")
    return {"root": dst, "toml": dst / "config.toml"}


NEW_CASE = ("Marbury v. Madison", "5 U.S. 137 (1803)", COURTS[0],
            "It is emphatically the province and duty of the judicial department to say what "
            "the law is. Those who apply the rule to particular cases must of necessity expound "
            "and interpret that rule.")


@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_reindex_matches_jax(art, tmp_path, mode):
    """``POST /admin/reindex`` over a store with one new case: 202, the
    rebuild runs in the background (409 while it runs), the quality gate
    writes its report, and both servers then find the new case and answer
    the old queries alike."""
    import datetime as dt
    import uuid

    roots = [_copy_art(art, tmp_path / tag) for tag in ("jax", "port")]
    jeng, _ = engines(roots[0])
    _, peng = engines(roots[1])
    share_embeddings(jeng, peng, QUERIES)
    for eng, cls in ((jeng, JaxCaseMetadata), (peng, CaseMetadata)):
        meta = cls(id=uuid.UUID(int=100), name=NEW_CASE[0], citation=NEW_CASE[1], court=NEW_CASE[2],
                   decision_date=dt.date(1803, 2, 24),
                   ingestion_date=dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc))
        eng.storage.store_case_metadata(meta)
        eng.storage.store_case_text(meta.id, NEW_CASE[3])
    servers = _servers(jeng, peng)

    async def body(jc, pc):
        status, got, _ = await _both(jc, pc, "POST", "/admin/reindex", params={"mode": mode})
        assert status == 202 and got == {"status": "started", "mode": mode}
        assert (await _both(jc, pc, "POST", "/admin/reindex"))[0] == 409
        for _ in range(1200):
            if not any(s._reindexing for s in servers):
                break
            await asyncio.sleep(0.1)
        assert not any(s._reindexing for s in servers)
        share_embeddings(jeng, peng, QUERIES + [NEW_CASE[0].lower()])
        st = [(await _call(c, "GET", "/stats"))[1]["engine"] for c in (jc, pc)]
        assert st[0]["total_cases_indexed"] == st[1]["total_cases_indexed"] == len(CASES) + 1
        _, got, _ = await _both(jc, pc, "POST", "/search", json={"query": NEW_CASE[0].lower()})
        assert got["results"][0]["case_metadata"]["name"] == NEW_CASE[0]
        for b in POSTS:
            await _both(jc, pc, "POST", "/search", json=b)

    _drive(servers, body)
    from trie_semantic_search_tpu.index.quality_gate import load_quality_meta

    jmeta, pmeta = (load_quality_meta(r["root"] / "vec") for r in roots)
    assert pmeta["mode"] == jmeta["mode"] == "warn"
    for k in ("probes", "sample_cases", "sample_chunks", "margin"):
        assert pmeta[k] == jmeta[k], k


# -- the micro-batcher, both packages' ---------------------------------------------


def _batches(BQ, QF):
    seen = []

    def run_batch(items):
        seen.append(len(items))
        return [i * 2 for i in items]

    async def go():
        bq = BQ(run_batch, max_batch=8, window_ms=20)
        await bq.start()
        out = await asyncio.gather(*[bq.submit(i) for i in range(10)])
        await bq.stop()
        return out

    assert sorted(asyncio.new_event_loop().run_until_complete(go())) == [i * 2 for i in range(10)]
    assert max(seen) > 1


def _poison(BQ, QF):
    def run_batch(items):
        if "bad" in items:
            raise ValueError("poisoned batch")
        return [i.upper() for i in items]

    async def go():
        bq = BQ(run_batch, max_batch=8, window_ms=20)
        await bq.start()
        good, bad = asyncio.create_task(bq.submit("ok")), asyncio.create_task(bq.submit("bad"))
        r = await good
        with pytest.raises(ValueError):
            await bad
        await bq.stop()
        return r, bq.stats["batch_failures"]

    assert asyncio.new_event_loop().run_until_complete(go()) == ("OK", 1)


def _sheds(BQ, QF):
    release = threading.Event()

    def run_batch(items):
        release.wait(5.0)
        return list(items)

    async def go():
        bq = BQ(run_batch, max_batch=2, window_ms=1, max_pending=4, inflight=1)
        await bq.start()
        tasks = [asyncio.create_task(bq.submit(i)) for i in range(12)]
        asyncio.get_running_loop().call_later(0.2, release.set)
        results = await asyncio.gather(*[asyncio.wait_for(t, 2.0) for t in tasks],
                                       return_exceptions=True)
        await bq.stop()
        return results, bq.stats["shed"]

    results, stat = asyncio.new_event_loop().run_until_complete(go())
    shed = [r for r in results if isinstance(r, QF)]
    timed_out = [r for r in results if isinstance(r, asyncio.TimeoutError)]
    assert len(shed) >= 1 and stat == len(shed) and len(shed) + len(timed_out) < 12


def _ghosts(BQ, QF):
    executed = []

    def run_batch(items):
        executed.extend(items)
        return list(items)

    async def go():
        bq = BQ(run_batch, max_batch=4, window_ms=5)
        loop = asyncio.get_running_loop()
        for i in range(6):
            fut = loop.create_future()
            fut.cancel()
            await bq._queue.put((f"ghost{i}", fut))
        await bq.start()
        live = await bq.submit("live")
        await bq.stop()
        return live, bq.stats["ghosts_dropped"]

    assert asyncio.new_event_loop().run_until_complete(go()) == ("live", 6)
    assert executed == ["live"]


def _fails_fast(BQ, QF):
    calls = []

    def run_batch(items):
        calls.append(len(items))
        raise RuntimeError("backend down")

    async def go():
        bq = BQ(run_batch, max_batch=16, window_ms=50, single_retry_max=2)
        await bq.start()
        tasks = [asyncio.create_task(bq.submit(i)) for i in range(8)]
        results = await asyncio.gather(*tasks, return_exceptions=True)
        await bq.stop()
        return results

    assert all(isinstance(r, RuntimeError) for r in asyncio.new_event_loop().run_until_complete(go()))
    assert 1 not in calls


def _pipelines(BQ, QF):
    def run_batch(items):
        time.sleep(0.05)
        return [f"r{i}" for i in items]

    async def go():
        bq = BQ(run_batch, max_batch=16, window_ms=2, max_pending=64, inflight=2)
        await bq.start()

        async def client(i):
            try:
                return await asyncio.wait_for(bq.submit(i), timeout=1.5)
            except (asyncio.TimeoutError, QF):
                return None

        t0 = time.perf_counter()
        out = []
        for burst in range(4):
            out.extend(await asyncio.gather(*[client(burst * 32 + i) for i in range(32)]))
        wall = time.perf_counter() - t0
        await bq.stop()
        return out, wall

    out, wall = asyncio.new_event_loop().run_until_complete(go())
    assert out == [f"r{i}" for i in range(128)] and wall < 2.0


def _stopped(BQ, QF):
    async def go():
        bq = BQ(lambda items: list(items))
        await bq.start()
        await bq.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            await bq.submit(1)
        return bq.depth()

    assert asyncio.new_event_loop().run_until_complete(go()) == 0


@pytest.mark.parametrize("case", [_batches, _poison, _sheds, _ghosts, _fails_fast, _pipelines,
                                  _stopped], ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_batching_queue(pkg, case):
    """The JAX package's batcher tests, run on both packages' queues."""
    if pkg == "jax":
        case(JaxBatchingQueue, JaxQueueFullError)
    else:
        case(BatchingQueue, QueueFullError)
