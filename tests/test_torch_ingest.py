"""The port's ingestion (``ingest/``) against the JAX package's, on the CPU.

Each test runs the same scenario through both packages on the same inputs
and compares what comes out. Cases get fixed ids (the packages mint fresh
UUIDs otherwise), and stored rows are compared without ``ingestion_date``,
the one field that holds the clock. The CAP and CourtListener clients of
both packages talk to one ``httpx.MockTransport`` handler.
"""

import asyncio
import datetime as dt
import gzip
import json
import sqlite3
import sys
import uuid

import httpx
import pytest

import trie_semantic_search_tpu.core.config as jconf
import trie_semantic_search_tpu.core.errors as jerr
import trie_semantic_search_tpu.core.types as jtypes
import trie_semantic_search_tpu.ingest as jing
import trie_semantic_search_tpu.ingest.sources as jsrc
import trie_semantic_search_tpu.storage.store as jstore
import trie_semantic_search_tpu_torch.core.config as pconf
import trie_semantic_search_tpu_torch.core.errors as perr
import trie_semantic_search_tpu_torch.core.types as ptypes
import trie_semantic_search_tpu_torch.ingest as ping
import trie_semantic_search_tpu_torch.ingest.sources as psrc
import trie_semantic_search_tpu_torch.storage.store as pstore


class Pkg:
    """One package's ingestion surface, so a scenario runs against either."""

    def __init__(self, name, conf, errors, types, ing, src, store):
        self.name, self.conf, self.errors, self.types = name, conf, errors, types
        self.ing, self.src, self.store = ing, src, store


JAX = Pkg("jax", jconf, jerr, jtypes, jing, jsrc, jstore)
PORT = Pkg("port", pconf, perr, ptypes, ping, psrc, pstore)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


LONG_TEXT = (
    "The court held that the challenged statute violates the equal "
    "protection clause of the Fourteenth Amendment. " * 5
)


def make_case(pkg, i, name="State v. Example", citation="100 U.S. 1 (1880)", **kw):
    return pkg.types.CaseMetadata(
        id=uuid.UUID(int=i + 1), name=name, citation=citation,
        court=kw.pop("court", "Supreme Court of the United States"),
        decision_date=kw.pop("decision_date", dt.date(1880, 1, 1)), **kw,
    )


def landmarks(pkg):
    """The mock source's three landmark cases with fixed ids."""
    src = pkg.src.MockDataSource()
    for i, (meta, _) in enumerate(src._cases):
        meta.id = uuid.UUID(int=1000 + i)
    return src


def storage(pkg, tmp_path):
    return pkg.store.StorageManager(pkg.conf.StorageConfig(db_path=str(tmp_path / f"{pkg.name}.sqlite")))


def stored_rows(st):
    """Every stored case by id: the indexed columns, the metadata JSON
    without ``ingestion_date``, and the decompressed text."""
    conn = sqlite3.connect(st.config.db_path)
    try:
        out = {}
        for cid, name, cit, court, date, doc in conn.execute("SELECT * FROM case_metadata"):
            d = json.loads(doc)
            d.pop("ingestion_date")
            out[cid] = [name, cit, court, date, d]
        for cid, comp, blob in conn.execute("SELECT * FROM case_text"):
            out[cid].append(gzip.decompress(blob) if comp else blob)
        return out
    finally:
        conn.close()


STAT_FIELDS = ("total_cases", "processed", "skipped_duplicates", "failed_validation",
               "failed_processing", "cache_hits", "batches_completed")


def counts(stats):
    return {f: getattr(stats, f) for f in STAT_FIELDS}


# -- errors -----------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("NetworkError", dict(details="blip")),
    ("RateLimitExceeded", dict(source="CAP API")),
    ("SourceUnavailable", dict(source="mock", details="not registered")),
    ("ParseError", dict(source="CAP case", details="bad date")),
    ("DatabaseError", {}),
    ("IndexCorrupted", dict(index_type="ann", details="x")),
])
def test_error_to_json_matches_jax(name, kw):
    j, p = getattr(jerr, name)(**kw), getattr(perr, name)(**kw)
    assert p.to_json() == j.to_json()
    assert (p.is_recoverable(), p.recovery_suggestion(), str(p)) == (
        j.is_recoverable(), j.recovery_suggestion(), str(j))
    assert isinstance(p, perr.SearchError)


# -- validator ----------------------------------------------------------------------------


def _validation(pkg, case):
    cfg, kw, text = {
        "good": ({}, {}, LONG_TEXT),
        "too_short": (dict(min_text_length=100), {}, "short"),
        "too_long": (dict(max_text_length=50), {}, LONG_TEXT),
        "missing_name": ({}, dict(name=""), LONG_TEXT),
        "missing_court_and_citation": (dict(required_fields=["court", "citation", "unknown"]),
                                       dict(court=" ", citation=""), LONG_TEXT),
        "future_date": ({}, dict(decision_date=dt.date.today() + dt.timedelta(days=365)), LONG_TEXT),
        "ancient_date": ({}, dict(decision_date=dt.date(1500, 1, 1)), LONG_TEXT),
        "bad_citation": ({}, dict(citation="not a citation"), LONG_TEXT),
        "empty_citation": ({}, dict(citation=""), LONG_TEXT),
        "empty_citation_allowed": (dict(allow_empty_citations=True), dict(citation=""), LONG_TEXT),
        "checks_off": (dict(validate_citations=False, validate_dates=False),
                       dict(citation="x", decision_date=dt.date(1500, 1, 1)), LONG_TEXT),
    }[case]
    res = pkg.ing.CaseValidator(pkg.conf.ValidationConfig(**cfg)).validate_case(make_case(pkg, 0, **kw), text)
    issues = lambda xs: [(i.rule, i.message, i.severity.value) for i in xs]  # noqa: E731
    return res.passed, issues(res.errors), issues(res.warnings)


@pytest.mark.parametrize("case", ["good", "too_short", "too_long", "missing_name",
                                  "missing_court_and_citation", "future_date", "ancient_date",
                                  "bad_citation", "empty_citation", "empty_citation_allowed",
                                  "checks_off"])
def test_validator_matches_jax(case):
    got, want = _validation(PORT, case), _validation(JAX, case)
    assert got == want
    assert want[0] == (case in ("good", "bad_citation", "empty_citation",
                                "empty_citation_allowed", "checks_off"))


# -- cache manager ------------------------------------------------------------------------


def test_cache_watermarks_match_jax(tmp_path):
    """Each package reads the other's watermark file; both write the same
    bytes."""
    when = dt.datetime(2020, 5, 1, tzinfo=dt.timezone.utc)
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        d = tmp_path / writer.name
        cfg = lambda pkg: pkg.conf.CacheConfig(disk_cache_path=str(d))  # noqa: E731
        writer.ing.CacheManager(cfg(writer)).set_last_update("cap", when)
        back = reader.ing.CacheManager(cfg(reader))
        assert back.get_last_update("cap") == when
        back.clear_source_cache("cap")
        assert writer.ing.CacheManager(cfg(writer)).get_last_update("cap") is None
    assert (tmp_path / "jax" / "watermarks.json").read_bytes() == (
        tmp_path / "port" / "watermarks.json").read_bytes()


def _cache_run(pkg, root):
    cm = pkg.ing.CacheManager(pkg.conf.CacheConfig(disk_cache_path=str(root / pkg.name)))
    key = pkg.ing.content_key("A v. B", "text")
    out = [key]
    cm.store_processed_case(key, {"metadata": {"name": "A v. B"}})
    out.append(cm.get_processed_case(key))
    cm.clear_memory_cache()
    out.append(cm.get_processed_case(key))  # the disk tier
    out.append(cm.get_processed_case("missing"))
    (root / pkg.name / "processed" / "bad.json").write_text("{not json")
    out.append(cm.get_processed_case("bad"))
    out.append((root / pkg.name / "processed" / "bad.json").exists())
    cm.health_check()
    out.append(vars(cm.get_stats()))
    out.append(sorted(p.name for p in (root / pkg.name / "processed").iterdir()))
    off = pkg.ing.CacheManager(pkg.conf.CacheConfig(enabled=False))
    off.store_processed_case(key, {"x": 1})
    out.append(off.get_processed_case(key))
    return out


def test_cache_processed_case_matches_jax(tmp_path):
    assert _cache_run(PORT, tmp_path) == _cache_run(JAX, tmp_path)
    assert (tmp_path / "jax" / "processed").iterdir() and [
        p.read_bytes() for p in sorted((tmp_path / "jax" / "processed").iterdir())] == [
        p.read_bytes() for p in sorted((tmp_path / "port" / "processed").iterdir())]


# -- pipeline -----------------------------------------------------------------------------


def _mixed_cases(pkg):
    """40 cases: duplicates (of valid and of invalid ones, in the same and in
    later batches), validation failures of each kind, cases without word
    count, citation or judges for the enhancement to fill."""
    out = []
    for i in range(40):
        kw, text = {}, f"Judge Marshall delivered the opinion in matter {i}. " + LONG_TEXT
        name, cit = f"Case {i} v. Board", f"{i} U.S. {i + 1} (1950)"
        if i % 9 == 4:
            text = "too short"
        if i % 11 == 5:
            kw["court"] = ""
        if i % 13 == 6:
            kw["decision_date"] = dt.date.today() + dt.timedelta(days=30)
        if i % 5 == 3:
            cit = ""
            text = f"See {i} U.S. {200 + i} (1960). " + text
        if i % 7 == 2 and i > 7:  # a duplicate of case i - 7
            name, cit = f"Case {i - 7} v. Board", f"{i - 7} U.S. {i - 6} (1950)" if (i - 7) % 5 != 3 else ""
            text = out[i - 7][1]
        if i % 4 == 1:
            kw["word_count"] = 77
            kw["judges"] = ["Holmes"]
        out.append((make_case(pkg, i, name=name, citation=cit, **kw), text))
    return out


def _enhance_case(pkg):
    text = "Justice Marshall delivered the opinion. See 163 U.S. 537 (1896). " + LONG_TEXT
    c = make_case(pkg, 7, name="Plessy v. Ferguson", citation="")
    return [(c, text)]


SCENARIOS = {
    # name: (cases(pkg) -> source, ingestion config edits, runs)
    "landmarks": (landmarks, {}, 1),
    "reingest": (landmarks, {}, 2),
    "rejects": (lambda pkg: pkg.src.MockDataSource(
        cases=[(make_case(pkg, 0, full_text="x"), "too short")]), {}, 1),
    "enhance": (lambda pkg: pkg.src.MockDataSource(cases=_enhance_case(pkg)), {}, 1),
    "mixed_batches_of_7": (lambda pkg: pkg.src.MockDataSource(cases=_mixed_cases(pkg)),
                           dict(batch_size=7, max_concurrent_jobs=3), 2),
    "mixed_limit": (lambda pkg: pkg.src.MockDataSource(cases=_mixed_cases(pkg)),
                    dict(batch_size=100), 1),
}


def _pipeline_run(pkg, tmp_path, scenario):
    make_src, edits, runs = SCENARIOS[scenario]
    cfg = pkg.conf.Config()
    cfg.ingestion.rate_limit_delay_ms = 0
    for k, v in edits.items():
        setattr(cfg.ingestion, k, v)
    st = storage(pkg, tmp_path)
    pipe = pkg.ing.IngestionPipeline(cfg.ingestion, st, text_config=cfg.text_processing)
    src = make_src(pkg)
    limit = 25 if scenario == "mixed_limit" else None

    async def runs_in_one_loop():  # the pipeline's semaphore binds to one loop
        return [counts(await pipe.run_ingestion(src, limit)) for _ in range(runs)]

    stats = run(runs_in_one_loop())
    rows = stored_rows(st)
    st.close()
    return stats, rows


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_pipeline_matches_jax(tmp_path, scenario):
    """Every stored row and every stats count equal the JAX pipeline's."""
    got, want = _pipeline_run(PORT, tmp_path, scenario), _pipeline_run(JAX, tmp_path, scenario)
    assert got == want
    stats, rows = want
    assert rows and stats[0]["total_cases"] > 0 or scenario == "rejects"
    if scenario == "reingest":
        assert stats[1]["skipped_duplicates"] == 3 and stats[1]["processed"] == 0
    if scenario == "enhance":
        (row,) = rows.values()
        assert row[4]["word_count"] > 0 and any("163 U.S. 537" in c for c in row[4]["citations"])
        assert any("Marshall" in j for j in row[4]["judges"])
    if scenario == "mixed_batches_of_7":
        s = stats[0]
        assert s["processed"] + s["skipped_duplicates"] + s["failed_validation"] == 40
        assert s["skipped_duplicates"] > 0 and s["failed_validation"] > 0
        assert len(rows) == s["processed"] and stats[1]["processed"] == 0


def test_pipeline_cache_hits_match_jax(tmp_path):
    """A case processed once is served from the processed-case cache into
    a fresh store: the cached enrichment is stored under the new id."""
    out = {}
    for pkg in (JAX, PORT):
        cfg = pkg.conf.Config()
        cfg.ingestion.cache.disk_cache_path = str(tmp_path / pkg.name / "cache")
        first = storage(pkg, tmp_path / pkg.name / "a")
        run(pkg.ing.IngestionPipeline(cfg.ingestion, first).run_ingestion(
            pkg.src.MockDataSource(cases=_enhance_case(pkg))))
        second = storage(pkg, tmp_path / pkg.name / "b")
        cases = _enhance_case(pkg)
        cases[0][0].id = uuid.UUID(int=99)
        pipe = pkg.ing.IngestionPipeline(cfg.ingestion, second)
        stats = run(pipe.run_ingestion(pkg.src.MockDataSource(cases=cases)))
        out[pkg.name] = (counts(stats), stored_rows(second), vars(pipe.cache.get_stats()))
        first.close()
        second.close()
    assert out["port"] == out["jax"]
    assert out["jax"][0]["cache_hits"] == 1 and str(uuid.UUID(int=99)) in out["jax"][1]


def test_pipeline_unhealthy_source_matches_jax(tmp_path):
    msgs = []
    for pkg in (JAX, PORT):
        pipe = pkg.ing.IngestionPipeline(pkg.conf.Config().ingestion, storage(pkg, tmp_path))
        with pytest.raises(pkg.errors.SourceUnavailable) as e:
            run(pipe.run_ingestion(pkg.src.MockDataSource(healthy=False)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _retry_run(pkg, tmp_path, recoverable):
    class Flaky(pkg.src.MockDataSource):
        calls = 0

        async def fetch_cases(self, limit=None):
            self.calls += 1
            if self.calls < 3:
                raise (pkg.errors.NetworkError("blip") if recoverable
                       else pkg.errors.ParseError(source="broken", details="bad schema"))
            return await super().fetch_cases(limit)

    cfg = pkg.conf.Config()
    cfg.ingestion.retry_attempts, cfg.ingestion.retry_delay_seconds = 3, 0
    pipe = pkg.ing.IngestionPipeline(cfg.ingestion, storage(pkg, tmp_path))
    src = Flaky(cases=[c for c in landmarks(pkg)._cases])
    try:
        return counts(run(pipe.run_ingestion(src))), src.calls
    except pkg.errors.SearchError as e:
        return (type(e).__name__, str(e)), src.calls


@pytest.mark.parametrize("recoverable", [True, False])
def test_fetch_retries_match_jax(tmp_path, recoverable):
    got, want = _retry_run(PORT, tmp_path, recoverable), _retry_run(JAX, tmp_path, recoverable)
    assert got == want
    assert want[1] == (3 if recoverable else 1)


def test_pipeline_counts_hold_under_thread_switching(tmp_path):
    """Sixteen workers over 300 cases, a third of them duplicates, with the
    interpreter switching threads every microsecond: no count is lost and
    every case is stored once."""
    cfg = pconf.Config()
    cfg.ingestion.rate_limit_delay_ms = 0
    cfg.ingestion.max_concurrent_jobs = 16
    cases = []
    for i in range(300):
        j = i if i % 3 else i // 3  # every third case repeats an earlier name
        cases.append((make_case(PORT, i, name=f"Case {j} v. Board", citation=f"{j} U.S. 1 (1950)"),
                      LONG_TEXT))
    st = storage(PORT, tmp_path)
    pipe = ping.IngestionPipeline(cfg.ingestion, st)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats = run(asyncio.wait_for(pipe.run_ingestion(psrc.MockDataSource(cases=cases)), 120))
    finally:
        sys.setswitchinterval(old)
    names = {c[0].name for c in cases}
    assert stats.processed == len(names) == len(stored_rows(st))
    assert stats.processed + stats.skipped_duplicates == 300 and stats.failed_processing == 0
    st.close()


# -- manager ------------------------------------------------------------------------------


def _manager(pkg, tmp_path, **edits):
    cfg = pkg.conf.Config()
    cfg.ingestion.rate_limit_delay_ms = 0
    for k, v in edits.items():
        setattr(cfg.ingestion, k, v)
    st = storage(pkg, tmp_path / pkg.name)
    return cfg, st


def _job(job):
    return (job.job_type.value, job.source, job.limit, job.status.value, job.error,
            counts(job.stats) if job.stats else None,
            job.started_at is not None and job.finished_at is not None)


class UpdatingSource:
    """A mixin: the source reports its first two cases as updated."""

    async def list_updated_cases(self, since, limit=None):
        return [str(m.id) for m, _ in self._cases[:2]]


def _manager_run(pkg, tmp_path, scenario):
    hook = []
    cfg, st = _manager(pkg, tmp_path, batch_size=1 if scenario in ("pause", "cancel") else 100)
    mgr = pkg.ing.IngestionManager(cfg, st, on_ingest_complete=lambda: hook.append(1))
    mgr.register_source(landmarks(pkg))
    jobs = []
    if scenario == "bulk":
        jobs.append(run(mgr.ingest_bulk("mock")))
        jobs.append(run(mgr.ingest_bulk()))  # every source: all duplicates now
    elif scenario == "limit":
        jobs.append(run(mgr.ingest_bulk("mock", limit=2)))
    elif scenario == "unknown":
        jobs.append(run(mgr.ingest_bulk("nope")))
    elif scenario == "incremental_no_updates":
        jobs.append(run(mgr.check_for_updates("mock")))  # no watermark yet: a bulk run
        jobs.append(run(mgr.check_for_updates("mock")))
    elif scenario == "incremental_updates":
        base = landmarks(pkg)
        src = type("Updating", (UpdatingSource, type(base)), {})(cases=base._cases)
        mgr.register_source(src)
        jobs.append(run(mgr.check_for_updates("mock", limit=1)))
        st.delete_case(base._cases[0][0].id)
        jobs.append(run(mgr.check_for_updates()))
    elif scenario == "reprocess":
        jobs.append(run(mgr.ingest_bulk("mock")))
        for cid in st.list_case_ids():
            meta = st.get_case_metadata(cid)
            meta.word_count, meta.judges, meta.citations = 0, [], []
            st.store_case_metadata(meta)
        jobs.append(run(mgr.reprocess()))
    elif scenario == "pause":
        async def drive():
            mgr.pause()
            task = asyncio.create_task(mgr.ingest_bulk("mock"))
            await asyncio.sleep(0.1)
            held = (task.done(), [j.status.value for j in mgr.jobs], mgr.pipeline.paused)
            mgr.pause()
            mgr.resume()
            return held, await asyncio.wait_for(task, timeout=30)
        held, job = run(drive())
        jobs.append(job)
    elif scenario == "cancel":
        async def drive():
            mgr.pause()
            task = asyncio.create_task(mgr.ingest_bulk("mock"))
            await asyncio.sleep(0.1)
            await asyncio.wait_for(mgr.cancel(), timeout=10)
            return await asyncio.wait_for(task, timeout=30)
        jobs.append(run(drive()))
        mgr.resume()
        jobs.append(run(mgr.ingest_bulk("mock")))  # the next run is not cancelled
    out = dict(jobs=[_job(j) for j in jobs], held=held if scenario == "pause" else None,
               stats={k: v for k, v in vars(mgr.get_stats()).items() if k != "last_run"},
               ids=[j.id for j in mgr.get_jobs()] == [j.id for j in mgr.jobs],
               hook=hook, rows=stored_rows(st),
               watermark=mgr.cache.get_last_update("mock") is not None)
    st.close()
    return out


MANAGER_SCENARIOS = ["bulk", "limit", "unknown", "incremental_no_updates", "incremental_updates",
                     "reprocess", "pause", "cancel"]


@pytest.mark.parametrize("scenario", MANAGER_SCENARIOS)
def test_manager_matches_jax(tmp_path, scenario):
    """Jobs (type, status, error, stats), the manager's totals, the rebuild
    hook, the watermark and every stored row equal the JAX manager's."""
    got, want = _manager_run(PORT, tmp_path / "p", scenario), _manager_run(JAX, tmp_path / "j", scenario)
    assert got == want
    first = want["jobs"][0]
    expect = {"bulk": "completed", "limit": "completed", "unknown": "failed",
              "incremental_no_updates": "completed", "incremental_updates": "completed",
              "reprocess": "completed", "pause": "completed", "cancel": "cancelled"}[scenario]
    assert first[3] == expect
    if scenario == "cancel":
        assert want["jobs"][1][3] == "completed" and want["jobs"][1][5]["processed"] == 3
    if scenario == "reprocess":
        assert want["jobs"][1][5]["processed"] == 3 and want["hook"] == [1, 1]
        assert all(r[4]["word_count"] > 0 for r in want["rows"].values())
    if scenario == "incremental_updates":
        assert want["jobs"][1][5]["processed"] == 2  # the deleted case and the one never fetched
    if scenario == "pause":
        assert want["held"] == (False, ["paused"], True)


# -- CAP and CourtListener ------------------------------------------------------------------


CAP_CASE = {
    "id": 1,
    "url": "https://api.case.law/v1/cases/1/",
    "name": "Brown v. Board of Education",
    "decision_date": "1954-05-17",
    "docket_number": "No. 1",
    "citations": [{"cite": "347 U.S. 483", "type": "official"}, {"cite": ""}],
    "court": {"name": "Supreme Court of the United States", "slug": "us"},
    "jurisdiction": {"slug": "us", "name": "U.S."},
    "analysis": {"word_count": 4000},
    "casebody": {"status": "ok", "data": {
        "head_matter": "Argued December 9, 1952.",
        "parties": ["Oliver Brown", "Board of Education"],
        "attorneys": ["Thurgood Marshall"],
        "judges": ["Warren, C. J."],
        "opinions": [{"type": "majority", "author": "Warren",
                      "text": "Separate educational facilities are inherently unequal."},
                     {"type": "dissent", "text": "I dissent."}],
    }},
}
CAP_STATE = dict(CAP_CASE, id=2, name="State v. Smith", jurisdiction={"slug": "ca"}, casebody={},
                 citations=[], analysis=None)
CL_HIT = {
    "id": 42, "caseName": "Gideon v. Wainwright", "dateFiled": "1963-03-18T00:00:00",
    "citation": ["372 U.S. 335"], "court": "Supreme Court of the United States",
    "judge": "Black; Douglas", "docketNumber": "155", "absolute_url": "/opinion/42/",
    "snippet": "<p>The right to counsel is &amp; fundamental.</p>",
}
CL_OTHER = {"id": 43, "case_name": "Katz v. United States", "date_filed": "1967-12-18",
            "citation": "389 U.S. 347", "text": ""}


def handler(request: httpx.Request) -> httpx.Response:
    """One fake API for both sources of both packages."""
    url = str(request.url)
    auth = request.headers.get("Authorization")
    if "fail429" in url:
        return httpx.Response(429, text="slow down")
    if "fail500" in url:
        return httpx.Response(500, text="boom")
    if "notjson" in url:
        return httpx.Response(200, text="<html>")
    if "/cases/1/" in url:
        return httpx.Response(200, json=CAP_CASE)
    if "/cases/" in url and "page=2" in url:
        return httpx.Response(200, json={"next": None, "results": [CAP_STATE, {"name": "no date"}]})
    if "/cases/" in url:
        bad = dict(CAP_CASE, id=9, decision_date="not-a-date")
        return httpx.Response(200, json={"next": url.split("?")[0] + "?page=2", "auth": auth,
                                         "results": [CAP_CASE, bad, {"no": "id"}]})
    if "opinions/7/" in url:
        return httpx.Response(200, json={"id": 7, "cluster": "https://cl.test/api/rest/v3/clusters/9/",
                                         "html": "<p>Full &nbsp;opinion</p>", "absolute_url": "/o/7/"})
    if "opinions/8/" in url:
        return httpx.Response(200, json={"id": 8, "cluster": "https://cl.test/fail500/"})
    if "clusters/9/" in url:
        return httpx.Response(200, json={
            "case_name": "Katz v. United States", "date_filed": "1967-12-18",
            "citations": [{"volume": 389, "reporter": "U.S.", "page": 347}],
            "judges": "Stewart, Black", "court": "scotus", "docket": "35"})
    if "search/" in url and "page=2" in url:
        return httpx.Response(200, json={"next": None, "results": [CL_OTHER, {"id": 44}]})
    if "search/" in url:
        return httpx.Response(200, json={"next": url + "&page=2", "results": [CL_HIT]})
    return httpx.Response(404)


def _payload(p):
    meta, text = p
    d = meta.to_json()
    d.pop("id")
    d.pop("ingestion_date")
    return d, text


def _source_run(pkg, scenario):
    seen = []

    def recording(request):
        seen.append((str(request.url), request.headers.get("Authorization")))
        return handler(request)

    client = httpx.AsyncClient(transport=httpx.MockTransport(recording),
                               headers={"Authorization": "Token sekrit"})
    kind, what = scenario.split(":")
    if kind == "cap":
        api = "https://api.test/v1/" + ("fail429/" if what == "429" else "fail500/" if what == "500"
                                        else "notjson/" if what == "notjson" else "")
        src = pkg.src.CapDataSource(pkg.conf.CapConfig(api_url=api, api_key="sekrit"), client=client,
                                    requests_per_minute=10**6, backoff_seconds=0.0,
                                    jurisdictions=["us", "ca"],
                                    date_range=(dt.date(1950, 1, 1), dt.date(1960, 1, 1)))
    else:
        api = "https://cl.test/api/rest/v3/" + ("fail429/" if what == "429" else "")
        src = pkg.src.CourtListenerDataSource(pkg.conf.CourtListenerConfig(api_url=api), client=client,
                                              requests_per_minute=10**6, backoff_seconds=0.0)
    calls = {
        "fetch": lambda: src.fetch_cases(),
        "fetch_limit": lambda: src.fetch_cases(limit=1),
        "429": lambda: src.fetch_cases(),
        "500": lambda: src.fetch_cases(),
        "notjson": lambda: src.fetch_cases(),
        "health": lambda: src.health_check(),
        "fetch_case": lambda: src.fetch_case("1" if kind == "cap" else "7"),
        "fetch_case_no_cluster": lambda: src.fetch_case("8"),
        "available": lambda: src.list_available_cases(limit=2),
        "updated": lambda: src.list_updated_cases(dt.datetime(2020, 1, 2), limit=5),
        "search": lambda: src.search_cases("equal protection", limit=1),
    }
    try:
        res = run(calls[what]())
        if what == "health":
            res = (res.healthy, res.message if not res.healthy else "", res.response_time_ms is not None)
        elif isinstance(res, list) and res and isinstance(res[0], tuple):
            res = [_payload(p) for p in res]
        elif isinstance(res, tuple):
            res = _payload(res)
    except pkg.errors.SearchError as e:
        res = (type(e).__name__, str(e))
    st = {k: v for k, v in vars(src.stats).items() if k != "last_fetch"}
    return res, st, seen, vars(src.get_source_info()), vars(src.get_rate_limits())


SOURCE_SCENARIOS = [f"cap:{w}" for w in ("fetch", "fetch_limit", "429", "500", "notjson", "health",
                                         "fetch_case", "available", "updated", "search")] + [
    f"cl:{w}" for w in ("fetch", "fetch_limit", "429", "health", "fetch_case",
                        "fetch_case_no_cluster", "available", "updated", "search")]


@pytest.mark.parametrize("scenario", SOURCE_SCENARIOS)
def test_sources_match_jax(scenario):
    """Converted payloads (ids and ingestion dates aside), errors, stats,
    the requests made (pagination, query strings, the auth header) and the
    source info equal the JAX clients'."""
    got, want = _source_run(PORT, scenario), _source_run(JAX, scenario)
    assert got == want
    res, stats, seen, _, _ = want
    assert seen and all(auth == "Token sekrit" for _, auth in seen)
    if scenario == "cap:fetch":
        assert len(res) == 2 and stats["errors"] == 3 and len(seen) == 2  # three malformed skipped
        assert "OPINION (MAJORITY) by Warren:" in res[0][1] and res[1][0]["jurisdiction"] != "federal"
    if scenario.endswith(":429"):
        assert res[0] == "RateLimitExceeded" and stats["rate_limit_hits"] == 1
    if scenario == "cap:500":
        assert res[0] == "NetworkError"
    if scenario == "cap:notjson":
        assert res[0] == "ParseError"
    if scenario == "cl:fetch":
        assert len(res) == 2 and "<p>" not in res[0][1] and stats["errors"] == 1

