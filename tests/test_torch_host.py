"""The port's copies of the JAX package's host-side modules against the
originals: text processing, snippets, the TOML config loader and writer,
the sqlite store (a database the JAX package wrote, its lookups and
backups), the domain types' JSON, logging, the metrics reporter and the
maintenance tasks, the one-query trie search and the utils."""

import dataclasses
import datetime as dt
import time
import uuid

import pytest

from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu.core.types import CaseMetadata as JaxCaseMetadata
from trie_semantic_search_tpu.search.snippets import HighlightType as JaxHighlightType
from trie_semantic_search_tpu.search.snippets import generate_snippet as jax_snippet
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu.text.processor import TextProcessor as JaxTextProcessor
from trie_semantic_search_tpu_torch.core.config import Config, StorageConfig
from trie_semantic_search_tpu_torch.core.errors import ConfigError, ValidationFailed
from trie_semantic_search_tpu_torch.core.types import CaseMetadata, Jurisdiction
from trie_semantic_search_tpu_torch.search.snippets import HighlightType, generate_snippet
from trie_semantic_search_tpu_torch.storage.store import StorageManager
from trie_semantic_search_tpu_torch.text.processor import TextProcessor

TEXTS = [
    "We conclude that in the field of public education the doctrine of "
    "separate but equal has no place. Separate educational facilities are "
    "inherently unequal. This case concerns racial segregation in public "
    "schools and the equal protection clause.",
    "The person in custody must, prior to interrogation, be clearly informed "
    "that he has the right to remain silent!!  The privilege against "
    "self-incrimination is protected... by procedural safeguards?",
    "“Curly quotes” and ‘single’ ones,\ttabs\n\nand a new paragraph. "
    "Ok. Short. " + "A very long sentence " * 80 + "ends here. Café naïve​.",
    "Negligence in  maintaining the gangway was the proximate cause of the "
    "injury; see 347 U.S. 483 (1954) and 12 Cal. 3d 456 (Cal. 1974). Judge Learned Hand.",
    "",
    "tiny",
]


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_text_processor_matches_jax(i):
    text = TEXTS[i]
    ours, ref = TextProcessor(), JaxTextProcessor()
    assert ours.normalize_text(text) == ref.normalize_text(text)
    norm = ref.normalize_text(text)
    assert ours.extract_sentences(norm) == ref.extract_sentences(norm)
    a, b = ours.process_text(text), ref.process_text(text)
    assert [(t.text, t.position, t.token_type.value, t.is_stopword) for t in a.tokens] == \
        [(t.text, t.position, t.token_type.value, t.is_stopword) for t in b.tokens]
    assert [c.normalized for c in a.citations] == [c.normalized for c in b.citations]
    assert [e.text for e in a.entities] == [e.text for e in b.entities]
    assert dataclasses.astuple(a.stats) == dataclasses.astuple(b.stats)


@pytest.mark.parametrize("query,chunk,htype", [
    ("remain silent", None, "exact_match"),
    ("separate but equal", None, "case_name"),
    ("completely unrelated words", "Separate educational facilities are inherently unequal", "semantic_match"),
    ("unrelated", "The privilege against self-incrimination is protected", "semantic_match"),
    ("absent", "zzz not there", "citation"),
    ("the", None, "exact_match"),
])
def test_generate_snippet_matches_jax(query, chunk, htype):
    for text in TEXTS:
        got = generate_snippet(text, query, highlight_type=HighlightType(htype), chunk_text=chunk)
        want = jax_snippet(text, query, highlight_type=JaxHighlightType(htype), chunk_text=chunk)
        assert got[0] == want[0]
        assert [(h.start, h.end, h.highlight_type.value) for h in got[1]] == \
            [(h.start, h.end, h.highlight_type.value) for h in want[1]]


def test_config_from_file_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "config.toml"
    path.write_text(
        "[server]\nport = 9000\nbatch_max = 128\n"
        "[storage]\ndb_path = \"/tmp/x.db\"\ndb_type = \"sled\"\n"
        "[search]\nmin_query_length = 3\nquery_cache_ttl_seconds = 60\n"
        "fused_recall_target = 1.0\n"
        "[vector]\ndimension = 64\npooling = \"sif\"\n"
        "[vector.hnsw]\nnum_probes = 4\n[vector.model]\nmax_sequence_length = 128\n"
        "[text_processing.sentence_splitting]\nmin_sentence_length = 5\n"
        "[trie]\ncontent_windowing = \"phrase_start\"\n"
        "[mesh]\nmodel_parallel = 1\n[logging]\nlevel = \"debug\"\n"
    )
    monkeypatch.setenv("LEGAL_SEARCH_PORT", "9100")
    monkeypatch.setenv("LEGAL_SEARCH_MODEL_PATH", "/models/x")
    ours, ref = Config.from_file(path), JaxConfig.from_file(path)
    for section in ("server", "text_processing", "trie", "vector", "storage", "search"):
        assert dataclasses.asdict(getattr(ours, section)) == dataclasses.asdict(getattr(ref, section))
    assert ours.server.port == 9100 and ours.storage.db_type == "sqlite"
    defaults = Config.from_file(tmp_path / "missing.toml")
    assert dataclasses.asdict(defaults.search) == dataclasses.asdict(JaxConfig().search)
    (tmp_path / "bad.toml").write_text("[search\n")
    with pytest.raises(ConfigError):
        Config.from_file(tmp_path / "bad.toml")
    (tmp_path / "bad2.toml").write_text("[search]\nmin_query_length = 9\nmax_query_length = 4\n")
    with pytest.raises(ValidationFailed):
        Config.from_file(tmp_path / "bad2.toml")


def _meta(cls, i):
    return cls(
        id=uuid.UUID(int=i + 1), name=f"Case {i} v. State", citation=f"{i} U.S. {i + 7} (1970)",
        court=["Supreme Court", "Tax Court"][i % 2], decision_date=dt.date(1950 + i, 1, 2),
        judges=["Hand"], topics=["tax"], word_count=3 * i, docket_number=f"D-{i}",
    )


def test_storage_reads_a_jax_database(tmp_path):
    cfg = JaxConfig()
    cfg.storage.db_path = str(tmp_path / "db.sqlite")
    jst = JaxStorage(cfg.storage)
    metas = [_meta(JaxCaseMetadata, i) for i in range(5)]
    stored, errors = jst.store_cases_batch([(m, f"text of case {i}. " * (i + 1)) for i, m in enumerate(metas)])
    assert stored == 5 and not errors
    pst = StorageManager(StorageConfig(db_path=cfg.storage.db_path))
    assert pst.fetch_filter_columns() == jst.fetch_filter_columns()
    for m in metas:
        got = pst.get_case_metadata(m.id)
        assert got.to_json() == jst.get_case_metadata(m.id).to_json()
        assert pst.get_case_text(m.id) == jst.get_case_text(m.id)
    ids = [m.id for m in metas[1:4]] + [uuid.UUID(int=999)]
    assert {k: v.to_json() for k, v in pst.get_case_metadata_many(ids).items()} == \
        {k: v.to_json() for k, v in jst.get_case_metadata_many(ids).items()}
    assert pst.get_case_texts_many(ids) == jst.get_case_texts_many(ids)
    assert pst.get_case_metadata(uuid.UUID(int=999)) is None
    a, b = pst.get_stats(), jst.get_stats()
    assert (a.total_cases, a.total_text_entries) == (b.total_cases, b.total_text_entries) == (5, 5)
    pst.health_check()
    # and the JAX store reads what the port writes
    new = _meta(CaseMetadata, 7)
    new.jurisdiction = Jurisdiction.state("California")
    assert pst.store_cases_batch([(new, "port text")]) == (1, [])
    assert jst.get_case_metadata(new.id).to_json() == new.to_json()
    assert jst.get_case_text(new.id) == "port text"
    pst.close()
    jst.close()


def test_store_cases_batch_matches_jax(tmp_path):
    """A batch holding a case that cannot be serialised: both stores skip
    and report it, store the rest in the same row order, and a rewrite
    keeps each case's row."""
    cfg = JaxConfig()
    cfg.storage.db_path = str(tmp_path / "jax.sqlite")
    jst = JaxStorage(cfg.storage)
    pst = StorageManager(StorageConfig(db_path=str(tmp_path / "port.sqlite")))

    def batch(cls, n, tag):
        metas = [_meta(cls, i) for i in range(n)]
        metas[2].topics = [object()]  # json.dumps fails: SerializationFailed
        return [(m, f"{tag} text of case {i}.") for i, m in enumerate(metas)]

    for n, tag in ((4, "first"), (6, "second")):
        want = jst.store_cases_batch(batch(JaxCaseMetadata, n, tag))
        got = pst.store_cases_batch(batch(CaseMetadata, n, tag))
        assert got == want and got[0] == n - 1 and got[1][0][0] == uuid.UUID(int=3)
    assert pst.fetch_filter_columns() == jst.fetch_filter_columns()
    ids = [uuid.UUID(int=i + 1) for i in range(6)]
    assert pst.get_case_texts_many(ids) == jst.get_case_texts_many(ids)
    assert pst.get_case_text(ids[0]) == "second text of case 0."
    pst.close()
    jst.close()


@pytest.mark.parametrize("start_row,batch", [(0, 256), (0, 3), (4, 2), (11, 5)])
def test_build_iteration_matches_jax(tmp_path, start_row, batch):
    """``list_case_ids``, ``iter_cases`` and ``iter_cases_rowid`` (keyset
    pagination from ``start_row``) over the same cases, written in an order
    unlike the id order, one case without text: the same stream."""
    cfg = JaxConfig()
    cfg.storage.db_path = str(tmp_path / "jax.sqlite")
    jst = JaxStorage(cfg.storage)
    pst = StorageManager(StorageConfig(db_path=str(tmp_path / "port.sqlite")))
    order = [7, 2, 9, 0, 5, 1, 8, 3, 6, 4]
    for st, cls in ((jst, JaxCaseMetadata), (pst, CaseMetadata)):
        for i in order:
            m = _meta(cls, i)
            st.store_case_metadata(m)
            if i != 5:
                st.store_case_text(m.id, f"text of case {i}.")
    def js(m):  # each store stamped its own ingestion time
        return {k: v for k, v in m.to_json().items() if k != "ingestion_date"}

    assert pst.list_case_ids() == jst.list_case_ids()
    assert [(js(m), t) for m, t in pst.iter_cases()] == [(js(m), t) for m, t in jst.iter_cases()]
    got = [(r, js(m), t) for r, m, t in pst.iter_cases_rowid(start_row, batch)]
    want = [(r, js(m), t) for r, m, t in jst.iter_cases_rowid(start_row, batch)]
    assert got == want
    assert [r for r, _, _ in got] == list(range(start_row, len(order)))
    cols = pst.fetch_filter_columns()
    assert all(cols[r][0] == m["id"] for r, m, _ in got)
    pst.close()
    jst.close()


# -- the serving slice's host pieces -------------------------------------------

REFERENCE_TOML = """
[server]
host = "10.0.0.1"
port = 8081
api_key = "k\\"ey"

[ingestion.cap]
api_key = "cap-key"

[ingestion.validation]
required_fields = ["title", "court"]

[vector]
dimension = 768

[vector.hnsw]
m = 32
ef_search = 100

[storage]
db_type = "sled"

[logging]
json_format = true
file_path = "/var/log/x.log"

[performance]
worker_threads = 3

[performance.gc]
interval_seconds = 17

[mesh]
enabled = false
axis_names = ["rows", "cols"]
"""


@pytest.mark.parametrize("source", ["defaults", "reference_style"])
def test_config_toml_matches_jax(tmp_path, source):
    """``to_toml`` writes the JAX package's bytes for the same file,
    ``save_to_file`` round-trips, and every section (the new ones too)
    loads to the JAX package's values."""
    path = tmp_path / "in.toml"
    path.write_text("" if source == "defaults" else REFERENCE_TOML)
    ours, ref = Config.from_file(path), JaxConfig.from_file(path)
    assert ours.to_toml() == ref.to_toml()
    assert ours.to_dict() == ref.to_dict()
    ours.save_to_file(tmp_path / "out.toml")
    again = Config.from_file(tmp_path / "out.toml")
    assert again.to_toml() == ours.to_toml()
    if source == "reference_style":
        assert (ours.server.host, ours.vector.hnsw.m, ours.storage.db_type) == ("10.0.0.1", 32, "sqlite")
        assert ours.server.api_key == 'k"ey' and ours.ingestion.cap.api_key == "cap-key"
        assert ours.logging.json_format and ours.performance.gc.interval_seconds == 17
        assert not ours.mesh.enabled and ours.performance.worker_threads == 3
    bad = Config()
    bad.mesh.model_parallel = 0
    with pytest.raises(ValidationFailed, match="model_parallel"):
        bad.validate()
    bad.server.api_key = object()
    with pytest.raises(ConfigError):
        bad.to_toml()


def test_init_logging_json(tmp_path):
    import json
    import logging

    from trie_semantic_search_tpu_torch.core.config import LoggingConfig
    from trie_semantic_search_tpu_torch.core.logging import get_logger, init_logging

    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        log_file = tmp_path / "log.jsonl"
        init_logging(LoggingConfig(level="warn", json_format=True, file_path=str(log_file)))
        log = get_logger("test")
        log.info("dropped below the level")
        log.warning("kept %d", 7)
        try:
            raise ValueError("boom")
        except ValueError:
            log.exception("failed")
        for h in root.handlers:
            h.flush()
        recs = [json.loads(line) for line in log_file.read_text().splitlines()]
        assert [r["fields"]["message"] for r in recs] == ["kept 7", "failed"]
        assert recs[0]["level"] == "WARNING" and recs[0]["target"] == "tss_torch.test"
        assert recs[0]["timestamp"].endswith("Z") and isinstance(recs[0]["threadId"], int)
        assert "ValueError: boom" in recs[1]["fields"]["exception"]
    finally:
        for h in root.handlers:
            h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])


def test_metrics_reporter_and_maintenance_tasks(tmp_path, caplog, monkeypatch):
    """The reporter logs snapshots; a failing task counts errors and keeps
    running; the backup task writes a backup at once; the GC task clears
    its caches past the threshold; both are None when switched off."""
    import logging
    import time

    from trie_semantic_search_tpu_torch.core import maintenance
    from trie_semantic_search_tpu_torch.core.config import GcConfig
    from trie_semantic_search_tpu_torch.core.metrics import MetricsRegistry, MetricsReporter

    reg = MetricsRegistry()
    reg.inc("x")
    rep = MetricsReporter(interval_seconds=0.05, registry=reg, extra=lambda: {"probe": 1})
    with caplog.at_level(logging.INFO, logger="tss_torch.metrics"):
        rep.start()
        time.sleep(0.2)
        rep.stop()
    assert any("metrics:" in r.message and "'probe': 1" in r.message for r in caplog.records)

    def boom():
        raise RuntimeError("x")

    t = maintenance.PeriodicTask("b", 0.02, boom)
    t.start()
    time.sleep(0.1)
    t.stop()
    assert t.errors >= 2 and t._thread is None

    cfg = StorageConfig(db_path=str(tmp_path / "x.db"))
    cfg.backup.backup_dir = str(tmp_path / "backups")
    store = StorageManager(cfg)
    task = maintenance.make_backup_task(store, cfg.backup)
    task.start()
    for _ in range(100):
        if task.runs:
            break
        time.sleep(0.02)
    task.stop()
    assert task.runs == 1 and len(list((tmp_path / "backups").glob("*.db"))) == 1
    cfg.backup.enabled = False
    assert maintenance.make_backup_task(store, cfg.backup) is None
    store.close()

    cleared = []

    class Cache:
        def clear(self):
            cleared.append(1)

    monkeypatch.setattr(maintenance.SystemUtils, "memory_usage", staticmethod(lambda: 99))
    maintenance.make_gc_task(GcConfig(memory_threshold_percent=0), caches=[Cache(), Cache()]).fn()
    assert cleared == [1, 1]
    maintenance.make_gc_task(GcConfig(memory_threshold_percent=101), caches=[Cache()]).fn()
    assert cleared == [1, 1]
    assert maintenance.make_gc_task(GcConfig(enabled=False)) is None


def test_store_lookups_and_backups_match_jax(tmp_path, monkeypatch):
    """``find_case_id``, ``case_exists``, ``delete_case`` and
    ``create_backup`` (with retention) on a database the JAX package
    wrote, answer as the JAX store does."""
    import itertools
    import sqlite3

    stamps = itertools.count()  # backups are named by the second: one a "second"
    monkeypatch.setattr(time, "strftime", lambda fmt: f"20260101_{next(stamps):06d}")

    cfg = JaxConfig()
    cfg.storage.db_path = str(tmp_path / "db.sqlite")
    cfg.storage.backup.backup_dir = str(tmp_path / "jax_backups")
    cfg.storage.backup.max_backups = 2
    jst = JaxStorage(cfg.storage)
    metas = [_meta(JaxCaseMetadata, i) for i in range(4)]
    jst.store_cases_batch([(m, f"text {i}") for i, m in enumerate(metas)])
    pcfg = StorageConfig(db_path=cfg.storage.db_path)
    pcfg.backup.backup_dir = str(tmp_path / "port_backups")
    pcfg.backup.max_backups = 2
    pst = StorageManager(pcfg)
    for m in metas:
        assert pst.find_case_id(m.name, m.citation) == jst.find_case_id(m.name, m.citation) == m.id
        assert pst.case_exists(m.id) and jst.case_exists(m.id)
    assert pst.find_case_id("Case 1 v. State", "wrong") is None
    assert not pst.case_exists(uuid.UUID(int=999))
    assert pst.delete_case(metas[1].id)
    assert not jst.case_exists(metas[1].id) and jst.get_case_text(metas[1].id) is None
    assert not pst.delete_case(metas[1].id) and not jst.delete_case(metas[1].id)
    assert pst.list_case_ids() == jst.list_case_ids()
    for store, d in ((pst, "port_backups"), (jst, "jax_backups")):
        paths = []
        for _ in range(3):
            paths.append(store.create_backup())
        assert sorted(p.name for p in (tmp_path / d).glob("*.db")) == [p.name for p in paths[1:]]
        with sqlite3.connect(paths[-1]) as conn:
            assert conn.execute("SELECT COUNT(*) FROM case_metadata").fetchone()[0] == 3
    pcfg.backup.enabled = False
    assert pst.create_backup() is None
    with StorageManager(StorageConfig(db_type="memory")) as mem:
        assert mem.create_backup() is None
    pst.close()
    jst.close()


def test_trie_search_matches_jax(tmp_path):
    """``TrieIndex.search``: the name trie, else the citation trie, else the
    content trie's subtree, with completions, as the JAX package answers
    over the same saved tries."""
    from trie_semantic_search_tpu.index.trie import TrieIndex as JaxTrieIndex
    from trie_semantic_search_tpu_torch.index.trie import TrieIndex

    jt = JaxTrieIndex()
    cases = ["Brown v. Board of Education", "Brown v. Allen", "Miranda v. Arizona"]
    for row, name in enumerate(cases):
        jt.insert_case_name(name, row)
        jt.insert_citation(f"{row} U.S. {row + 10} (1954)", row)
        jt.insert_content("separate educational facilities are inherently unequal".split(), row, 1)
    jt.freeze()
    jt.save_to_disk(tmp_path / "trie")
    pt = TrieIndex.load_from_disk(tmp_path / "trie", device="cpu")
    for q in ("brown v. board of education", "Brown v.", "miranda", "1 U.S. 11 (1954)",
              "educational facilities", "facilities are inherently", "nothing here", ""):
        got, want = pt.search(q), jt.search(q)
        assert (got.exact_matches, got.prefix_completions, got.total_matches) == \
            (want.exact_matches, want.prefix_completions, want.total_matches), q


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    from trie_semantic_search_tpu_torch.core.metrics import profile_trace

    with profile_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_utils_match_jax():
    from trie_semantic_search_tpu import utils as ju
    from trie_semantic_search_tpu_torch import utils as tu

    for text in ("", "short", "a b c d e f g", "ctrl\x01\x7f\ttab\nline \x9f end", "x" * 50):
        for f in ("sanitize", "word_count", "text_hash"):
            assert getattr(tu.TextUtils, f)(text) == getattr(ju.TextUtils, f)(text)
        for n in (0, 2, 5, 100):
            assert tu.TextUtils.truncate(text, n) == ju.TextUtils.truncate(text, n)
            assert tu.TextUtils.extract_preview(text, n) == ju.TextUtils.extract_preview(text, n)
    for n in (0, 1023, 1024, 5 * 2**30, 2**50):
        assert tu.SystemUtils.format_bytes(n) == ju.SystemUtils.format_bytes(n)
    for s in (0, 59, 61, 3661, 90000):
        assert tu.SystemUtils.format_duration(s) == ju.SystemUtils.format_duration(s)
    assert tu.SystemUtils.memory_usage() > 0 and tu.SystemUtils.uptime() > 0
    assert tu.SystemUtils.anon_memory_usage() > 0
    for s in (str(uuid.UUID(int=5)), "nope", ""):
        assert tu.ValidationUtils.is_valid_case_id(s) == ju.ValidationUtils.is_valid_case_id(s)
    for c in ("347 U.S. 483 (1954)", "U.S. 483", "12 Cal. 3d 456 (Cal. 1974)"):
        assert tu.ValidationUtils.is_valid_citation(c) == ju.ValidationUtils.is_valid_citation(c)
    for q in ("  ab ", "a", "x" * 20):
        assert tu.ValidationUtils.is_valid_search_query(q, 2, 10) == \
            ju.ValidationUtils.is_valid_search_query(q, 2, 10)
    assert tu.ValidationUtils.sanitize_filename("a b/c.d") == ju.ValidationUtils.sanitize_filename("a b/c.d")
    with tu.time_block("t") as timer:
        pass
    assert timer.elapsed_ms() >= 0 and tu.Timer("u").stop() >= 0
