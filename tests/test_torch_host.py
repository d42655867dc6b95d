"""The port's copies of the JAX package's host-side modules against the
originals: text processing, snippets, the TOML config loader, the sqlite
store (a database the JAX package wrote) and the domain types' JSON."""

import dataclasses
import datetime as dt
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
