"""The port's ``SearchEngine`` against the JAX package's, over artifacts and
a sqlite store that the JAX package built and saved.

Both engines serve the same ``search_batch`` requests, the port on the CPU,
with the same query embeddings (the JAX encoder's, put in the port's
embedding cache: the encoders agree to a bf16 tolerance, which
``test_loaded_encoder_matches_jax`` holds). Case ids, order, match types,
snippets and highlights must be identical.
Scores: lexical hits score the exact-match weight on both sides; semantic
hits are bitwise equal in the brute mode (int8 scores, same multiply
order) and within 1e-5 in the partitioned mode, whose bf16 rescore sums in
another order (as in ``tests/test_torch_slice.py``).

The kernel branches run on the JAX side as ``tests/test_torch_slice.py``
runs them: the fused scan and the probe/rescore kernels in Pallas interpret
mode; on the port's side the same branches run the kernels' plain versions.
"""

import dataclasses
import datetime as dt
import functools
import shutil
import uuid
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import trie_semantic_search_tpu.ops.hybrid as jax_hybrid
from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu.core.types import CaseMetadata as JaxCaseMetadata
from trie_semantic_search_tpu.index.builder import build_indexes, save_artifacts
from trie_semantic_search_tpu.index.builder import load_artifacts as jax_load_artifacts
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.minilm import MiniLMConfig as JaxMiniLMConfig
from trie_semantic_search_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from trie_semantic_search_tpu.models.tokenizer import train_wordpiece_vocab
from trie_semantic_search_tpu.ops.pallas_scan import pallas_fused_topk
from trie_semantic_search_tpu.search.engine import SearchEngine as JaxEngine
from trie_semantic_search_tpu.search.engine import SearchQuery as JaxQuery
from trie_semantic_search_tpu.core.types import SearchConfig as JaxSearchConfig
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu_torch.core.config import Config
from trie_semantic_search_tpu_torch.core.errors import IndexCorrupted, InvalidSearchQuery
from trie_semantic_search_tpu_torch.core.types import SearchConfig
from trie_semantic_search_tpu_torch.index.builder import load_artifacts
from trie_semantic_search_tpu_torch.search.engine import MatchType, SearchEngine, SearchQuery
from trie_semantic_search_tpu_torch.storage.store import StorageManager

torch.set_num_threads(1)

COURTS = ["Supreme Court of the United States", "Supreme Court of California",
          "Ninth Circuit"]
CASES = [
    ("Brown v. Board of Education", "347 U.S. 483 (1954)", COURTS[0], dt.date(1954, 5, 17),
     "We conclude that in the field of public education the doctrine of "
     "separate but equal has no place. Separate educational facilities "
     "are inherently unequal. This case concerns racial segregation in "
     "public schools and the equal protection clause."),
    ("Miranda v. Arizona", "384 U.S. 436 (1966)", COURTS[0], dt.date(1966, 6, 13),
     "The person in custody must, prior to interrogation, be clearly "
     "informed that he has the right to remain silent. The privilege "
     "against self-incrimination is protected by procedural safeguards "
     "during custodial interrogation by police officers."),
    ("Gideon v. Wainwright", "372 U.S. 335 (1963)", COURTS[0], dt.date(1963, 3, 18),
     "The right of an indigent defendant in a criminal trial to have the "
     "assistance of counsel is a fundamental right essential to a fair "
     "trial. Lawyers in criminal courts are necessities, not luxuries."),
    ("Katz v. United States", "389 U.S. 347 (1967)", COURTS[0], dt.date(1967, 12, 18),
     "The Fourth Amendment protects people, not places. What a person "
     "knowingly exposes to the public is not a subject of Fourth "
     "Amendment protection, but what he seeks to preserve as private "
     "may be constitutionally protected from search and seizure."),
    ("Smith v. Jones Lumber Co.", "12 Cal. 3d 456 (Cal. 1974)", COURTS[1], dt.date(1974, 2, 1),
     "The defendant lumber company breached its contract to deliver "
     "timber. The plaintiff is entitled to damages for breach of "
     "contract measured by the difference in market price."),
    ("Doe v. Pacific Shipping", "88 F.2d 120 (9th Cir. 1981)", COURTS[2], dt.date(1981, 9, 3),
     "The carrier owed a duty of care to the passengers aboard its vessel. "
     "Negligence in  maintaining the gangway was the proximate cause of "
     "the injury. Damages were properly awarded by the jury."),
    ("Roe v. Harbor Freight", "91 F.2d 77 (9th Cir. 1983)", COURTS[2], dt.date(1983, 1, 20),
     "A contract for the sale of goods requires consideration. The "
     "agreement here lacked acceptance, so no contract was formed and "
     "the claim for breach fails. Short."),
]
TINY = dict(vocab_size=8192, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)

QUERIES = [
    ("brown v. board of education", None, None, None),
    ("384 U.S. 436 (1966)", None, None, None),
    ("right to remain silent", None, None, None),
    ("separate educational facilities are inherently unequal", None, None, 0.0),
    ("contract breach damages", [COURTS[1], COURTS[2]], None, 0.0),
    ("fourth amendment search and seizure", None, (dt.date(1960, 1, 1), dt.date(1968, 1, 1)), 0.0),
    ("duty of care negligence", None, (None, dt.date(1982, 1, 1)), -1.0),
    ("the court", [COURTS[0]], (dt.date(1950, 1, 1), None), 0.0),
    ("miranda v. arizona", ["No Such Court"], None, None),
    ("counsel for indigent defendants", None, None, 0.2),
]


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Storage, artifacts and a TOML config written by the JAX package."""
    root = tmp_path_factory.mktemp("engine")
    cfg = JaxConfig()
    cfg.storage.db_path = str(root / "db.sqlite")
    cfg.trie.index_path = str(root / "trie")
    cfg.vector.hnsw.index_path = str(root / "vec")
    cfg.vector.hnsw.num_partitions = 4
    cfg.vector.hnsw.num_probes = 2
    cfg.vector.dimension = 64
    # the tiny encoder has 64 positions (the JAX gather clamps past them)
    cfg.vector.model.max_sequence_length = 64
    storage = JaxStorage(cfg.storage)
    for i, (name, cit, court, date, text) in enumerate(CASES):
        meta = JaxCaseMetadata(
            id=uuid.UUID(int=i + 1), name=name, citation=cit, court=court,
            decision_date=date, word_count=len(text.split()),
        )
        storage.store_case_metadata(meta)
        storage.store_case_text(meta.id, text)
    vocab = train_wordpiece_vocab([c[4] for c in CASES], vocab_size=8192, min_frequency=1)
    emb = JaxEmbedder(cfg.vector.model, tokenizer=JaxTokenizer(vocab),
                      model_config=JaxMiniLMConfig(**TINY))
    built = build_indexes(storage, cfg, embedder=emb)
    cfg.vector.quality_gate = "off"
    save_artifacts(built, cfg)
    cfg.save_to_file(root / "config.toml")
    storage.close()
    return dict(root=root, toml=root / "config.toml")


@pytest.fixture()
def kernels_interpret(monkeypatch):
    """The JAX package's kernel branches on the CPU, in interpret mode."""
    jax.clear_caches()
    monkeypatch.setattr(jax_hybrid, "_use_pallas", lambda n, rt: rt < 1.0 and n % 2048 == 0)
    monkeypatch.setattr(
        jax_hybrid, "pallas_fused_topk", functools.partial(pallas_fused_topk, interpret=True)
    )
    monkeypatch.setenv("TSS_PROBE_INTERPRET", "1")
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _engines(art, **search):
    jcfg = JaxConfig.from_file(art["toml"])
    pcfg = Config.from_file(art["toml"])
    for k, v in search.items():
        setattr(jcfg.search, k, v)
        setattr(pcfg.search, k, v)
    jeng = JaxEngine(jcfg, JaxStorage(jcfg.storage), *jax_load_artifacts(jcfg))
    peng = SearchEngine(pcfg, StorageManager(pcfg.storage),
                        *load_artifacts(pcfg, device="cpu"), device="cpu")
    return jeng, peng


def _share_embeddings(jeng, peng, texts):
    for t, e in zip(texts, jeng.vector_index.generate_embeddings(texts)):
        peng.vector_index.cache.put(t, e)


def _requests(query_cls, config_cls):
    out = []
    for text, courts, dates, min_sim in QUERIES:
        cfg = config_cls() if min_sim is None else config_cls(min_similarity=min_sim)
        out.append(query_cls(query=text, court_filter=courts, date_range=dates, config=cfg))
    return out


def _assert_same(got, want, bitwise):
    assert len(got) == len(want)
    served = 0
    for g, w in zip(got, want):
        assert [str(r.case_metadata.id) for r in g] == [str(r.case_metadata.id) for r in w]
        assert [r.match_type.value for r in g] == [r.match_type.value for r in w]
        assert [r.snippet for r in g] == [r.snippet for r in w]
        assert [[(h.start, h.end, h.highlight_type.value) for h in r.highlights] for r in g] == \
            [[(h.start, h.end, h.highlight_type.value) for h in r.highlights] for r in w]
        gs = np.array([r.score for r in g], np.float32)
        ws = np.array([r.score for r in w], np.float32)
        if bitwise:
            np.testing.assert_array_equal(gs.view(np.int32), ws.view(np.int32))
        else:
            np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
        assert [r.to_json()["case_metadata"] for r in g] == [r.to_json()["case_metadata"] for r in w]
        served += len(g)
    assert served > 0


@pytest.mark.parametrize("mode,fused", [
    ("brute", True), ("partitioned", True), ("auto", False),
])
def test_engine_matches_jax(art, mode, fused, kernels_interpret):
    """Fused brute, fused partitioned and the staged path, with and without
    court and date filters: identical hydrated results."""
    jeng, peng = _engines(art, fused_ann_mode=mode, use_fused_device_path=fused,
                          enable_query_cache=False)
    _share_embeddings(jeng, peng, [q[0] for q in QUERIES])
    want = jeng.search_batch(_requests(JaxQuery, JaxSearchConfig))
    got = peng.search_batch(_requests(SearchQuery, SearchConfig))
    _assert_same(got, want, bitwise=mode == "brute")
    if mode == "partitioned":  # a batch of 1 probes (a padded 16 streams)
        for jq, pq in list(zip(_requests(JaxQuery, JaxSearchConfig),
                               _requests(SearchQuery, SearchConfig)))[2:6]:
            assert peng._get_fused()._layout_brute_batch(1) is False
            _assert_same(peng.search_batch([pq]), jeng.search_batch([jq]), bitwise=False)
    assert got[0][0].match_type == MatchType.CASE_NAME and got[0][0].score == 2.0
    assert got[1][0].match_type == MatchType.CITATION
    assert got[8] == []  # no such court
    for r in got[4]:
        assert r.case_metadata.court in (COURTS[1], COURTS[2])
    for r in got[5]:
        assert dt.date(1960, 1, 1) <= r.case_metadata.decision_date <= dt.date(1968, 1, 1)


@pytest.mark.parametrize("use_brute", [True, False])
def test_staged_semantic_side_matches_jax(art, use_brute, kernels_interpret):
    """The staged path with the prefix side off serves from the vector
    index's own search (exact scan or probe) on both sides."""
    jeng, peng = _engines(art, enable_query_cache=False)
    _share_embeddings(jeng, peng, [q[0] for q in QUERIES])
    cfg = dict(enable_prefix=False, min_similarity=-1.0)
    jq = [JaxQuery(query=q[0], config=JaxSearchConfig(**cfg)) for q in QUERIES[:6]]
    pq = [SearchQuery(query=q[0], config=SearchConfig(**cfg)) for q in QUERIES[:6]]
    orig_j, orig_p = jeng.vector_index.search_embedded, peng.vector_index.search_embedded
    jeng.vector_index.search_embedded = lambda v, k, b=None: orig_j(v, k, use_brute)
    peng.vector_index.search_embedded = lambda v, k, b=None: orig_p(v, k, use_brute)
    _assert_same(peng.search_batch(pq), jeng.search_batch(jq), bitwise=False)


def test_validation_cache_stats_and_swap(art):
    _, peng = _engines(art)
    for bad in ("a", "x" * 2000):
        with pytest.raises(InvalidSearchQuery):
            peng.search(bad)
    qs = _requests(SearchQuery, SearchConfig)[:4]
    first = peng.search_batch(qs)
    hits = peng.query_cache.get_stats().hits
    calls = []
    orig = peng._execute_batch
    peng._execute_batch = lambda q: calls.append(len(q)) or orig(q)
    second = peng.search_batch(qs)
    assert calls == [] and peng.query_cache.get_stats().hits == hits + 4
    assert [[r.to_json() for r in b] for b in second] == [[r.to_json() for r in b] for b in first]
    peng.search_batch([SearchQuery(query="right to remain silent"),
                       SearchQuery(query="a query never seen before")])
    assert calls == [1]
    peng._execute_batch = orig
    st = peng.get_stats()
    assert st.total_cases_indexed == len(CASES)
    assert st.queries_served == 10
    assert st.trie_stats["name"]["postings"] >= len(CASES)
    assert st.vector_index_stats.total_documents == st.vector_index_stats.ann.num_vectors
    assert st.cache_stats.size == 5
    peng.health_check()
    peng.swap_indexes(trie_index=peng.trie_index)
    assert peng.query_cache.get_stats().size == 0 and len(peng._meta_cache) == 0
    assert not peng.is_warm and peng._fused is None


def test_stats_match_jax(art):
    jeng, peng = _engines(art)
    jeng.search("miranda v. arizona")
    peng.search("miranda v. arizona")
    js, ps = jeng.get_stats(), peng.get_stats()
    assert ps.trie_stats == js.trie_stats
    assert (ps.total_cases_indexed, ps.queries_served) == (js.total_cases_indexed, js.queries_served)
    jv, pv = js.vector_index_stats, ps.vector_index_stats
    assert (pv.total_documents, pv.dimension) == (jv.total_documents, jv.dimension)
    assert (pv.ann.num_vectors, pv.ann.num_partitions, pv.ann.partition_capacity) == (
        jv.ann.num_vectors, jv.ann.num_partitions, jv.ann.partition_capacity)


def test_warmup_sets_is_warm(art):
    _, peng = _engines(art, fused_ann_mode="partitioned", fused_flat_escalate_eps=0.05)
    peng.warmup(batch_sizes=(1, 8))
    assert peng.is_warm
    assert peng.query_cache.get_stats().size == 0  # warmup bypasses the cache


def test_loaded_encoder_matches_jax(art):
    """``load_artifacts`` restores the saved encoder: the port embeds the
    same vectors as the JAX package's restored encoder."""
    jcfg = JaxConfig.from_file(art["toml"])
    _, jvec, _ = jax_load_artifacts(jcfg)
    _, pvec, _ = load_artifacts(Config.from_file(art["toml"]), device="cpu")
    texts = ["right to remain silent", "contract breach damages"]
    np.testing.assert_allclose(
        pvec.embedder.embed([*texts]).embedding, jvec.embedder.embed(texts).embedding,
        atol=2e-2, rtol=0,
    )
    a, b = pvec.embedder.embed_one(texts[0]), pvec.embedder.embed(texts).embedding[0]
    np.testing.assert_array_equal(a, b)


def test_missing_encoder_checkpoint_raises(art, tmp_path):
    cfg = Config.from_file(art["toml"])
    vec = tmp_path / "vec"
    shutil.copytree(cfg.vector.hnsw.index_path, vec)
    shutil.rmtree(vec / "encoder")
    cfg.vector.hnsw.index_path = str(vec)
    with pytest.raises(IndexCorrupted):
        load_artifacts(cfg, device="cpu")
    cfg.trie.index_path = str(tmp_path / "nowhere")
    assert load_artifacts(cfg, device="cpu") is None


def test_checkpoint_shape_mismatch_raises(art):
    from trie_semantic_search_tpu_torch.models.checkpoint import restore_checkpoint
    from trie_semantic_search_tpu_torch.models.minilm import MiniLMConfig

    enc = Path(Config.from_file(art["toml"]).vector.hnsw.index_path) / "encoder"
    state, meta = restore_checkpoint(enc, MiniLMConfig(**TINY))
    assert meta["hidden_size"] == 64 and state["layers.q_kernel"].shape == (2, 64, 64)
    with pytest.raises(IndexCorrupted):
        restore_checkpoint(enc, dataclasses.replace(MiniLMConfig(**TINY), intermediate_size=96))
