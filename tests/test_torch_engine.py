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
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_engine_fixtures import (  # noqa: F401  (fixtures)
    CASES,
    COURTS,
    TINY,
    art,
    engines,
    kernels_interpret,
    share_embeddings,
)

from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu.core.types import SearchConfig as JaxSearchConfig
from trie_semantic_search_tpu.index.builder import load_artifacts as jax_load_artifacts
from trie_semantic_search_tpu.search.engine import SearchQuery as JaxQuery
from trie_semantic_search_tpu_torch.core.config import Config
from trie_semantic_search_tpu_torch.core.errors import IndexCorrupted, InvalidSearchQuery
from trie_semantic_search_tpu_torch.core.metrics import metrics
from trie_semantic_search_tpu_torch.core.types import SearchConfig
from trie_semantic_search_tpu_torch.index.builder import load_artifacts
from trie_semantic_search_tpu_torch.search.engine import MatchType, SearchQuery

torch.set_num_threads(1)

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
    jeng, peng = engines(art, fused_ann_mode=mode, use_fused_device_path=fused,
                          enable_query_cache=False)
    share_embeddings(jeng, peng, [q[0] for q in QUERIES])
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


#: name, citation and phrase queries whose terms hit the fixture's texts:
#: mixed case, punctuation that does (``self-incrimination``) and does not
#: (``people,`` before a space) end on a word boundary, repeated terms
SNIPPET_QUERIES = [
    "Smith v. Jones Lumber Co.",
    "347 U.S. 483 (1954)",
    "NEGLIGENCE in maintaining the Gangway",
    "The Fourth Amendment protects people, not places",
    "self-incrimination privilege Self-Incrimination",
    "separate but equal doctrine in public education",
    "counsel for the indigent defendant",
    "contract breach contract damages",
]


@pytest.mark.parametrize("mode", ["brute", "partitioned"])
def test_engine_snippets_match_jax(art, mode, kernels_interpret):
    """The fused path's snippets and highlights for queries whose terms
    hit the texts: identical to the JAX engine's, matched without a regex
    (the fixture's texts are ASCII)."""
    jeng, peng = engines(art, fused_ann_mode=mode, use_fused_device_path=True,
                          enable_query_cache=False)
    share_embeddings(jeng, peng, SNIPPET_QUERIES)
    cfg = dict(min_similarity=0.0)
    want = jeng.search_batch([JaxQuery(query=q, config=JaxSearchConfig(**cfg)) for q in SNIPPET_QUERIES])
    before = metrics.snapshot()["counters"]
    got = peng.search_batch([SearchQuery(query=q, config=SearchConfig(**cfg)) for q in SNIPPET_QUERIES])
    after = metrics.snapshot()["counters"]
    _assert_same(got, want, bitwise=mode == "brute")
    served = sum(len(r) for r in got)
    assert after.get("snippet.terms_fast", 0) - before.get("snippet.terms_fast", 0) == served
    assert after.get("snippet.terms_regex", 0) == before.get("snippet.terms_regex", 0)
    lit = {r.snippet[h.start:h.end].lower() for g in got for r in g for h in r.highlights}
    assert {"lumber", "negligence", "gangway", "self-incrimination", "counsel", "contract"} <= lit
    assert "people," not in lit


@pytest.mark.parametrize("use_brute", [True, False])
def test_staged_semantic_side_matches_jax(art, use_brute, kernels_interpret):
    """The staged path with the prefix side off serves from the vector
    index's own search (exact scan or probe) on both sides."""
    jeng, peng = engines(art, enable_query_cache=False)
    share_embeddings(jeng, peng, [q[0] for q in QUERIES])
    cfg = dict(enable_prefix=False, min_similarity=-1.0)
    jq = [JaxQuery(query=q[0], config=JaxSearchConfig(**cfg)) for q in QUERIES[:6]]
    pq = [SearchQuery(query=q[0], config=SearchConfig(**cfg)) for q in QUERIES[:6]]
    orig_j, orig_p = jeng.vector_index.search_embedded, peng.vector_index.search_embedded
    jeng.vector_index.search_embedded = lambda v, k, b=None: orig_j(v, k, use_brute)
    peng.vector_index.search_embedded = lambda v, k, b=None: orig_p(v, k, use_brute)
    _assert_same(peng.search_batch(pq), jeng.search_batch(jq), bitwise=False)


def test_validation_cache_stats_and_swap(art):
    _, peng = engines(art)
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
    jeng, peng = engines(art)
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
    _, peng = engines(art, fused_ann_mode="partitioned", fused_flat_escalate_eps=0.05)
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
