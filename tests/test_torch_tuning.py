"""The port's case-level nprobe tuner (``index/tuning.py``) and
``build_indexes(tune_recall=...)`` against the JAX package's, on the CPU.

The oracle is numpy in both packages, so its lists, k-th scores, tie sets
and above sets must be bitwise equal. The tuners sweep the same index: the
JAX package builds it (``save_dir``) and the port loads it (``load_dir``),
so both search the same layout; each sweep step's recall is read from the
tuners' own log records.
"""

import datetime as dt
import functools
import logging
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trie_semantic_search_tpu.index.tuning as jt
import trie_semantic_search_tpu.models.minilm as jm
import trie_semantic_search_tpu_torch.index.tuning as pt
import trie_semantic_search_tpu_torch.models.minilm as tm
from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu.core.types import CaseMetadata as JaxCaseMetadata
from trie_semantic_search_tpu.index.ann import AnnConfig as JaxAnnConfig
from trie_semantic_search_tpu.index.ann import PartitionedANN as JaxANN
from trie_semantic_search_tpu.index.builder import build_indexes as jax_build_indexes
from trie_semantic_search_tpu.index.builder import save_artifacts as jax_save_artifacts
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from trie_semantic_search_tpu.models.tokenizer import train_wordpiece_vocab
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu_torch.core.config import AnnConfig, Config
from trie_semantic_search_tpu_torch.core.types import CaseMetadata
from trie_semantic_search_tpu_torch.index.ann import PartitionedANN
from trie_semantic_search_tpu_torch.index.builder import build_indexes, save_artifacts
from trie_semantic_search_tpu_torch.models.embedder import Embedder
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer
from trie_semantic_search_tpu_torch.storage.store import StorageManager

from torch_trie_backend import BACKENDS, force_trie_backend

torch.set_num_threads(1)

JAX_LOG, PORT_LOG = "tss_tpu.index.tuning", "tss_torch.index.tuning"
#: per-step recall values may differ by no more than this between packages
STEP_TOL = 1e-6


def _normed(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


@pytest.fixture(scope="module")
def duplicate_corpus():
    """The JAX tuning tests' corpus: 8 topic groups of 32 cases × 16
    chunks, D=32, jittered 5e-2 around each topic."""
    rng = np.random.default_rng(0)
    T, cases_per_topic, chunks_per_case, D = 8, 32, 16, 32
    topics = _normed(rng.standard_normal((T, D)).astype(np.float32))
    rows, case_of = [], []
    case = 0
    for t in range(T):
        for _ in range(cases_per_topic):
            for _ in range(chunks_per_case):
                rows.append(_normed(topics[t] + 5e-2 * rng.standard_normal(D).astype(np.float32)))
                case_of.append(case)
            case += 1
    return np.asarray(rows, np.float32), np.asarray(case_of, np.int64), topics


@pytest.fixture(scope="module")
def ann_pair(duplicate_corpus, tmp_path_factory):
    """The JAX package's ANN over the corpus (P=64, rescore factor 4, seed
    0) and the port's load of its ``save_dir`` artifact."""
    corpus, _, _ = duplicate_corpus
    jann = JaxANN(JaxAnnConfig(num_partitions=64, rescore_factor=4))
    jann.build(corpus, seed=0)
    path = tmp_path_factory.mktemp("tuning") / "ann.mmap"
    jann.save_dir(path)
    pann = PartitionedANN.load_dir(path, AnnConfig(num_partitions=64, rescore_factor=4), device="cpu")
    return jann, pann


def _mixtures(topics, n, seed):
    """Query-shaped probes: mixtures of a topic and its neighbour."""
    rng = np.random.default_rng(seed)
    w = rng.random((n, 1)).astype(np.float32) * 0.3
    ti = rng.integers(0, len(topics), n)
    return _normed((1 - w) * topics[ti] + w * topics[(ti + 1) % len(topics)])


def _oracle_corpora():
    """(corpus, chunk → case, queries) of the oracle cases."""
    rng = np.random.default_rng(3)
    topics = _normed(rng.standard_normal((2, 16)).astype(np.float32))
    ties = (np.repeat(topics, 80, axis=0), np.arange(160) // 4, topics)
    rng = np.random.default_rng(7)
    topic = _normed(rng.standard_normal((1, 16)).astype(np.float32))
    nudged = np.repeat(topic, 80, axis=0).astype(np.float32)
    nudged[76:80] = _normed(topic + np.float32(1e-2) * rng.standard_normal(16).astype(np.float32))
    rng = np.random.default_rng(9)
    topic9 = _normed(rng.standard_normal((1, 16)).astype(np.float32))
    near = _normed(topic9 + np.float32(0.05) * rng.standard_normal(16).astype(np.float32))
    above = np.concatenate([np.repeat(topic9, 4, axis=0), np.repeat(near, 80, axis=0)])
    rng = np.random.default_rng(21)
    corpus = rng.standard_normal((700, 24)).astype(np.float32)
    shuffled = rng.permutation(np.arange(700) // 3)  # chunk → case not monotone
    qs = rng.standard_normal((6, 24)).astype(np.float32)
    return {
        "exact_ties": ties,
        "one_case_nudged": (nudged, np.arange(80) // 4, topic),
        "one_strictly_above": (above.astype(np.float32), np.arange(84) // 4, topic9),
        "random_monotone": (corpus, np.arange(700) // 3, qs),
        "random_shuffled": (corpus, shuffled, qs),
    }


@pytest.mark.parametrize("name", ["exact_ties", "one_case_nudged", "one_strictly_above",
                                  "random_monotone", "random_shuffled"])
@pytest.mark.parametrize("slab", [262_144, 50])
def test_case_level_oracle_bitwise(name, slab):
    corpus, case_of, queries = _oracle_corpora()[name]
    kw = dict(k=10, slab=slab, return_scores=True, return_tie_sets=True, return_above_sets=True)
    want = jt.case_level_oracle(corpus, case_of, queries, **kw)
    got = pt.case_level_oracle(corpus, case_of, queries, **kw)
    assert got[0] == want[0]
    np.testing.assert_array_equal(np.asarray(got[1], np.float32).view(np.int32),
                                  np.asarray(want[1], np.float32).view(np.int32))
    assert got[2] == want[2] and got[3] == want[3]
    assert pt.case_level_oracle(corpus, case_of, queries, k=10, slab=slab) == want[0]


def test_case_level_oracle_duplicate_corpus_bitwise(duplicate_corpus):
    corpus, case_of, topics = duplicate_corpus
    q = _mixtures(topics, 24, 1)
    kw = dict(k=10, return_scores=True, return_tie_sets=True, return_above_sets=True)
    want, got = jt.case_level_oracle(corpus, case_of, q, **kw), pt.case_level_oracle(corpus, case_of, q, **kw)
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
    assert np.asarray(got[1], np.float32).tobytes() == np.asarray(want[1], np.float32).tobytes()


@pytest.mark.parametrize("served,oracle,tie,above", [
    ({0, 1, 2}, {0, 1, 2}, frozenset({0, 1, 2}), frozenset({0, 1})),  # exact
    (set(range(10, 20)), set(range(10)), frozenset(range(20)), frozenset()),  # pure tie swap
    (set(range(11, 21)), set(range(10)), frozenset(range(21)), frozenset({0})),  # drops the best
    ({0, 5, 99}, {0, 1, 2}, frozenset({0, 1, 2, 5}), frozenset({0, 1})),  # a boundary swap, a miss
    (set(), {0, 1}, frozenset({0, 1}), frozenset({0})),  # nothing served
    ({3}, set(), frozenset(), frozenset()),  # an empty oracle
])
def test_tie_aware_recall_matches_jax(served, oracle, tie, above):
    assert pt.tie_aware_recall(served, oracle, tie, above) == jt.tie_aware_recall(
        served, oracle, tie, above)


def _steps(caplog, logger):
    """(nprobe, mean, min, tie-aware min) of each sweep step logged."""
    return [tuple(r.args[1:5]) for r in caplog.records
            if r.name == logger and r.msg.startswith("case recall@")]


def _same_sweep(caplog, jax_pick, port_pick):
    js, ps = _steps(caplog, JAX_LOG), _steps(caplog, PORT_LOG)
    assert port_pick == jax_pick
    assert [s[0] for s in ps] == [s[0] for s in js] and js
    np.testing.assert_allclose(np.asarray(ps, np.float64), np.asarray(js, np.float64),
                               atol=STEP_TOL, rtol=0)
    warn = lambda n: [r.getMessage() for r in caplog.records if r.name == n and r.levelno >= logging.WARNING]  # noqa: E731
    assert warn(PORT_LOG) == warn(JAX_LOG)


#: (query seed, probes, random queries, tuner keywords): the JAX tuning
#: tests' scenarios on the real index
SCENARIOS = {
    "target_met": (1, 24, False, dict(target_recall=0.9)),
    "cap": (2, 8, True, dict(target_recall=1.0, max_nprobe=16)),
    "floor_tightens": (4, 24, False, dict(target_recall=0.9, min_recall=0.8)),
    "floor_unreachable": (5, 8, True, dict(target_recall=0.5, min_recall=1.0, max_nprobe=16)),
    "defaults": (6, 16, False, dict(target_recall=0.95, min_recall=0.95)),
    "strict_floor": (4, 24, False, dict(target_recall=0.9, min_recall=0.8, tie_exact_floor=False)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tuner_matches_jax(name, duplicate_corpus, ann_pair, caplog):
    corpus, case_of, topics = duplicate_corpus
    jann, pann = ann_pair
    seed, n, rand, kw = SCENARIOS[name]
    q = (_normed(np.random.default_rng(seed).standard_normal((n, corpus.shape[1])))
         if rand else _mixtures(topics, n, seed))
    with caplog.at_level(logging.INFO):
        want = jt.tune_nprobe_case_recall(jann, case_of, corpus, q, k=10, **kw)
        got = pt.tune_nprobe_case_recall(pann, case_of, corpus, q, k=10, **kw)
    _same_sweep(caplog, want, got)
    assert pann.tuned_nprobe == got and pann.config.num_probes == 0
    routes = [r.args[5] for r in caplog.records if r.name == PORT_LOG and r.msg.startswith("case recall@")]
    assert set(routes) == {"einsum"}  # D=32 is off the probe kernel's shape rule
    pann.tuned_nprobe = jann.tuned_nprobe = 0


def _plateau(monkeypatch, mod):
    oracle_sets = [list(range(q * 100, q * 100 + 10)) for q in range(4)]
    monkeypatch.setattr(mod, "case_level_oracle", lambda vectors, chunk_case, embs, k,
                        return_tie_sets=False, return_above_sets=False: (
                            oracle_sets, [frozenset(o) for o in oracle_sets],
                            [frozenset(o) for o in oracle_sets]))
    monkeypatch.setattr(mod, "_served_cases", lambda ann_, cc, e, k_, nprobe: [
        o[:6 if q == 0 else (9 if nprobe >= 2 else 5)] for q, o in enumerate(oracle_sets)])
    return dict(target_recall=0.8, min_recall=0.95, max_nprobe=16)


def _tie_swap(monkeypatch, mod):
    monkeypatch.setattr(mod, "_served_cases", lambda *a: [list(range(10, 20))])
    return dict(target_recall=0.0, min_recall=1.0, max_nprobe=4)


def _off_topic(monkeypatch, mod):
    monkeypatch.setattr(mod, "_served_cases", lambda *a: [list(range(11, 20)) + [25]])
    return dict(target_recall=0.0, min_recall=1.0, max_nprobe=4)


@pytest.mark.parametrize("patch", [_plateau, _tie_swap, _off_topic], ids=lambda f: f.__name__)
def test_tuner_settling_matches_jax(patch, monkeypatch, caplog, tmp_path):
    """The JAX tests' scenarios with a fixed served list: the plateau
    settles on the mean target, a pure tie swap passes the floor, an
    off-topic case does not."""
    rng = np.random.default_rng(8)
    topics = _normed(rng.standard_normal((2, 16)).astype(np.float32))
    corpus, case_of = np.repeat(topics, 80, axis=0).astype(np.float32), np.arange(160) // 4
    jann = JaxANN(JaxAnnConfig(num_partitions=8, rescore_factor=4))
    jann.build(corpus, seed=0)
    jann.save_dir(tmp_path / "ann.mmap")
    pann = PartitionedANN.load_dir(tmp_path / "ann.mmap", AnnConfig(num_partitions=8, rescore_factor=4),
                                   device="cpu")
    kw = patch(monkeypatch, jt)
    patch(monkeypatch, pt)
    q = topics[:1] if patch is not _plateau else np.repeat(topics, 2, axis=0)
    with caplog.at_level(logging.INFO):
        want = jt.tune_nprobe_case_recall(jann, case_of, corpus, q, k=10, **kw)
        got = pt.tune_nprobe_case_recall(pann, case_of, corpus, q, k=10, **kw)
    _same_sweep(caplog, want, got)


def test_served_cases_matches_jax(duplicate_corpus, ann_pair):
    corpus, case_of, topics = duplicate_corpus
    jann, pann = ann_pair
    q = _mixtures(topics, 12, 11)
    for nprobe in (1, 3, 8):
        assert pt._served_cases(pann, case_of, q, 10, nprobe) == jt._served_cases(
            jann, case_of, q, 10, nprobe)


def test_search_route(ann_pair, monkeypatch):
    """The routes ``search`` takes: brute past ``nprobe * m >= N`` or
    ``nprobe >= P``; the kernels when the shape rule holds and B × nprobe
    fits the probe kernel's budget; else the einsum loop."""
    _, pann = ann_pair
    P, m = (int(s) for s in pann.part_rows.shape)
    assert pann.search_route(4, 2) == "einsum"  # D=32
    assert pann.search_route(4, P) == "brute"
    assert pann.search_route(4, -(-pann.num_vectors // m)) == "brute"
    monkeypatch.setenv("TSS_PROBE_INTERPRET", "1")
    if m % 128 == 0:
        assert pann.search_route(4, 2) == "kernel"
        assert pann.search_route(768 * 1024 // 8 + 1, 2) == "einsum"


# -- build_indexes(tune_recall=...) ------------------------------------------------------


D = 32
TINY = dict(vocab_size=512, hidden_size=D, num_layers=1, num_heads=2, intermediate_size=64,
            max_position=64)
COURTS = ["Supreme Court", "Ninth Circuit", "Tax Court"]
TOPICS = [
    "contract breach damages seller buyer delivery goods price market",
    "search seizure warrant officer privacy home evidence fourth amendment",
    "counsel indigent defendant trial lawyer right criminal fair hearing",
    "negligence duty care vessel passenger injury proximate cause jury",
]


def _tuning_cases(long_sentences: bool):
    """Cases on four topics; with ``long_sentences`` the sentences are long
    enough for query-shaped probes (8 words), else none is."""
    rng = np.random.default_rng(31)
    out = []
    for i in range(40):
        words = TOPICS[i % 4].split()
        n = 9 if long_sentences else 3
        sents = [" ".join(rng.choice(words, n)).capitalize() + f" in matter {i}." for _ in range(4)]
        out.append((f"Case {i} v. Party {i % 7}", f"{i} U.S. {100 + i} (1970)", COURTS[i % 3],
                    dt.date(1950, 1, 1) + dt.timedelta(days=97 * i), " ".join(sents)))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("long_sentences", [True, False], ids=["case_level", "row_level"])
def test_build_indexes_tune_recall_matches_jax(tmp_path, monkeypatch, caplog, long_sentences, backend):
    """The same store and encoder parameters through both builders with
    ``tune_recall=0.9``: the same tuned nprobe and the same saved
    ``num_probes`` (the case-level tuner with probes; the row-level
    ``tune_nprobe`` on 64 sampled rows without)."""
    monkeypatch.setattr(jm, "encode", functools.partial(jm.encode, compute_dtype=jnp.float32))
    force_trie_backend(monkeypatch, backend)
    cases = _tuning_cases(long_sentences)
    cfgs = []
    for tag, cls in (("jax", JaxConfig), ("port", Config)):
        c = cls()
        c.storage.db_path = str(tmp_path / f"{tag}.sqlite")
        c.trie.index_path = str(tmp_path / tag / "trie")
        c.vector.hnsw.index_path = str(tmp_path / tag / "vec")
        c.vector.hnsw.num_partitions = 8
        c.vector.dimension = D
        c.vector.model.max_sequence_length = 64
        c.vector.pooling = "mean"
        c.vector.quality_gate = "off"
        cfgs.append(c)
    jcfg, pcfg = cfgs
    stores = []
    for store_cls, meta_cls, cfg in ((JaxStorage, JaxCaseMetadata, jcfg),
                                     (StorageManager, CaseMetadata, pcfg)):
        store = store_cls(cfg.storage)
        for i, (name, cit, court, date, text) in enumerate(cases):
            store.store_case_metadata(meta_cls(id=uuid.UUID(int=i + 1), name=name, citation=cit,
                                               court=court, decision_date=date))
            store.store_case_text(uuid.UUID(int=i + 1), text)
        stores.append(store)
    vocab = train_wordpiece_vocab([c[4] for c in cases], vocab_size=512, min_frequency=1)
    mcfg = jm.MiniLMConfig(**TINY)
    params = jm.init_params(jax.random.PRNGKey(5), mcfg)
    model = tm.MiniLM(tm.MiniLMConfig(**TINY), device="cpu").load_params(
        tm.params_from_jax(jax.tree.map(np.asarray, params)))
    model.compute_dtype = torch.float32
    with caplog.at_level(logging.INFO):
        jb = jax_build_indexes(stores[0], jcfg, tune_recall=0.9, embedder=JaxEmbedder(
            jcfg.vector.model, tokenizer=JaxTokenizer(vocab), params=params, model_config=mcfg))
        pb = build_indexes(stores[1], pcfg, tune_recall=0.9, device="cpu", embedder=Embedder(
            pcfg.vector.model, tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu"))
    assert pb.vector.ann.num_vectors == jb.vector.ann.num_vectors >= 100
    assert pb.vector.ann.tuned_nprobe == jb.vector.ann.tuned_nprobe > 0
    assert pb.report.tune_seconds >= pb.report.tune_probe_seconds > 0
    tuned = [r.getMessage() for r in caplog.records if r.getMessage().startswith("tuned nprobe=")]
    assert len(tuned) == 2 and tuned[0] == tuned[1]
    assert ("for case recall" in tuned[0]) == long_sentences
    if long_sentences:
        _same_sweep(caplog, jb.vector.ann.tuned_nprobe, pb.vector.ann.tuned_nprobe)
    jax_save_artifacts(jb, jcfg)
    save_artifacts(pb, pcfg)
    saved = [PartitionedANN.load(tmp_path / t / "vec" / "ann.npz", device="cpu").tuned_nprobe
             for t in ("jax", "port")]
    assert saved[0] == saved[1] == jb.vector.ann.tuned_nprobe
    for s in stores:
        s.close()
