"""The port's build-time quality gate, pooling selection and retrieval
evaluation against the JAX package's, on the CPU.

Both packages read the same cases (each from its own store, written the
same way). The encoders are the same tiny MiniLM, the JAX parameters
carried across by ``params_from_jax``, both in f32 compute, so their
embeddings differ only in summation order (1e-5) and the probe ranks agree;
the gate's control encoder is injected the same way (the JAX package's
``PRNGKey(1234)`` init), since the port's default control draws other
weights (a stated divergence, ``index/quality_gate.py``).
"""

import dataclasses
import datetime as dt
import functools
import json
import shutil
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trie_semantic_search_tpu.models.minilm as jm
from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu.core.types import CaseMetadata as JaxCaseMetadata
from trie_semantic_search_tpu.index import quality_gate as jgate
from trie_semantic_search_tpu.index.builder import build_indexes as jax_build_indexes
from trie_semantic_search_tpu.index.builder import load_artifacts as jax_load_artifacts
from trie_semantic_search_tpu.index.builder import save_artifacts as jax_save_artifacts
from trie_semantic_search_tpu.models import train as jtrain
from trie_semantic_search_tpu.models import quality as jq
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from trie_semantic_search_tpu.models.tokenizer import train_wordpiece_vocab
from trie_semantic_search_tpu.search.engine import SearchEngine as JaxEngine
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu.text.processor import TextProcessor as JaxTextProcessor
from trie_semantic_search_tpu_torch.core.config import Config
from trie_semantic_search_tpu_torch.core.types import CaseMetadata
from trie_semantic_search_tpu_torch.index import quality_gate as tgate
from trie_semantic_search_tpu_torch.index.builder import build_indexes, load_artifacts, save_artifacts
from trie_semantic_search_tpu_torch.models import minilm as tm
from trie_semantic_search_tpu_torch.models import quality as tq
from trie_semantic_search_tpu_torch.models import train as ttrain
from trie_semantic_search_tpu_torch.models.embedder import Embedder, EmbeddingResult
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer
from trie_semantic_search_tpu_torch.search.engine import SearchEngine
from trie_semantic_search_tpu_torch.storage.store import StorageManager
from trie_semantic_search_tpu_torch.text.processor import TextProcessor

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=64)
WORDS = ("the attorney for the defendant argued that the court held the contract void "
         "because the evidence obtained by the officer was unlawful and the statute "
         "prohibited such a search of the vehicle without a reasonable warrant in "
         "this framework of principles the judgment was reversed and later affirmed").split()


def _cases(n=40, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sents = [" ".join(rng.choice(WORDS, int(rng.integers(6, 14)))).capitalize()
                 + f" in matter {i} part {j}." for j in range(int(rng.integers(2, 6)))]
        out.append((f"Case {i} v. State", f"{i} U.S. {100 + i} (1970)", " ".join(sents)))
    return out


def _store(cls, meta_cls, cfg, cases):
    store = cls(cfg.storage)
    for i, (name, cit, text) in enumerate(cases):
        meta = meta_cls(id=uuid.UUID(int=i + 1), name=name, citation=cit, court="Court A",
                        decision_date=dt.date(1960, 1, 1) + dt.timedelta(days=30 * i))
        store.store_case_metadata(meta)
        store.store_case_text(meta.id, text)
    return store


def _params(key, cfg):
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(key), cfg))


@pytest.fixture()
def setup(tmp_path, monkeypatch):
    """Both stores, both configs, the build encoder and the control in
    both packages (f32 compute)."""
    monkeypatch.setattr(jm, "encode", functools.partial(jm.encode, compute_dtype=jnp.float32))
    cases = _cases()
    jcfg, pcfg = JaxConfig(), Config()
    for c, tag in ((jcfg, "jax"), (pcfg, "port")):
        c.storage.db_path = str(tmp_path / f"{tag}.sqlite")
        c.trie.index_path = str(tmp_path / tag / "trie")
        c.vector.hnsw.index_path = str(tmp_path / tag / "vec")
        c.vector.hnsw.num_partitions = 4
        c.vector.dimension = TINY["hidden_size"]
        c.vector.model.max_sequence_length = 64
        c.vector.pooling = "mean"
    jstore = _store(JaxStorage, JaxCaseMetadata, jcfg, cases)
    pstore = _store(StorageManager, CaseMetadata, pcfg, cases)
    vocab = train_wordpiece_vocab([c[2] for c in cases], vocab_size=512, min_frequency=1)
    mcfg = jm.MiniLMConfig(**TINY)

    def pair(key):
        tree = _params(key, mcfg)
        jemb = JaxEmbedder(jcfg.vector.model, tokenizer=JaxTokenizer(vocab),
                           params=jax.tree.map(jnp.asarray, tree), model_config=mcfg)
        model = tm.MiniLM(tm.MiniLMConfig(**TINY), device="cpu").load_params(tm.params_from_jax(tree))
        model.compute_dtype = torch.float32
        return jemb, Embedder(pcfg.vector.model, tokenizer=WordPieceTokenizer(vocab), model=model,
                              device="cpu")

    (jemb, pemb), (jctl, pctl) = pair(3), pair(1234)
    yield dict(cases=cases, jcfg=jcfg, pcfg=pcfg, jstore=jstore, pstore=pstore,
               jemb=jemb, pemb=pemb, jctl=jctl, pctl=pctl)
    jstore.close()
    pstore.close()


def _docs(cases, tp):
    return [(row, tp.extract_sentences(tp.normalize_text(text)))
            for row, (_, _, text) in enumerate(cases)]


@pytest.mark.parametrize("seed,max_probes,min_tokens", [(0, 256, 8), (5, 17, 8), (1, 64, 12)])
def test_build_probes_identical(seed, max_probes, min_tokens):
    docs = _docs(_cases(), JaxTextProcessor())
    assert _docs(_cases(), TextProcessor()) == docs
    want = jq.build_probes(docs, max_probes=max_probes, seed=seed, min_tokens=min_tokens)
    got = tq.build_probes(docs, max_probes=max_probes, seed=seed, min_tokens=min_tokens)
    assert [dataclasses.astuple(p) for p in got] == [dataclasses.astuple(p) for p in want]
    assert {p.kind for p in got} == {"half", "paraphrase"} and len(got) <= max_probes


def test_evaluate_embedder_direct_matches_jax(setup):
    tp = JaxTextProcessor()
    docs = _docs(setup["cases"], tp)
    texts = [s for _, sents in docs for s in sents[:8]]
    rows = [r for r, sents in docs for _ in sents[:8]]
    probes = jq.build_probes(docs, max_probes=128)
    tprobes = [tq.Probe(p.query, p.target_case_row, p.kind) for p in probes]
    np.testing.assert_allclose(setup["pemb"].embed(texts).embedding,
                               setup["jemb"].embed(texts).embedding, atol=1e-5, rtol=0)
    for k in (10, 3):
        for j, t in (("jemb", "pemb"), ("jctl", "pctl")):
            want = jq.evaluate_embedder_direct(setup[j], texts, rows, probes, k=k)
            got = tq.evaluate_embedder_direct(setup[t], texts, rows, tprobes, k=k)
            assert got.keys() == want.keys() == {"all", "half", "paraphrase"}
            for kind in want:
                assert got[kind].keys() == want[kind].keys()
                for m, v in want[kind].items():
                    assert abs(got[kind][m] - v) <= 1e-5, (j, k, kind, m)


@pytest.mark.parametrize("mode,margin", [("warn", 0.8), ("warn", 100.0), ("refuse", 100.0),
                                         ("refuse", 0.0), ("off", 0.8)])
def test_quality_gate_matches_jax(setup, mode, margin):
    """The same probes, sample, metrics and verdict; ``refuse`` raises on
    a degraded encoder in both packages; ``off`` runs nothing."""
    for c in (setup["jcfg"], setup["pcfg"]):
        c.vector.quality_gate = mode
        c.vector.quality_gate_margin = margin
    run_j = functools.partial(jgate.run_quality_gate, setup["jstore"], setup["jcfg"], setup["jemb"],
                              control_factory=lambda: setup["jctl"])
    run_p = functools.partial(tgate.run_quality_gate, setup["pstore"], setup["pcfg"], setup["pemb"],
                              control_factory=lambda: setup["pctl"])
    if mode == "refuse" and margin > 1:
        with pytest.raises(jgate.QualityGateFailed) as je:
            run_j()
        with pytest.raises(tgate.QualityGateFailed) as te:
            run_p()
        assert str(te.value) == str(je.value)
        want, got = je.value.report, te.value.report
    else:
        want, got = run_j(), run_p()
        if mode == "off":
            assert want is None and got is None
            return
    w, g = dataclasses.asdict(want), dataclasses.asdict(got)
    w.pop("seconds"), g.pop("seconds")
    assert g["probes"] > 8 and g["sample_cases"] == len(setup["cases"])
    assert g == w
    assert got.degraded == (margin > 1)


def test_default_control_and_saved_report(setup):
    """Without a control factory the port's control is its seeded init of
    the build encoder's geometry (``CONTROL_SEED``); ``save_artifacts`` with
    the store runs the gate first and writes ``quality.json``, which the
    JAX package's ``load_quality_meta`` reads."""
    pcfg, pstore = setup["pcfg"], setup["pstore"]
    ctl = tgate._control_embedder(pcfg, setup["pemb"])
    seeded = tm.MiniLM(tm.MiniLMConfig(**TINY), device="cpu", seed=tgate.CONTROL_SEED).state_dict()
    for k, v in ctl.model.state_dict().items():
        torch.testing.assert_close(v, seeded[k], rtol=0, atol=0)
    assert ctl.tokenizer is setup["pemb"].tokenizer
    built = build_indexes(pstore, pcfg, embedder=setup["pemb"], device="cpu")
    save_artifacts(built, pcfg, storage=pstore)
    vec = pcfg.vector.hnsw.index_path
    meta = jgate.load_quality_meta(vec)
    assert meta == tgate.load_quality_meta(vec)
    assert meta["mode"] == "warn" and meta["probes"] > 8
    assert meta["trained"]["all"]["n"] == meta["probes"] == meta["control"]["all"]["n"]
    direct = tgate.run_quality_gate(pstore, pcfg, setup["pemb"])
    assert json.loads(json.dumps(direct.trained)) == meta["trained"]
    pcfg.vector.quality_gate = "refuse"
    pcfg.vector.quality_gate_margin = 100.0
    shutil.rmtree(vec)
    with pytest.raises(tgate.QualityGateFailed):
        save_artifacts(built, pcfg, storage=pstore)
    assert not Path(vec).exists()  # refused before anything was written


# -- pooling selection ---------------------------------------------------------------


@pytest.mark.parametrize("a", [0.1, 1e-3])
def test_token_counts_and_sif_weights_bitwise(setup, a):
    """``count_token_ids`` over the corpus sentences (and truncated at 16
    tokens) and ``sif_weights_from_counts`` from them, and from no counts
    at all, are bitwise the JAX package's."""
    sents = [s for _, sents in _docs(setup["cases"], TextProcessor()) for s in sents]
    tok = setup["pemb"].tokenizer
    for max_len in (512, 16):
        got = tm.count_token_ids(tok, iter(sents), vocab_size=len(tok), max_len=max_len)
        want = jm.count_token_ids(setup["jemb"].tokenizer, iter(sents), vocab_size=len(tok),
                                  max_len=max_len)
        assert got.dtype == want.dtype and got.sum() > 0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tm.sif_weights_from_counts(got, a=a),
                                      jm.sif_weights_from_counts(want, a=a))
    zero = np.zeros(7, np.int64)
    np.testing.assert_array_equal(tm.sif_weights_from_counts(zero), jm.sif_weights_from_counts(zero))


@pytest.mark.parametrize("force", [None, "sif", "mean"])
def test_select_pooling_guarded_matches_jax(setup, force):
    """The same pick and token weights, and MRRs within 1e-4, for the probe
    comparison and both forced modes."""
    docs = [sents for _, sents in _docs(setup["cases"], TextProcessor())]
    want = jtrain.select_pooling_guarded(setup["jemb"], docs, sif_a=0.1, force=force)
    got = ttrain.select_pooling_guarded(setup["pemb"], docs, sif_a=0.1, force=force)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith("_mrr"):
            assert abs(got[k] - v) <= 1e-4, k
        else:
            assert got[k] == v, k
    if force is None:
        assert got["probes"] >= 8
    jw, tw = setup["jemb"].token_weights, setup["pemb"].token_weights
    assert (jw is None) == (tw is None) == (got["pooling"] == "mean")
    if tw is not None:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_select_pooling_on_a_tiny_corpus_keeps_mean(setup):
    docs = [sents for _, sents in _docs(setup["cases"][:2], TextProcessor())]
    want = jtrain.select_pooling_guarded(setup["jemb"], docs)
    assert ttrain.select_pooling_guarded(setup["pemb"], docs) == want
    assert want["pooling"] == "mean" and setup["pemb"].token_weights is None


# -- evaluate_engine / evaluate_stages ---------------------------------------------------


@pytest.fixture()
def eval_engines(setup):
    """Engines of both packages over the artifacts the JAX package built
    and saved, the port's encoder handing over the JAX encoder's vectors
    (the same query embeddings), and the probes."""
    jcfg, pcfg = setup["jcfg"], setup["pcfg"]
    jcfg.vector.quality_gate = "off"
    jcfg.mesh.enabled = False
    built = jax_build_indexes(setup["jstore"], jcfg, embedder=setup["jemb"])
    built.vector.ann.tune_nprobe(np.asarray(built.vector.vectors)[::7], k=10, target_recall=0.9)
    jax_save_artifacts(built, jcfg)
    pcfg.trie.index_path, pcfg.vector.hnsw.index_path = jcfg.trie.index_path, jcfg.vector.hnsw.index_path
    pemb = setup["pemb"]
    pemb.embed = lambda texts: EmbeddingResult(
        np.asarray(setup["jemb"].embed(list(texts)).embedding, np.float32), 0.0)
    jeng = JaxEngine(jcfg, setup["jstore"], *jax_load_artifacts(jcfg, embedder=setup["jemb"]))
    peng = SearchEngine(pcfg, setup["pstore"], *load_artifacts(pcfg, embedder=pemb, device="cpu"),
                        device="cpu")
    docs = _docs(setup["cases"], TextProcessor())
    probes = jq.build_probes(docs, max_probes=96)
    return jeng, peng, probes, [tq.Probe(p.query, p.target_case_row, p.kind) for p in probes]


@pytest.mark.parametrize("k", [10, 5])
def test_evaluate_engine_and_stages_match_jax(eval_engines, k):
    """``evaluate_engine`` (batches of 32 and 7) and ``evaluate_stages``
    give the JAX package's dicts over the same artifacts and probes."""
    jeng, peng, jprobes, tprobes = eval_engines
    for batch in (32, 7):
        want = jq.evaluate_engine(jeng, jeng.columns, jprobes, k=k, batch=batch)
        got = tq.evaluate_engine(peng, peng.columns, tprobes, k=k, batch=batch)
        assert got == want and want["all"]["n"] == len(jprobes)
    want = jq.evaluate_stages(jeng, jeng.columns, jprobes, k=k)
    got = tq.evaluate_stages(peng, peng.columns, tprobes, k=k)
    assert got == want
    assert want["tuned_nprobe"] > 0 and "ann_only" in want

