"""The port's build-time quality gate against the JAX package's, on the CPU.

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
from trie_semantic_search_tpu.models import quality as jq
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from trie_semantic_search_tpu.models.tokenizer import train_wordpiece_vocab
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu.text.processor import TextProcessor as JaxTextProcessor
from trie_semantic_search_tpu_torch.core.config import Config
from trie_semantic_search_tpu_torch.core.types import CaseMetadata
from trie_semantic_search_tpu_torch.index import quality_gate as tgate
from trie_semantic_search_tpu_torch.index.builder import build_indexes, save_artifacts
from trie_semantic_search_tpu_torch.models import minilm as tm
from trie_semantic_search_tpu_torch.models import quality as tq
from trie_semantic_search_tpu_torch.models.embedder import Embedder
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer
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
