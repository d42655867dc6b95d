"""Shared fixtures of the port's serving tests: a sqlite store and
artifacts that the JAX package built and saved, both packages' engines over
them, and the JAX package's kernel branches in Pallas interpret mode.

The port serves on the CPU. Its encoder agrees with the JAX encoder to a
bf16 tolerance (``tests/test_torch_engine.py::test_loaded_encoder_matches_jax``),
so the tests that compare results put the JAX encoder's query vectors into
the port's embedding cache (``share_embeddings``).
"""

import datetime as dt
import functools
import uuid

import jax
import pytest

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
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu_torch.core.config import Config
from trie_semantic_search_tpu_torch.index.builder import load_artifacts
from trie_semantic_search_tpu_torch.search.engine import SearchEngine
from trie_semantic_search_tpu_torch.storage.store import StorageManager

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


def engines(art, **search):
    jcfg = JaxConfig.from_file(art["toml"])
    pcfg = Config.from_file(art["toml"])
    for k, v in search.items():
        setattr(jcfg.search, k, v)
        setattr(pcfg.search, k, v)
    jeng = JaxEngine(jcfg, JaxStorage(jcfg.storage), *jax_load_artifacts(jcfg))
    peng = SearchEngine(pcfg, StorageManager(pcfg.storage),
                        *load_artifacts(pcfg, device="cpu"), device="cpu")
    return jeng, peng


def share_embeddings(jeng, peng, texts):
    for t, e in zip(texts, jeng.vector_index.generate_embeddings(texts)):
        peng.vector_index.cache.put(t, e)


