"""The port's index build against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function and its port
(``device="cpu"``). The numpy layout helpers and ``PartitionedANN.build``
from fixed centroids are held bitwise; k-means, which sums in another f32
order, within 1e-5 with equal assignments. Artifacts saved by the port load
in the JAX package and serve the same results, and the whole pipeline
(``build_indexes`` → ``save_artifacts``) gives what the JAX package's does.

Sizes stay small (D ≤ 64, P ≤ 32, N ≤ 4,096), so each test takes seconds.
"""

import datetime as dt
import functools
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trie_semantic_search_tpu.index.kmeans as jk
import trie_semantic_search_tpu.models.minilm as jm
import trie_semantic_search_tpu.ops.hybrid as jax_hybrid
from trie_semantic_search_tpu.core.config import AnnConfig as JaxAnnConfig
from trie_semantic_search_tpu.core.config import Config as JaxConfig
from trie_semantic_search_tpu.core.config import VectorConfig as JaxVectorConfig
from trie_semantic_search_tpu.core.types import CaseMetadata as JaxCaseMetadata
from trie_semantic_search_tpu.core.types import SearchConfig as JaxSearchConfig
from trie_semantic_search_tpu.index import ann as ja
from trie_semantic_search_tpu.index.builder import build_indexes as jax_build_indexes
from trie_semantic_search_tpu.index.builder import load_artifacts as jax_load_artifacts
from trie_semantic_search_tpu.index.builder import save_artifacts as jax_save_artifacts
from trie_semantic_search_tpu.index.builder import update_indexes as jax_update_indexes
from trie_semantic_search_tpu.index.vector import VectorIndex as JaxVectorIndex
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from trie_semantic_search_tpu.models.tokenizer import train_wordpiece_vocab
from trie_semantic_search_tpu.ops.pallas_scan import pallas_fused_topk
from trie_semantic_search_tpu.search.engine import SearchEngine as JaxEngine
from trie_semantic_search_tpu.search.engine import SearchQuery as JaxQuery
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu_torch.core.config import AnnConfig, Config, VectorConfig
from trie_semantic_search_tpu_torch.core.types import CaseMetadata, SearchConfig
from trie_semantic_search_tpu_torch.index import ann as ta
from trie_semantic_search_tpu_torch.index import kmeans as tk
from trie_semantic_search_tpu_torch.index.builder import (
    build_indexes,
    load_artifacts,
    save_artifacts,
    update_indexes,
)
from trie_semantic_search_tpu_torch.index.vector import VectorIndex
from trie_semantic_search_tpu_torch.models import minilm as tm
from trie_semantic_search_tpu_torch.models.embedder import Embedder, EmbeddingResult
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer
from trie_semantic_search_tpu_torch.search.engine import SearchEngine, SearchQuery
from trie_semantic_search_tpu_torch.storage.store import StorageManager

from torch_trie_backend import BACKENDS, force_trie_backend

torch.set_num_threads(1)

D = 32


def _clustered(seed, P, sizes, D=D, spread=0.2, dup=0.0):
    """Rows around ``P`` random unit centroids (``sizes[p]`` each), a share
    ``dup`` of them exact copies of another row, in shuffled order."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((P, D)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    v = np.concatenate([
        cent[p] + spread * rng.standard_normal((s, D)).astype(np.float32) / np.sqrt(D)
        for p, s in enumerate(sizes)
    ])
    v = v[rng.permutation(len(v))]
    if dup:
        src = rng.integers(0, len(v), int(dup * len(v)))
        v[rng.integers(0, len(v), len(src))] = v[src]
    return cent, v


def _normed(v):
    return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)


# -- the numpy layout helpers ---------------------------------------------------


def _helper_case(name):
    """(assign, centroids, normalised rows, cap, choices, m) per case."""
    rng = np.random.default_rng({"overfull": 1, "duplicates": 2, "no_replicas": 3}[name])
    P = 16
    if name == "overfull":  # half the rows in two partitions
        cent, v = _clustered(4, P, [900, 700] + [40] * (P - 2))
    elif name == "duplicates":  # a third of the rows copy others
        cent, v = _clustered(5, P, rng.integers(60, 220, P), dup=0.35)
    else:  # even fill, every slot taken: no room for a replica
        cent, v = _clustered(6, P, [128] * P, spread=0.05)
    v = _normed(v)
    choices = np.asarray(jk.assign_topc(v, cent, 8))
    cap = ja._capacity_cap(len(v), P, 2.0 if name != "overfull" else 1.5)
    m = ja._aligned_capacity(min(cap, int(np.bincount(choices[:, 0]).max())), True)
    if name == "no_replicas":
        m = None
    return choices[:, 0].copy(), cent, v, cap, choices, m


@pytest.mark.parametrize("name", ["overfull", "duplicates", "no_replicas"])
def test_layout_helpers_bitwise(name):
    assign, cent, v, cap, choices, m = _helper_case(name)
    n, P = len(v), len(cent)
    for fill in (0, 1, 7, 8, 9, 127, 128, 129, 1000, 1023, 1100):
        for q in (True, False):
            assert ta._aligned_capacity(fill, q) == ja._aligned_capacity(fill, q)
    for nn, pp, ov in ((n, P, 2.0), (n, P, 0.5), (5_242_880, 5120, 2.0), (7, 64, 2.0)):
        assert ta._capacity_cap(nn, pp, ov) == ja._capacity_cap(nn, pp, ov)
    for nn in (1, 100, 4096, 1_048_576, 5_242_880, 10_000_000):
        assert ta._auto_partitions(nn) == ja._auto_partitions(nn)
    want = ja._rebalance_overflow(assign, cap, cent, lambda r: v[r], slab=100)
    got = ta._rebalance_overflow(assign, cap, cent, lambda r: v[r], slab=100)
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got, minlength=P)
    assert counts.max() <= cap
    if name == "overfull":
        assert (got != assign).sum() > 0
    m = m or int(counts.max())
    jr, jp = ja._plan_pad_replicas(got, counts, m, choices)
    tr, tp = ta._plan_pad_replicas(got, counts, m, choices)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tp, jp)
    assert tp.dtype == jp.dtype
    if name == "no_replicas":
        assert len(tr) == 0
    else:
        assert len(tr) > 0 and (np.bincount(tp, minlength=P) + counts).max() <= m


# -- k-means ----------------------------------------------------------------------


@pytest.mark.parametrize("blocked", [False, True])
def test_train_kmeans_matches_jax(blocked, monkeypatch):
    """Well-separated clusters: centroids within 1e-5, equal assignments;
    ``blocked`` shrinks the Lloyd block in both modules so the sample spans
    several blocks (the last one padded)."""
    if blocked:
        monkeypatch.setattr(jk, "_LLOYD_BLOCK", 500)
        monkeypatch.setattr(tk, "_LLOYD_BLOCK", 500)
    _, v = _clustered(7, 12, [150] * 12, spread=0.1)
    v = _normed(v)
    want = jk.train_kmeans(v, 12, iters=10, sample=1700, seed=3)
    got = tk.train_kmeans(v, 12, iters=10, sample=1700, seed=3, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        tk.assign_clusters(v, got, block=333, device="cpu"), jk.assign_clusters(v, want, block=333)
    )


def test_assign_topc_ties_to_the_lower_id():
    """Duplicated centroids score equal: the lower id comes first, in both
    packages, and column 0 is the nearest-centroid assignment."""
    cent, v = _clustered(8, 6, [40] * 6)
    cent = np.concatenate([cent, cent[[2, 0, 2]]])  # ids 6, 7, 8 copy 2, 0, 2
    v = _normed(v)
    want = jk.assign_topc(v, cent, 5, block=64)
    got = tk.assign_topc(v, cent, 5, block=64, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], tk.assign_clusters(v, cent, device="cpu"))
    first = got[:, 0]
    assert not np.isin(first, [6, 7, 8]).any()
    near2, near0 = first == 2, first == 0
    assert near2.any() and near0.any()
    assert (got[near2, 1] == 6).all() and (got[near2, 2] == 8).all()
    assert (got[near0, 1] == 7).all()


@pytest.mark.parametrize("block", [64, 1000])
@pytest.mark.parametrize("P", [9, 17, 33, 65])
def test_duplicate_tail_centroid_ties_to_the_lower_id(P, block, monkeypatch):
    """A copy of centroid ``dup`` as the last column, the tail of the
    GEMM's column blocks: ``assign_clusters``, ``assign_topc`` and the ids
    the two Lloyd steps assign (whole and blocked) are bitwise the JAX
    package's, so the copy never wins over its lower id, whichever GEMM
    kernel the library picks."""
    cent, v = _clustered(30 + P, P - 1, [1200 // (P - 1) + 1] * (P - 1))
    dup = (P - 1) // 2
    cent = np.concatenate([cent, cent[[dup]]])
    v = _normed(v).astype(np.float32)
    want = np.asarray(jk._assign(jnp.asarray(v), jnp.asarray(cent)))
    assert (want == dup).any() and not (want == P - 1).any()
    np.testing.assert_array_equal(
        tk.assign_clusters(v, cent, block=block, device="cpu"), jk.assign_clusters(v, cent, block=block))
    topc = tk.assign_topc(v, cent, 3, block=block, device="cpu")
    np.testing.assert_array_equal(topc, jk.assign_topc(v, cent, 3, block=block))
    assert (topc[want == dup, 1] == P - 1).all()

    seen = []
    nearest = tk._nearest

    def spy(x, c, first):
        a = nearest(x, c, first)
        seen.append(a.clone())
        return a

    monkeypatch.setattr(tk, "_nearest", spy)
    init = torch.from_numpy(cent)
    tk._lloyd(torch.from_numpy(v), init, P, 1)
    np.testing.assert_array_equal(torch.cat(seen).numpy(), want)
    seen.clear()
    nb = -(-len(v) // block)
    xp = np.zeros((nb * block, D), np.float32)
    xp[: len(v)] = v
    valid = (np.arange(nb * block) < len(v)).astype(np.float32)
    tk._lloyd_blocked(torch.from_numpy(xp).reshape(nb, block, D),
                      torch.from_numpy(valid).reshape(nb, block), init, P, 1)
    np.testing.assert_array_equal(torch.cat(seen).numpy()[: len(v)], want)


# -- PartitionedANN.build from fixed centroids -------------------------------------------


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint8)


def _assert_same_layout(port, jax_ann):
    np.testing.assert_array_equal(port.part_rows.numpy(), np.asarray(jax_ann.part_rows))
    if port.part_int8.dtype == torch.int8:
        np.testing.assert_array_equal(port.part_int8.numpy(), np.asarray(jax_ann.part_int8))
    else:
        np.testing.assert_array_equal(
            port.part_int8.view(torch.int16).numpy().view(np.uint16), _bits(jax_ann.part_int8)
        )
    np.testing.assert_array_equal(
        port.part_scale.numpy().view(np.int32), np.asarray(jax_ann.part_scale).view(np.int32)
    )
    np.testing.assert_array_equal(port.centroids.numpy(), np.asarray(jax_ann.centroids))
    assert len(port.corpus_bf16) == len(jax_ann.corpus_bf16)
    for a, b in zip(port.corpus_bf16, jax_ann.corpus_bf16):
        np.testing.assert_array_equal(a.view(torch.int16).numpy().view(np.uint16), _bits(b))
    assert port._replicated == jax_ann._replicated
    assert port.num_vectors == jax_ann.num_vectors


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("replicas", [True, False])
@pytest.mark.parametrize("overalloc", [2.0, 0.3])
def test_build_from_fixed_centroids_bitwise(quantize, replicas, overalloc):
    """``part_rows``, blocks, scales, centroids and bf16 segments bitwise;
    ``overalloc`` 0.3 forces the overflow rebalance."""
    cent, v = _clustered(9, 16, np.random.default_rng(9).integers(50, 400, 16), dup=0.05)
    v[5] = np.nan  # zeroed on both sides
    fixed = jk.train_kmeans(_normed(np.nan_to_num(v)), 16, seed=1)
    kw = dict(quantize_int8=quantize, pad_replicas=replicas, partition_overalloc=overalloc)
    jax_ann = ja.PartitionedANN(JaxAnnConfig(**kw))
    jax_ann.build(v, reuse_centroids=fixed)
    port = ta.PartitionedANN(AnnConfig(**kw), device="cpu")
    port.build(v, reuse_centroids=fixed)
    _assert_same_layout(port, jax_ann)
    assert port._replicated == replicas
    if overalloc < 1:
        nearest = tk.assign_clusters(_normed(np.nan_to_num(v)), fixed, device="cpu")
        assert np.bincount(nearest).max() > ta._capacity_cap(len(v), len(fixed), overalloc)
    assert set(port.build_seconds) == {
        "normalize", "kmeans", "assign", "rebalance", "layout", "quantize_upload"}


def test_build_trains_like_jax():
    """A full build (k-means included) on separated data: the same
    partitioning and layout as the JAX package's."""
    _, v = _clustered(10, 16, [120] * 16, spread=0.1)
    jax_ann = ja.PartitionedANN(JaxAnnConfig(num_partitions=16))
    jax_ann.build(v, seed=4)
    port = ta.PartitionedANN(AnnConfig(num_partitions=16), device="cpu")
    port.build(v, seed=4)
    np.testing.assert_allclose(port.centroids.numpy(), np.asarray(jax_ann.centroids), atol=1e-5)
    np.testing.assert_array_equal(port.part_rows.numpy(), np.asarray(jax_ann.part_rows))
    np.testing.assert_array_equal(port.part_int8.numpy(), np.asarray(jax_ann.part_int8))


# -- saved artifacts --------------------------------------------------------------


@pytest.fixture(scope="module")
def built_pair():
    """The port's and the JAX package's index over the same vectors and
    centroids (equal layouts), with queries near corpus rows."""
    cent, v = _clustered(11, 16, np.random.default_rng(11).integers(60, 200, 16), dup=0.1)
    fixed = jk.train_kmeans(_normed(v), 16, seed=2)
    port = ta.PartitionedANN(AnnConfig(num_probes=3), device="cpu")
    port.build(v, reuse_centroids=fixed)
    rng = np.random.default_rng(12)
    q = v[rng.integers(0, len(v), 9)] + 0.1 * rng.standard_normal((9, D)).astype(np.float32)
    return port, v, fixed, q.astype(np.float32)


@pytest.mark.parametrize("fmt", ["npz", "dir"])
def test_port_saved_ann_loads_in_jax(built_pair, fmt, tmp_path):
    """``save`` / ``save_dir`` → the JAX package's ``load`` / ``load_dir``:
    the same arrays and the same search results; the port reloads it too."""
    port, v, fixed, q = built_pair
    port.tuned_nprobe = 5
    if fmt == "npz":
        port.save(tmp_path / "ann.npz")
        jax_ann = ja.PartitionedANN.load(tmp_path / "ann.npz")
        back = ta.PartitionedANN.load(tmp_path / "ann.npz", device="cpu")
    else:
        port.save_dir(tmp_path / "ann.mmap")
        assert not (tmp_path / "ann.mmap.tmp").exists()
        jax_ann = ja.PartitionedANN.load_dir(tmp_path / "ann.mmap")
        back = ta.PartitionedANN.load_dir(tmp_path / "ann.mmap", device="cpu")
    port.tuned_nprobe = 0
    _assert_same_layout(back, jax_ann)
    if fmt == "dir":
        _assert_same_layout(port, jax_ann)
    else:  # the npz holds the rescore rows as f16: bf16 values below f16's range round
        for a, b in zip(port.corpus_bf16, back.corpus_bf16):
            torch.testing.assert_close(a.half().to(torch.bfloat16), b, rtol=0, atol=0)
    assert jax_ann.tuned_nprobe == back.tuned_nprobe == 5
    for k, nprobe in ((5, 3), (10, 5)):
        jv, ji = jax_ann.search(q, k, nprobe=nprobe)
        tv, ti = back.search(q, k, nprobe=nprobe)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(port.search(q, k, nprobe=nprobe)[1], ti)
        jv, ji = jax_ann.search_brute(q, k)
        tv, ti = back.search_brute(q, k)
        np.testing.assert_array_equal(ti, np.asarray(ji))


def test_bf16_blocks_save_and_load_in_jax(tmp_path):
    _, v = _clustered(13, 8, [100] * 8)
    port = ta.PartitionedANN(AnnConfig(quantize_int8=False, num_partitions=8), device="cpu")
    port.build(v, seed=1)
    port.save(tmp_path / "ann.npz")
    port.save_dir(tmp_path / "ann.mmap")
    _assert_same_layout(port, ja.PartitionedANN.load_dir(tmp_path / "ann.mmap"))
    _assert_same_layout(ta.PartitionedANN.load(tmp_path / "ann.npz", device="cpu"),
                        ja.PartitionedANN.load(tmp_path / "ann.npz"))


def test_tune_nprobe_matches_jax(built_pair):
    port, v, fixed, q = built_pair
    jax_ann = ja.PartitionedANN(JaxAnnConfig(num_probes=3))
    jax_ann.build(v, reuse_centroids=fixed)
    rng = np.random.default_rng(14)
    sample = v[rng.choice(len(v), 64, replace=False)]
    for target in (0.9, 0.99, 1.0):
        got = port.tune_nprobe(sample, k=10, target_recall=target)
        assert got == jax_ann.tune_nprobe(sample, k=10, target_recall=target)
        assert port.default_nprobe == got
    port.tuned_nprobe = 0


# -- the vector index ------------------------------------------------------------------


TINY = dict(vocab_size=512, hidden_size=D, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=64)


def test_vector_load_without_ann_rebuilds(tmp_path):
    """A saved vector index with no ANN artifact: both packages rebuild the
    ANN from the vectors on load and serve the same rows."""
    _, v = _clustered(15, 8, [90] * 8, spread=0.05)
    v = _normed(v)
    jvi = JaxVectorIndex(JaxVectorConfig(), embedder=JaxEmbedder(model_config=jm.MiniLMConfig(**TINY)))
    jvi._vectors = v
    jvi._refs = [(r // 3, r % 3) for r in range(len(v))]
    jvi.save(tmp_path)
    assert not (tmp_path / "ann.npz").exists() and not (tmp_path / "ann.mmap").exists()
    jvi2 = JaxVectorIndex(JaxVectorConfig(), embedder=jvi.embedder)
    jvi2.load(tmp_path)
    model = tm.MiniLM(tm.MiniLMConfig(**TINY), device="cpu")
    tvi = VectorIndex(VectorConfig(), embedder=Embedder(model=model, device="cpu"), device="cpu")
    tvi.load(tmp_path)
    assert tvi.ann.num_vectors == len(v) == jvi2.ann.num_vectors
    q = v[::37] + 0.01
    for brute in (True, False):
        got = tvi.search_embedded(q, 5, use_brute=brute)
        want = jvi2.search_embedded(q, 5, use_brute=brute)
        assert [[(h.row, h.paragraph_index) for h in r] for r in got] == \
            [[(h.row, h.paragraph_index) for h in r] for r in want]
        np.testing.assert_allclose(
            [h.similarity_score for r in got for h in r],
            [h.similarity_score for r in want for h in r], atol=1e-5)


def test_vector_index_build_save_round_trip(tmp_path):
    """add_document / embed_pending / freeze / save in the port; the JAX
    package loads the directory and finds the same refs, vectors and ANN."""
    vocab = train_wordpiece_vocab(["alpha beta gamma delta"] * 3, vocab_size=512, min_frequency=1)
    model = tm.MiniLM(tm.MiniLMConfig(**TINY), device="cpu", seed=5)
    emb = Embedder(tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu")
    vi = VectorIndex(VectorConfig(), embedder=emb, device="cpu")
    texts = [f"alpha {i} beta {i % 7} gamma" for i in range(300)]
    for i, t in enumerate(texts[:200]):
        vi.add_document(i // 4, t, i % 4)
    assert vi.embed_pending(flush_threshold=500) == 0
    assert vi.embed_pending(flush_threshold=100) == 200 and vi.size == 200
    vi.add_documents([(50 + i // 4, i % 4, t) for i, t in enumerate(texts[200:])])
    vi.freeze(seed=2)
    assert vi.size == vi.ann.num_vectors == 300
    vi.save(tmp_path)
    jvi = JaxVectorIndex(JaxVectorConfig(), embedder=JaxEmbedder(model_config=jm.MiniLMConfig(**TINY)))
    jvi.load(tmp_path)
    np.testing.assert_array_equal(np.asarray(jvi.refs), np.asarray(vi.refs, np.int32))
    np.testing.assert_array_equal(np.asarray(jvi.vectors), vi.vectors)
    _assert_same_layout(vi.ann, jvi.ann)


# -- the pipeline: build_indexes, save_artifacts -------------------------------------------------


COURTS = ["Supreme Court", "Ninth Circuit", "Tax Court"]
WORDS = ["contract", "breach", "damages", "search", "seizure", "counsel", "custody",
         "negligence", "duty", "care", "equal", "protection", "speech", "press"]


def _cases(n=48):
    rng = np.random.default_rng(16)
    out = []
    for i in range(n):
        sents = [" ".join(rng.choice(WORDS, 6)).capitalize() + f" in matter {i} part {j}."
                 for j in range(int(rng.integers(2, 5)))]
        if i % 5 == 0:
            sents.append(f"See {i} U.S. {100 + i} (1970).")
        out.append((f"{WORDS[i % 14].title()} v. {WORDS[(i * 3) % 14].title()} {i}",
                    f"{i} U.S. {100 + i} (19{50 + i % 40})" if i % 3 else "",
                    COURTS[i % 3], dt.date(1950, 1, 1) + dt.timedelta(days=331 * i), " ".join(sents)))
    return out


def _add_cases(store, meta_cls, cases, start=0):
    """Store ``cases`` as case numbers ``start, start + 1, ...`` (ids in
    another order than the rows)."""
    for i, (name, cit, court, date, text) in enumerate(cases, start):
        meta = meta_cls(id=uuid.UUID(int=(i * 7919) % 1000 + 1), name=name, citation=cit,
                        court=court, decision_date=date, word_count=len(text.split()))
        store.store_cases_batch([(meta, text)])


def _write_store(store_cls, meta_cls, path, cases):
    cfg = JaxConfig().storage if store_cls is JaxStorage else Config().storage
    cfg.db_path = str(path)
    store = store_cls(cfg)
    _add_cases(store, meta_cls, cases)
    return store


def _configs(root, tag):
    cfgs = []
    for cls in (JaxConfig, Config):
        c = cls()
        c.storage.db_path = str(root / f"{tag}.sqlite")
        c.trie.index_path = str(root / tag / "trie")
        c.vector.hnsw.index_path = str(root / tag / "vec")
        c.vector.hnsw.num_partitions = 8
        c.vector.hnsw.num_probes = 2
        c.vector.dimension = D
        c.vector.model.max_sequence_length = 64
        c.vector.pooling = "mean"
        c.vector.quality_gate = "off"
        cfgs.append(c)
    return cfgs


@pytest.fixture(params=BACKENDS)
def f32_jax_encoder(request, monkeypatch):
    """The JAX encoder in f32 compute (the port's model is switched to f32
    beside it), so the two differ only in summation order; both packages'
    tries on the same builder backend (each case runs on both)."""
    monkeypatch.setattr(jm, "encode", functools.partial(jm.encode, compute_dtype=jnp.float32))
    force_trie_backend(monkeypatch, request.param)
    yield


def _encoders(cases):
    vocab = train_wordpiece_vocab([c[4] for c in cases], vocab_size=512, min_frequency=1)
    jcfg = jm.MiniLMConfig(**TINY)
    params = jm.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = tm.MiniLM(tm.MiniLMConfig(**TINY), device="cpu").load_params(tm.params_from_jax(tree))
    return vocab, params, jcfg, model


def test_build_indexes_matches_jax(tmp_path, f32_jax_encoder):
    """The same cases through both packages' stores and builds: trie arrays,
    refs and columns equal, vectors within 1e-5; the port's ANN over the
    JAX build's vectors and centroids is the JAX layout bitwise."""
    cases = _cases()
    jcfg, pcfg = _configs(tmp_path, "b")
    pcfg.storage.db_path = str(tmp_path / "b_port.sqlite")
    jstore = _write_store(JaxStorage, JaxCaseMetadata, jcfg.storage.db_path, cases)
    pstore = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases)
    vocab, params, mcfg, model = _encoders(cases)
    model.compute_dtype = torch.float32
    jb = jax_build_indexes(jstore, jcfg, embedder=JaxEmbedder(
        jcfg.vector.model, tokenizer=JaxTokenizer(vocab), params=params, model_config=mcfg))
    pb = build_indexes(pstore, pcfg, embedder=Embedder(
        pcfg.vector.model, tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu"),
        device="cpu")
    assert (pb.report.cases, pb.report.content_chunks, pb.report.citations) == (
        jb.report.cases, jb.report.content_chunks, jb.report.citations)
    for name in ("name_trie", "content_trie", "citation_trie"):
        jt, tt = getattr(jb.trie, name), getattr(pb.trie, name)
        assert tt.vocab == jt.vocab
        for f in tt._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(np.asarray(pb.vector.refs, np.int32), np.asarray(jb.vector.refs, np.int32))
    assert [str(c) for c in pb.columns.case_ids] == [str(c) for c in jb.columns.case_ids]
    np.testing.assert_array_equal(pb.columns.court_ids, jb.columns.court_ids)
    np.testing.assert_array_equal(pb.columns.dates, jb.columns.dates)
    np.testing.assert_allclose(pb.vector.vectors, jb.vector.vectors, atol=1e-5, rtol=0)
    rebuilt = ta.PartitionedANN(pcfg.vector.hnsw, device="cpu")
    rebuilt.build(np.asarray(jb.vector.vectors), reuse_centroids=np.asarray(jb.vector.ann.centroids))
    _assert_same_layout(rebuilt, jb.vector.ann)
    jstore.close()
    pstore.close()


def test_build_indexes_with_pretraining_matches_jax(tmp_path, f32_jax_encoder, monkeypatch):
    """``build_indexes(pretrain_steps=8)`` in both packages from the same
    parameters (f32 compute): the docs and arguments handed to
    ``pretrain_encoder_guarded`` equal the JAX package's, the guardrail
    makes the same choice, the tries and refs equal; when both keep
    ``"init"`` the vectors are the JAX package's within 1e-5, and when both
    keep the trained weights within the AdamW drift of 8 steps."""
    import trie_semantic_search_tpu.models.train as jtrain
    import trie_semantic_search_tpu_torch.models.train as ttrain

    cases = _cases(48)
    jcfg, pcfg = _configs(tmp_path, "t")
    pcfg.storage.db_path = str(tmp_path / "t_port.sqlite")
    jstore = _write_store(JaxStorage, JaxCaseMetadata, jcfg.storage.db_path, cases)
    pstore = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases)
    vocab, params, mcfg, model = _encoders(cases)
    model.compute_dtype = torch.float32
    calls = {}

    def recorder(tag, fn):
        def wrapped(embedder, docs, **kw):
            rep = fn(embedder, docs, **kw)
            calls[tag] = (docs, kw, rep)
            return rep
        return wrapped

    monkeypatch.setattr(jtrain, "pretrain_encoder_guarded", recorder("jax", jtrain.pretrain_encoder_guarded))
    monkeypatch.setattr(ttrain, "pretrain_encoder_guarded", recorder("port", ttrain.pretrain_encoder_guarded))
    jb = jax_build_indexes(jstore, jcfg, pretrain_steps=8, embedder=JaxEmbedder(
        jcfg.vector.model, tokenizer=JaxTokenizer(vocab), params=params, model_config=mcfg))
    pb = build_indexes(pstore, pcfg, pretrain_steps=8, device="cpu", embedder=Embedder(
        pcfg.vector.model, tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu"))
    (jdocs, jkw, jrep), (pdocs, pkw, prep) = calls["jax"], calls["port"]
    assert pdocs == jdocs and len(pdocs) == 48 and pkw == jkw == {"steps": 8, "max_len": 64}
    assert sorted(prep) == sorted(jrep) and prep["steps"] == 8 and prep["pairs"] == jrep["pairs"]
    assert prep["guardrail"]["kept"] == jrep["guardrail"]["kept"], (prep, jrep)
    assert pb.report.pretrain_seconds > 0
    for name in ("name_trie", "content_trie", "citation_trie"):
        jt, tt = getattr(jb.trie, name), getattr(pb.trie, name)
        for f in tt._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(np.asarray(pb.vector.refs, np.int32), np.asarray(jb.vector.refs, np.int32))
    tol = 1e-5 if prep["guardrail"]["kept"] == "init" else 1e-3
    np.testing.assert_allclose(pb.vector.vectors, jb.vector.vectors, atol=tol, rtol=0)
    if prep["guardrail"]["kept"] == "init":
        for key, p in model.leaves():
            g, n = key.split(".", 1)
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(params[g][n]))
    jstore.close()
    pstore.close()


@pytest.mark.parametrize("pooling", ["auto", "sif"])
def test_build_indexes_pooling_selection_matches_jax(tmp_path, f32_jax_encoder, monkeypatch, pooling):
    """``build_indexes`` with no embedder and ``vector.pooling`` ``"auto"``
    (the default) or ``"sif"``, the encoder each package makes from the
    corpus vocab carrying the same parameters: the same pooling pick and
    SIF weights bitwise, tries, refs and counts equal, vectors within
    1e-5, and ``token_weights.npy`` saved beside the encoder exactly when
    the JAX package saves it."""
    import trie_semantic_search_tpu.index.builder as jbuilder
    import trie_semantic_search_tpu_torch.index.builder as tbuilder

    cases = _cases(64)
    jcfg, pcfg = _configs(tmp_path, "p")
    pcfg.storage.db_path = str(tmp_path / "p_port.sqlite")
    for c in (jcfg, pcfg):
        c.vector.pooling = pooling
    jstore = _write_store(JaxStorage, JaxCaseMetadata, jcfg.storage.db_path, cases)
    pstore = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases)
    mcfg = dict(TINY, vocab_size=8192)
    params = jm.init_params(jax.random.PRNGKey(3), jm.MiniLMConfig(**mcfg))
    model = tm.MiniLM(tm.MiniLMConfig(**mcfg), device="cpu").load_params(
        tm.params_from_jax(jax.tree.map(np.asarray, params)))
    model.compute_dtype = torch.float32
    monkeypatch.setattr(jbuilder, "Embedder", lambda cfg, tokenizer: JaxEmbedder(
        cfg, tokenizer=tokenizer, params=params, model_config=jm.MiniLMConfig(**mcfg)))
    monkeypatch.setattr(tbuilder, "Embedder", lambda cfg, tokenizer, device: Embedder(
        cfg, tokenizer=tokenizer, model=model, device=device))
    jb = jax_build_indexes(jstore, jcfg)
    pb = build_indexes(pstore, pcfg, device="cpu")
    jw, tw = jb.vector.embedder.token_weights, pb.vector.embedder.token_weights
    assert (jw is None) == (tw is None)
    if pooling == "sif":
        assert tw is not None
    if tw is not None:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert (pb.report.cases, pb.report.content_chunks, pb.report.citations) == (
        jb.report.cases, jb.report.content_chunks, jb.report.citations)
    for name in ("name_trie", "content_trie", "citation_trie"):
        jt, tt = getattr(jb.trie, name), getattr(pb.trie, name)
        for f in tt._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(np.asarray(pb.vector.refs, np.int32), np.asarray(jb.vector.refs, np.int32))
    np.testing.assert_allclose(pb.vector.vectors, jb.vector.vectors, atol=1e-5, rtol=0)
    save_artifacts(pb, pcfg)
    jax_save_artifacts(jb, jcfg)
    assert (Path(pcfg.vector.hnsw.index_path) / "token_weights.npy").exists() == (
        Path(jcfg.vector.hnsw.index_path) / "token_weights.npy").exists() == (tw is not None)
    jstore.close()
    pstore.close()


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


@pytest.fixture(scope="module")
def port_artifacts(tmp_path_factory):
    """A store and artifacts the port built (no embedder passed: corpus
    vocab, seeded encoder from ``vector.model``) and saved."""
    root = tmp_path_factory.mktemp("port_art")
    jcfg, pcfg = _configs(root, "a")
    for c in (jcfg, pcfg):
        c.vector.dimension = 384
    cases = _cases(40)
    store = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases)
    built = build_indexes(store, pcfg, device="cpu")
    assert built.vector.embedder.model_config.hidden_size == 384
    save_artifacts(built, pcfg, storage=store)  # the quality gate is off: no report
    assert not (Path(pcfg.vector.hnsw.index_path) / "quality.json").exists()
    store.close()
    return dict(root=root, jcfg=jcfg, pcfg=pcfg, built=built, cases=cases)


QUERIES = [("contract breach damages", None, None), ("search and seizure", None, None),
           ("duty of care", [COURTS[1]], None), ("equal protection", None,
                                                 (dt.date(1950, 1, 1), dt.date(1975, 1, 1))),
           ("counsel custody", None, None)]


def _queries(query_cls, config_cls, cases):
    out = [query_cls(query=cases[i][0].lower(), config=config_cls(min_similarity=-1.0))
           for i in (0, 7, 13)]
    for text, courts, dates in QUERIES:
        out.append(query_cls(query=text, court_filter=courts, date_range=dates,
                             config=config_cls(min_similarity=-1.0)))
    return out


@pytest.mark.parametrize("mode", ["brute", "partitioned"])
def test_port_artifacts_serve_in_jax_engine(port_artifacts, mode, kernels_interpret):
    """The Done criterion: artifacts the port saved load in the JAX
    package's ``load_artifacts``, and its ``SearchEngine`` returns the same
    case ids in the same order as the port's engine over the same files
    (the JAX encoder's query vectors shared with the port, as in
    ``tests/test_torch_engine.py``)."""
    jcfg, pcfg, cases = port_artifacts["jcfg"], port_artifacts["pcfg"], port_artifacts["cases"]
    for c in (jcfg, pcfg):
        c.search.fused_ann_mode = mode
        c.search.enable_query_cache = False
    jeng = JaxEngine(jcfg, JaxStorage(jcfg.storage), *jax_load_artifacts(jcfg))
    peng = SearchEngine(pcfg, StorageManager(pcfg.storage), *load_artifacts(pcfg, device="cpu"),
                        device="cpu")
    jq, pq = _queries(JaxQuery, JaxSearchConfig, cases), _queries(SearchQuery, SearchConfig, cases)
    texts = [q.query for q in jq]
    for t, e in zip(texts, jeng.vector_index.generate_embeddings(texts)):
        peng.vector_index.cache.put(t, e)
    want, got = jeng.search_batch(jq), peng.search_batch(pq)
    served = 0
    for g, w in zip(got, want):
        assert [str(r.case_metadata.id) for r in g] == [str(r.case_metadata.id) for r in w]
        assert [r.match_type.value for r in g] == [r.match_type.value for r in w]
        served += len(g)
    assert served > 0
    assert got[0][0].match_type.value in ("case_name", "exact")
    np.testing.assert_array_equal(
        np.asarray(jeng.vector_index.ann.part_rows), peng.vector_index.ann.part_rows.numpy())


def test_port_artifacts_reload_in_port(port_artifacts):
    """load_artifacts gives back the built trie, refs, ANN and encoder."""
    built, pcfg = port_artifacts["built"], port_artifacts["pcfg"]
    trie, vec, cols = load_artifacts(pcfg, device="cpu")
    for name in ("name_trie", "content_trie", "citation_trie"):
        for f in trie.name_trie._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(getattr(trie, name), f),
                                          getattr(getattr(built.trie, name), f))
    np.testing.assert_array_equal(np.asarray(vec.refs), np.asarray(built.vector.refs, np.int32))
    a, b = vec.ann, built.vector.ann
    for name in ("part_rows", "part_int8", "part_scale", "centroids"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=0)
    for x, y in zip(a.corpus_bf16, b.corpus_bf16):  # saved as f16 in the npz
        torch.testing.assert_close(x, y.half().to(torch.bfloat16), rtol=0, atol=0)
    texts = ["contract breach", "search seizure"]
    np.testing.assert_array_equal(vec.embedder.embed(texts).embedding,
                                  built.vector.embedder.embed(texts).embedding)
    assert [str(c) for c in cols.case_ids] == [str(c) for c in built.columns.case_ids]



def _trie_arrays(trie):
    return {(name, f): np.array(getattr(getattr(trie, name), f))
            for name in ("name_trie", "content_trie", "citation_trie")
            for f in getattr(trie, name)._ARRAY_FIELDS}


@pytest.mark.parametrize("branch", ["incremental", "fallback"])
def test_update_indexes_matches_jax(tmp_path, f32_jax_encoder, kernels_interpret, branch):
    """Cases stored after a build, through both packages' ``update_indexes``:
    the incremental branch (old rows lead the store) and the full-rebuild
    fallback (the first case deleted: every row id moves). Both embed with
    the JAX encoder's vectors (the port's embedder hands them over), and
    both start from the same partitioning, so tries, refs, columns, vectors
    and the ANN layout must be bitwise the JAX package's; the fallback's
    fresh k-means agrees within 1e-5 and its layout is held from the JAX
    centroids. The port leaves the indexes it was given untouched, and the
    JAX engine serves the port's saved result with the same case ids."""
    cases = _cases(56)
    jcfg, pcfg = _configs(tmp_path, "u")
    pcfg.storage.db_path = str(tmp_path / "u_port.sqlite")
    jstore = _write_store(JaxStorage, JaxCaseMetadata, jcfg.storage.db_path, cases[:44])
    pstore = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases[:44])
    vocab, params, mcfg, model = _encoders(cases)
    jemb = JaxEmbedder(jcfg.vector.model, tokenizer=JaxTokenizer(vocab), params=params,
                       model_config=mcfg)
    pemb = Embedder(pcfg.vector.model, tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu")
    pemb.embed = lambda texts: EmbeddingResult(
        np.asarray(jemb.embed(list(texts)).embedding, np.float32), 0.0)
    jb = jax_build_indexes(jstore, jcfg, embedder=jemb)
    pb = build_indexes(pstore, pcfg, embedder=pemb, device="cpu")
    pb.vector.ann.build(pb.vector.vectors, reuse_centroids=np.asarray(jb.vector.ann.centroids))
    _assert_same_layout(pb.vector.ann, jb.vector.ann)
    live_trie, live_ann, live_refs = _trie_arrays(pb.trie), pb.vector.ann, len(pb.vector.refs)
    if branch == "fallback":
        first = uuid.UUID(int=1)
        assert jstore.delete_case(first) and pstore.delete_case(first)
    _add_cases(jstore, JaxCaseMetadata, cases[44:], start=44)
    _add_cases(pstore, CaseMetadata, cases[44:], start=44)

    ju = jax_update_indexes(jb, jstore, jcfg)
    pu = update_indexes(pb, pstore, pcfg)
    got = _trie_arrays(pb.trie)
    for key, arr in live_trie.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=str(key))
    assert pb.vector.ann is live_ann and len(pb.vector.refs) == live_refs
    assert (pu.report.cases, pu.report.content_chunks, pu.report.citations) == (
        ju.report.cases, ju.report.content_chunks, ju.report.citations)
    for name in ("name_trie", "content_trie", "citation_trie"):
        jt, tt = getattr(ju.trie, name), getattr(pu.trie, name)
        assert tt.vocab == jt.vocab
        for f in tt._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f"{name}.{f}")
    np.testing.assert_array_equal(np.asarray(pu.vector.refs, np.int32),
                                  np.asarray(ju.vector.refs, np.int32))
    np.testing.assert_array_equal(pu.vector.vectors, np.asarray(ju.vector.vectors))
    assert [str(c) for c in pu.columns.case_ids] == [str(c) for c in ju.columns.case_ids]
    np.testing.assert_array_equal(pu.columns.dates, ju.columns.dates)
    if branch == "fallback":
        np.testing.assert_allclose(pu.vector.ann.centroids.numpy(),
                                   np.asarray(ju.vector.ann.centroids), atol=1e-5, rtol=0)
        pu.vector.ann.build(pu.vector.vectors, reuse_centroids=np.asarray(ju.vector.ann.centroids))
    else:
        assert pu.report.cases == len(cases) and pu.vector.ann is not live_ann
    _assert_same_layout(pu.vector.ann, ju.vector.ann)
    assert pu.vector.ann.tuned_nprobe == ju.vector.ann.tuned_nprobe

    save_artifacts(pu, pcfg, storage=pstore)
    jcfg.trie.index_path, jcfg.vector.hnsw.index_path = pcfg.trie.index_path, pcfg.vector.hnsw.index_path
    jcfg.storage.db_path = pcfg.storage.db_path
    jeng = JaxEngine(jcfg, JaxStorage(jcfg.storage), *jax_load_artifacts(jcfg))
    peng = SearchEngine(pcfg, StorageManager(pcfg.storage), *load_artifacts(pcfg, device="cpu"),
                        device="cpu")
    jq, pq = _queries(JaxQuery, JaxSearchConfig, cases), _queries(SearchQuery, SearchConfig, cases)
    jq.append(JaxQuery(query=cases[50][0].lower()))
    pq.append(SearchQuery(query=cases[50][0].lower()))
    texts = [q.query for q in jq]
    for t, e in zip(texts, jeng.vector_index.generate_embeddings(texts)):
        peng.vector_index.cache.put(t, e)
    want, got = jeng.search_batch(jq), peng.search_batch(pq)
    for g, w in zip(got, want):
        assert [str(r.case_metadata.id) for r in g] == [str(r.case_metadata.id) for r in w]
        assert [r.match_type.value for r in g] == [r.match_type.value for r in w]
    assert got[-1][0].case_metadata.name == cases[50][0]
    jstore.close()
    pstore.close()
