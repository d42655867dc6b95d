"""The serving slice end to end: the port's ``FusedHybridSearch.query_batch``
against the JAX package's, on artifacts the JAX package built and saved
(trie, metadata columns, vector index with a partitioned ANN).

Both sides must return identical case rows, chunk rows and sources.
Scores: the int8 scores of the brute mode are bitwise on both sides; the
partitioned modes rescore in bf16 with f32 sums, whose order differs, so
scores agree within 1e-5.

The kernel branches run on the JAX side as the JAX package's own tests run
them on the CPU: the probe and rescore kernels in interpret mode through
``TSS_PROBE_INTERPRET=1``, the fused scan by patching ``_use_pallas`` and
``pallas_fused_topk`` (interpret mode) in ``ops.hybrid`` after clearing
JAX's caches. On the port's side the same branches run the kernels' plain
versions (CPU tensors).
"""

import datetime as dt
import functools
import shutil
import uuid

import jax
import numpy as np
import pytest
import torch

import trie_semantic_search_tpu.ops.hybrid as jax_hybrid
from trie_semantic_search_tpu.core.config import AnnConfig as JaxAnnConfig
from trie_semantic_search_tpu.core.config import VectorConfig as JaxVectorConfig
from trie_semantic_search_tpu.index.ann import PartitionedANN as JaxANN
from trie_semantic_search_tpu.index.ann import _rescore_store
from trie_semantic_search_tpu.index.trie import TrieIndex as JaxTrieIndex
from trie_semantic_search_tpu.index.vector import VectorIndex as JaxVectorIndex
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.minilm import MiniLMConfig as JaxMiniLMConfig
from trie_semantic_search_tpu.ops.pallas_scan import pallas_fused_topk
from trie_semantic_search_tpu.search.fused import FusedHybridSearch as JaxFused
from trie_semantic_search_tpu.storage.columns import MetadataColumns as JaxColumns
from trie_semantic_search_tpu_torch.index.trie import TrieIndex
from trie_semantic_search_tpu_torch.index.vector import VectorIndex
from trie_semantic_search_tpu_torch.models.embedder import Embedder
from trie_semantic_search_tpu_torch.models.minilm import MiniLM, MiniLMConfig
from trie_semantic_search_tpu_torch.ops import scan_kernels
from trie_semantic_search_tpu_torch.search.fused import FusedHybridSearch
from trie_semantic_search_tpu_torch.storage.columns import MetadataColumns

torch.set_num_threads(1)

P, M, D = 16, 128, 64  # P*M = 2048: one fused-scan tile, kernel-eligible
CHUNKS_PER_CASE = 5
COURTS = ["Supreme Court", "Ninth Circuit", "Second Circuit", "Tax Court"]
TINY = dict(vocab_size=256, hidden_size=D, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=32)
K = 5


def _layout(rng):
    """Partition-major clustered corpus with 10% exact duplicates, pad
    slots and pad replicas (rows copied into a neighbour's free slots)."""
    cent = rng.standard_normal((P, D)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    fill = rng.integers(100, 121, P)
    vecs, part_rows = [], np.full((P, M), -1, np.int32)
    row = 0
    for p in range(P):
        v = cent[p] + 0.3 * rng.standard_normal((fill[p], D)).astype(np.float32) / np.sqrt(D)
        dup = rng.random(fill[p]) < 0.1
        dup[0] = False
        for i in np.nonzero(dup)[0]:
            v[i] = v[i - 1]
        vecs.append(v)
        part_rows[p, : fill[p]] = np.arange(row, row + fill[p])
        row += fill[p]
    v = np.concatenate(vecs)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for p in range(P):  # replicas: 3 rows of partition p into p+1's pads
        q = (p + 1) % P
        part_rows[q, fill[q] : fill[q] + 3] = part_rows[p, :3]
    scale = np.maximum(np.abs(v).max(axis=1), 1e-12) / 127.0
    q8 = np.clip(np.round(v / scale[:, None]), -127, 127).astype(np.int8)
    safe = np.maximum(part_rows, 0)
    part_int8 = q8[safe]
    part_scale = scale[safe].astype(np.float32)
    part_int8[part_rows < 0] = 0
    part_scale[part_rows < 0] = 0.0
    return cent, v, part_rows, part_int8, part_scale


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(0)
    cent, v, part_rows, part_int8, part_scale = _layout(rng)
    N = v.shape[0]
    C = -(-N // CHUNKS_PER_CASE)
    names = [f"case {i} v. party{i % 13}" for i in range(C)]
    rows = [
        (str(uuid.UUID(int=i + 1)), COURTS[i % len(COURTS)] if i % 17 else "",
         (dt.date(1950, 1, 1) + dt.timedelta(days=97 * i)).isoformat() if i % 23 else "")
        for i in range(C)
    ]
    cols = JaxColumns.build(rows)
    cols.save(root / "columns.npz")
    trie = JaxTrieIndex()
    for i, n in enumerate(names):
        trie.insert_case_name(n, i)
        trie.insert_citation(f"{i} U.S. {3 * i + 1} (1960)", i)
        trie.insert_content(n.split() + ["opinion", f"topic{i % 7}"], i, 0)
    trie.freeze()
    trie.save_to_disk(root / "trie")

    emb = JaxEmbedder(model_config=JaxMiniLMConfig(**TINY))
    vcfg = JaxVectorConfig()
    vcfg.hnsw = JaxAnnConfig(num_probes=3)
    vi = JaxVectorIndex(vcfg, embedder=emb)
    ann = JaxANN(vcfg.hnsw)
    ann.centroids = jax.numpy.asarray(cent)
    ann.part_rows = jax.numpy.asarray(part_rows)
    ann.part_int8 = jax.numpy.asarray(part_int8)
    ann.part_scale = jax.numpy.asarray(part_scale)
    ann.corpus_bf16 = _rescore_store(v)
    ann.num_vectors = N
    ann._replicated = True
    vi.ann = ann
    vi._vectors = v
    vi._refs = [(r // CHUNKS_PER_CASE, r % CHUNKS_PER_CASE) for r in range(N)]
    vi.save(root / "vec")  # small: ann.npz
    shutil.copytree(root / "vec", root / "vec_dir")
    (root / "vec_dir" / "ann.npz").unlink()
    ann.save_dir(root / "vec_dir" / "ann.mmap")

    # queries: perturbed corpus rows, lexical hits, court/date filters
    B = 7
    pick = rng.integers(0, N, B)
    q = v[pick] + 0.2 * rng.standard_normal((B, D)).astype(np.float32) / np.sqrt(D)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = v[pick[2]]  # a query sitting exactly on a duplicated row
    texts = [names[pick[0] // CHUNKS_PER_CASE], "unrelated words", names[5],
             "topic3 opinion", "case 9 v. party9", "zzz", "party4"]
    courts = [None, [COURTS[1]], None, [COURTS[0], COURTS[2]], None, ["Nowhere"], None]
    dates = [None, None, (dt.date(1955, 1, 1), dt.date(1990, 1, 1)), None,
             (None, dt.date(1970, 1, 1)), None, None]
    return dict(root=root, trie=trie, vi=vi, cols=cols, q=q.astype(np.float32),
                texts=texts, courts=courts, dates=dates,
                min_sim=[0.2, 0.0, 0.3, -1.0, 0.1, 0.0, 0.25], ew=[2.0] * B)


def _port(art, mode, eps=0.0, vec="vec"):
    dev = "cpu"
    trie = TrieIndex.load_from_disk(art["root"] / "trie", device=dev)
    model = MiniLM(MiniLMConfig(**TINY), device=dev)
    vi = VectorIndex(embedder=Embedder(model=model, device=dev), device=dev)
    vi.load(art["root"] / vec)
    cols = MetadataColumns.load(art["root"] / "columns.npz")
    return FusedHybridSearch(trie, vi, cols, ann_mode=mode, flat_escalate_eps=eps)


def _jax(art, mode, eps=0.0):
    return JaxFused(art["trie"], art["vi"], art["cols"], ann_mode=mode, flat_escalate_eps=eps)


def _query(fused, art, rt, force=None, n=None):
    if force is not None:
        fused._layout_brute_batch = lambda batch: force
    n = n or len(art["texts"])
    return fused.query_batch(
        art["q"][:n], art["texts"][:n], art["courts"][:n], art["dates"][:n],
        art["min_sim"][:n], art["ew"][:n], k=K, overfetch=4, recall_target=rt,
    )


def _assert_same(got, want, bitwise_scores=False):
    tv, ti, tc, ts = got
    jv, ji, jc, js = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)
    if bitwise_scores:
        np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    else:
        np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    assert (tc >= 0).any(), "the slice served nothing"


@pytest.fixture()
def jax_scan_kernel(monkeypatch):
    """The JAX package's fused-scan kernel branch on the CPU, in interpret
    mode; JAX's caches are cleared on both sides of the patch."""
    jax.clear_caches()
    monkeypatch.setattr(
        jax_hybrid, "_use_pallas", lambda n, rt: rt < 1.0 and n % 2048 == 0
    )
    monkeypatch.setattr(
        jax_hybrid, "pallas_fused_topk", functools.partial(pallas_fused_topk, interpret=True)
    )
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("mode,force", [
    ("brute", None), ("partitioned", True), ("partitioned", False),
])
def test_slice_exact_modes(art, mode, force, monkeypatch):
    """recall_target=1.0: brute, stream and probe (gather branch), no kernels."""
    monkeypatch.delenv("TSS_PROBE_INTERPRET", raising=False)
    scan_kernels.reset_launch_counts()
    got = _query(_port(art, mode), art, 1.0, force)
    want = _query(_jax(art, mode), art, 1.0, force)
    _assert_same(got, want, bitwise_scores=mode == "brute")


@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_slice_probe_kernel_branch(art, eps, monkeypatch):
    """recall_target=0.97 in the probe: probe + rescore kernel branch, with
    and without flat-boundary escalation through the stream."""
    monkeypatch.setenv("TSS_PROBE_INTERPRET", "1")
    port, ref = _port(art, "partitioned", eps), _jax(art, "partitioned", eps)
    _assert_same(_query(port, art, 0.97, False), _query(ref, art, 0.97, False))
    assert port.escalated == ref.escalated


@pytest.mark.parametrize("mode,force", [("brute", None), ("partitioned", True)])
def test_slice_scan_kernel_branch(art, mode, force, jax_scan_kernel, monkeypatch):
    """recall_target=0.97 in brute and stream: the fused-scan kernel branch
    (the stream with the rescore kernel branch too)."""
    monkeypatch.setenv("TSS_PROBE_INTERPRET", "1")
    got = _query(_port(art, mode), art, 0.97, force)
    want = _query(_jax(art, mode), art, 0.97, force)
    _assert_same(got, want, bitwise_scores=mode == "brute")


@pytest.mark.parametrize("n,stream", [(1, False), (7, True)])
def test_slice_auto_mode_pick(art, n, stream, monkeypatch):
    """The break-even rule picks the same stage on both sides (P=16,
    nprobe=3: one query probes, a bucket of 8 streams)."""
    monkeypatch.delenv("TSS_PROBE_INTERPRET", raising=False)
    port, ref = _port(art, "auto"), _jax(art, "auto")
    assert port.ann_mode == ref.ann_mode == "brute"  # below PARTITIONED_MIN_VECTORS
    port, ref = _port(art, "partitioned"), _jax(art, "partitioned")
    from trie_semantic_search_tpu_torch.utils import batch_bucket

    assert port._layout_brute_batch(batch_bucket(n)) is stream
    assert ref._layout_brute_batch(batch_bucket(n)) is stream
    _assert_same(_query(port, art, 1.0, n=n), _query(ref, art, 1.0, n=n))


def test_slice_loads_directory_artifact(art, monkeypatch):
    """The raw-.npy ANN directory (uint16 bf16 bit views) serves the same
    results as the .npz artifact."""
    monkeypatch.delenv("TSS_PROBE_INTERPRET", raising=False)
    a = _query(_port(art, "partitioned", vec="vec_dir"), art, 1.0, False)
    b = _query(_port(art, "partitioned"), art, 1.0, False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    port = _port(art, "partitioned", vec="vec_dir")
    assert port.vector_index.ann._replicated
    assert port.vector_index.ann.default_nprobe == 3


@pytest.mark.parametrize("forced", [False, True])
def test_ann_search_matches_jax(art, forced, monkeypatch):
    """The staged ANN search (probe → int8 scan → bf16 rescore) and the
    exact bf16 scan, loaded from the JAX package's artifact: same rows,
    scores within 1e-5; ``forced`` walks the probe/rescore kernel branch."""
    if forced:
        monkeypatch.setenv("TSS_PROBE_INTERPRET", "1")
    else:
        monkeypatch.delenv("TSS_PROBE_INTERPRET", raising=False)
    jann = art["vi"].ann
    jann._search_fn = jann._brute_fn = None
    vi = VectorIndex(embedder=Embedder(model=MiniLM(MiniLMConfig(**TINY), device="cpu"),
                                       device="cpu"), device="cpu")
    vi.load(art["root"] / "vec")
    q = art["q"]
    for k in (5, 12):
        jv, ji = jann.search(q, k)
        tv, ti = vi.ann.search(q, k)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=0)
        jv, ji = jann.search_brute(q, k)
        tv, ti = vi.ann.search_brute(q, k)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5, rtol=0)
    st = vi.ann.get_stats()
    assert st.num_vectors == jann.num_vectors and st.partition_capacity == M
    texts = art["texts"][:3]
    e1 = vi.generate_embeddings(texts)
    hits = vi.cache.get_stats().hits
    e2 = vi.generate_embeddings(texts[::-1])
    assert e1.shape == (3, D) and vi.cache.get_stats().hits == hits + 3
    np.testing.assert_array_equal(e2, e1[::-1])


def test_break_even_rule_matches_jax(art):
    """``B·nprobe >= P·ceil(B/TILE_B)`` on both sides, equality included."""
    port, ref = _port(art, "partitioned"), _jax(art, "partitioned")
    saved = ref.ann.tuned_nprobe
    try:
        for nprobe in (1, 2, 3, 16):
            port.ann.tuned_nprobe = ref.ann.tuned_nprobe = nprobe
            for b in range(1, 530):
                assert port._layout_brute_batch(b) == ref._layout_brute_batch(b), (nprobe, b)
    finally:
        ref.ann.tuned_nprobe = saved
