"""The port's corpus-scale streaming build against the JAX package's, on the CPU.

``PartitionedANN.build_streaming`` (in RAM, into a memmap emit directory,
host-deferred until the first search) from fixed centroids is held bitwise
against the port's ``build`` and the JAX package's ``build_streaming``, its
emit files byte for byte against the JAX package's, and each package loads
the other's adopted directory. ``StreamingIndexBuilder`` runs over the
same cases in both packages' stores with the JAX encoder's parameters in
f32 compute on both sides: report, manifest, tries and refs equal, vectors
within 1e-5, the same vector-directory files; a build killed after its
second checkpoint resumes to the uninterrupted result without embedding a
finished chunk again.

Sizes stay small (D = 32, N ≤ 3,000, ≤ 64 cases).
"""

import json
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_build import (  # noqa: F401  (f32_jax_encoder is a fixture)
    _assert_same_layout,
    _cases,
    _clustered,
    _configs,
    _encoders,
    _normed,
    _write_store,
    f32_jax_encoder,
    TINY,
)

import trie_semantic_search_tpu.index.kmeans as jk
import trie_semantic_search_tpu.index.vector as jvec
from trie_semantic_search_tpu.core.config import AnnConfig as JaxAnnConfig
from trie_semantic_search_tpu.core.types import CaseMetadata as JaxCaseMetadata
from trie_semantic_search_tpu.index import ann as ja
from trie_semantic_search_tpu.index.builder import load_artifacts as jax_load_artifacts
from trie_semantic_search_tpu.index.streaming import StreamingIndexBuilder as JaxStreamingBuilder
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu_torch.core.config import AnnConfig
from trie_semantic_search_tpu_torch.core.types import CaseMetadata
from trie_semantic_search_tpu_torch.index import ann as ta
from trie_semantic_search_tpu_torch.index import vector as tvec
from trie_semantic_search_tpu_torch.index.builder import load_artifacts
from trie_semantic_search_tpu_torch.index.streaming import StreamingIndexBuilder, _Manifest
from trie_semantic_search_tpu_torch.models.embedder import Embedder
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer
from trie_semantic_search_tpu_torch.storage.store import StorageManager

torch.set_num_threads(1)


# -- PartitionedANN.build_streaming ------------------------------------------------------


@pytest.fixture(scope="module")
def stream_input(tmp_path_factory):
    """3,000 clustered rows (5% duplicates, one non-finite row) saved as
    ``.npy`` and memmapped, with fixed centroids trained on them."""
    root = tmp_path_factory.mktemp("stream_input")
    _, v = _clustered(21, 16, np.random.default_rng(21).integers(80, 300, 16), dup=0.05)
    v = v[:3000]
    v[7] = np.inf
    np.save(root / "v.npy", v)
    fixed = jk.train_kmeans(_normed(np.nan_to_num(v, posinf=0.0)), 16, seed=3)
    return np.load(root / "v.npy", mmap_mode="r"), fixed


def _emit_bits(ann):
    """The frozen arrays of an index on the host (device tensors or memmaps)."""
    out = {"part_rows": ta._host(ann.part_rows), "part_int8": ta._host(ann.part_int8),
           "part_scale": ta._host(ann.part_scale).view(np.int32)}
    for i, s in enumerate(ann.corpus_bf16):
        out[f"rescore_{i}"] = ta._bf16_host_bits(s)
    return out


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("replicas", [True, False])
@pytest.mark.parametrize("overalloc", [2.0, 0.3])
def test_build_streaming_matches_build_and_jax(stream_input, tmp_path, emit, replicas, overalloc):
    """Uneven 777-row slabs, in RAM or into an emit directory, pad
    replicas on and off, the overflow rebalance on (overalloc 0.3): the
    port's streamed layout is bitwise its ``build`` and the JAX package's
    ``build_streaming``."""
    mm, fixed = stream_input
    kw = dict(pad_replicas=replicas, partition_overalloc=overalloc)
    whole = ta.PartitionedANN(AnnConfig(**kw), device="cpu")
    whole.build(np.asarray(mm), reuse_centroids=fixed)
    port = ta.PartitionedANN(AnnConfig(**kw), device="cpu")
    port.build_streaming(mm, slab_rows=777, reuse_centroids=fixed,
                         emit_dir=tmp_path / "emit" if emit else None)
    jax_ann = ja.PartitionedANN(JaxAnnConfig(**kw))
    jax_ann.build_streaming(mm, slab_rows=777, reuse_centroids=fixed,
                            emit_dir=tmp_path / "jemit" if emit else None)
    _assert_same_layout(port, jax_ann)
    got, want = _emit_bits(port), _emit_bits(whole)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port._replicated == whole._replicated == replicas
    assert set(port.build_seconds) == {"kmeans", "assign", "rebalance", "fill", "replicas", "upload"}
    if overalloc < 1:
        assert int(np.bincount(ta._host(port.part_rows)[ta._host(port.part_rows) >= 0]).max()) < 3000


def test_build_streaming_bf16_blocks_take_build(stream_input):
    """``quantize_int8=False`` builds through ``build``, as in the JAX package."""
    mm, fixed = stream_input
    port = ta.PartitionedANN(AnnConfig(quantize_int8=False), device="cpu")
    port.build_streaming(mm, reuse_centroids=fixed, emit_dir=None)
    jax_ann = ja.PartitionedANN(JaxAnnConfig(quantize_int8=False))
    jax_ann.build_streaming(mm, reuse_centroids=fixed)
    _assert_same_layout(port, jax_ann)
    assert port.part_int8.dtype == torch.bfloat16 and port._emit_dir is None


def test_build_streaming_trains_like_jax(stream_input):
    """Without centroids both packages train k-means on the same sample
    (within 1e-5) and lay out the same partitions."""
    mm, _ = stream_input
    cfg = dict(num_partitions=16, kmeans_sample=1000)
    port = ta.PartitionedANN(AnnConfig(**cfg), device="cpu")
    port.build_streaming(mm, seed=5, slab_rows=1000)
    jax_ann = ja.PartitionedANN(JaxAnnConfig(**cfg))
    jax_ann.build_streaming(mm, seed=5, slab_rows=1000)
    np.testing.assert_allclose(port.centroids.numpy(), np.asarray(jax_ann.centroids), atol=1e-5)
    np.testing.assert_array_equal(port.part_rows.numpy(), np.asarray(jax_ann.part_rows))


@pytest.fixture()
def emitted(stream_input, tmp_path):
    """The port's and the JAX package's emit builds (host-deferred on the
    port's side) from the same centroids, tuned nprobe 3 on both."""
    mm, fixed = stream_input
    port = ta.PartitionedANN(AnnConfig(), device="cpu")
    port.build_streaming(mm, slab_rows=1000, reuse_centroids=fixed,
                         emit_dir=tmp_path / "port" / "ann.mmap.emit", device_resident=False)
    jax_ann = ja.PartitionedANN(JaxAnnConfig())
    jax_ann.build_streaming(mm, slab_rows=1000, reuse_centroids=fixed,
                            emit_dir=tmp_path / "jax" / "ann.mmap.emit", device_resident=False)
    port.tuned_nprobe = jax_ann.tuned_nprobe = 3
    return port, jax_ann, tmp_path


def test_adopted_emit_files_equal_jax_and_load_across(emitted):
    """``save_dir`` adopts the emit directory by a rename (the arrays'
    files keep their inodes); every file equals the JAX package's byte
    for byte; each package's ``load_dir`` reads the other's directory."""
    port, jax_ann, root = emitted
    inodes = {f.name: f.stat().st_ino for f in (root / "port" / "ann.mmap.emit").iterdir()}
    port.save_dir(root / "port" / "ann.mmap")
    jax_ann.save_dir(root / "jax" / "ann.mmap")
    for d in ("port", "jax"):
        assert not (root / d / "ann.mmap.emit").exists()
    pdir, jdir = root / "port" / "ann.mmap", root / "jax" / "ann.mmap"
    names = sorted(f.name for f in pdir.iterdir())
    assert names == sorted(f.name for f in jdir.iterdir())
    assert names == ["centroids.npy", "meta.json", "part_int8.npy", "part_rows.npy",
                     "part_scale.npy", "rescore_0.npy"]
    for n in names:
        assert (pdir / n).read_bytes() == (jdir / n).read_bytes(), n
        if n in inodes:
            assert (pdir / n).stat().st_ino == inodes[n], n
    assert json.loads((pdir / "meta.json").read_text())["num_probes"] == 3
    _assert_same_layout(ta.PartitionedANN.load_dir(jdir, device="cpu"), ja.PartitionedANN.load_dir(pdir))
    _assert_same_layout(ta.PartitionedANN.load_dir(pdir, device="cpu"), jax_ann)


def test_host_deferred_index_promotes_at_first_search(emitted, stream_input):
    """Before its first search a host-deferred index holds memmaps and no
    tensor, and reports the eager index's stats; the first search copies
    them over and returns what the eager index returns."""
    port, _, root = emitted
    mm, fixed = stream_input
    eager = ta.PartitionedANN(AnnConfig(), device="cpu")
    eager.build_streaming(mm, slab_rows=1000, reuse_centroids=fixed)
    eager.tuned_nprobe = 3
    frozen = (port.centroids, port.part_rows, port.part_int8, port.part_scale, *port.corpus_bf16)
    assert port._host_deferred and not any(isinstance(a, torch.Tensor) for a in frozen)
    assert all(isinstance(a, np.memmap) for a in frozen[1:])
    assert port.get_stats() == eager.get_stats()
    assert port.search_route(8, 3) == eager.search_route(8, 3)
    q = np.asarray(mm[::301], np.float32) + 0.01
    got = port.search(q, 10)
    assert not port._host_deferred and isinstance(port.part_int8, torch.Tensor)
    assert port.promote_seconds > 0
    want = eager.search(q, 10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(port.search_brute(q, 5)[1], eager.search_brute(q, 5)[1])
    _assert_same_layout(port, _jax_like(eager))


def _jax_like(port):
    """A JAX index holding a port index's arrays (to reuse the layout check)."""
    j = ja.PartitionedANN(JaxAnnConfig())
    j.centroids = port.centroids.numpy()
    j.part_rows, j.part_int8, j.part_scale = (port.part_rows.numpy(), port.part_int8.numpy(),
                                              port.part_scale.numpy())
    j.corpus_bf16 = tuple(s.view(torch.int16).numpy().view(np.uint16) for s in port.corpus_bf16)
    j._replicated, j.num_vectors = port._replicated, port.num_vectors
    return j


@pytest.mark.parametrize("large", [False, True])
def test_vector_save_of_an_emit_build_matches_jax(emitted, stream_input, monkeypatch, large):
    """``VectorIndex.save`` after a host-deferred emit build: a small index
    writes ``ann.npz`` from the memmaps and removes the emit directory, a
    large one (the threshold lowered) renames it to ``ann.mmap``; either
    way the vector directory holds the JAX package's files, and the saved
    ANN loads in the JAX package with the JAX layout."""
    port, jax_ann, root = emitted
    mm, _ = stream_input
    if large:
        monkeypatch.setattr(tvec, "_ANN_MMAP_SAVE_BYTES", 1024)
        monkeypatch.setattr(jvec, "_ANN_MMAP_SAVE_BYTES", 1024)
    refs = np.stack([np.arange(len(mm)) // 4, np.arange(len(mm)) % 4], 1).astype(np.int32)
    files = {}
    for tag, ann, vi in (("port", port, tvec.VectorIndex(device="cpu", embedder=_stub_embedder())),
                         ("jax", jax_ann, jvec.VectorIndex(embedder=_jax_stub_embedder()))):
        vi._vectors, vi._refs, vi.ann = mm, refs, ann
        vi.save(root / tag)
        files[tag] = sorted(str(p.relative_to(root / tag)) for p in (root / tag).rglob("*"))
    assert files["port"] == files["jax"]
    assert ("ann.mmap/part_int8.npy" in files["port"]) == large
    assert ("ann.npz" in files["port"]) == (not large)
    assert not (root / "port" / "ann.mmap.emit").exists()
    loaded = (ja.PartitionedANN.load_dir(root / "port" / "ann.mmap") if large
              else ja.PartitionedANN.load(root / "port" / "ann.npz"))
    _assert_same_layout(ta.PartitionedANN.load_dir(root / "jax" / "ann.mmap", device="cpu") if large
                        else ta.PartitionedANN.load(root / "jax" / "ann.npz", device="cpu"), loaded)


def _stub_embedder():
    from trie_semantic_search_tpu_torch.models import minilm as tm

    cfg = tm.MiniLMConfig(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                          intermediate_size=32, max_position=16)
    return Embedder(model=tm.MiniLM(cfg, device="cpu"), device="cpu")


def _jax_stub_embedder():
    import trie_semantic_search_tpu.models.minilm as jm

    return JaxEmbedder(model_config=jm.MiniLMConfig(vocab_size=128, hidden_size=32, num_layers=1,
                                                    num_heads=2, intermediate_size=32,
                                                    max_position=16))


def test_stale_emit_dir_is_replaced(stream_input, tmp_path):
    """A stale emit directory (a killed run's, another segment count) is
    cleared before the emit; the adopted artifact has one segment."""
    mm, fixed = stream_input
    emit = tmp_path / "emit"
    emit.mkdir()
    (emit / "rescore_7.npy").write_bytes(b"garbage")
    port = ta.PartitionedANN(AnnConfig(), device="cpu")
    port.build_streaming(mm, reuse_centroids=fixed, emit_dir=emit)
    assert isinstance(port.part_int8, torch.Tensor) and not port._host_deferred
    port.save_dir(tmp_path / "ann.mmap")
    assert json.loads((tmp_path / "ann.mmap" / "meta.json").read_text())["rescore_segments"] == 1
    assert not (tmp_path / "ann.mmap" / "rescore_7.npy").exists()
    port.save_dir(tmp_path / "ann2.mmap")  # no emit pending: the tmp + rename path
    _assert_same_layout(ta.PartitionedANN.load_dir(tmp_path / "ann2.mmap", device="cpu"),
                        ja.PartitionedANN.load_dir(tmp_path / "ann.mmap"))


# -- StreamingIndexBuilder -------------------------------------------------------------


def _stores_and_encoders(tmp_path, n_cases, tag="s"):
    """Both packages' stores of the same cases, configs (quality gate off,
    pooling mean, P=8) and encoders: the JAX parameters in the port's
    model, both in f32 compute."""
    cases = _cases(n_cases)
    jcfg, pcfg = _configs(tmp_path, tag)
    pcfg.storage.db_path = str(tmp_path / f"{tag}_port.sqlite")
    jstore = _write_store(JaxStorage, JaxCaseMetadata, jcfg.storage.db_path, cases)
    pstore = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases)
    vocab, params, mcfg, model = _encoders(cases)
    model.compute_dtype = torch.float32
    jemb = JaxEmbedder(jcfg.vector.model, tokenizer=JaxTokenizer(vocab), params=params, model_config=mcfg)
    pemb = Embedder(pcfg.vector.model, tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu")
    return cases, (jcfg, jstore, jemb), (pcfg, pstore, pemb)


def _trie_bits(trie):
    return {(name, f): np.array(getattr(getattr(trie, name), f))
            for name in ("name_trie", "content_trie", "citation_trie")
            for f in getattr(trie, name)._ARRAY_FIELDS}


def _assert_same_tries(got, want):
    for name in ("name_trie", "content_trie", "citation_trie"):
        assert getattr(got, name).vocab == getattr(want, name).vocab, name
    g, w = _trie_bits(got), _trie_bits(want)
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=str(key))


def _files(d: Path) -> list[str]:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


@pytest.mark.parametrize("windowing", ["all", "phrase_start"])
def test_streaming_builder_matches_jax(tmp_path, f32_jax_encoder, windowing):
    """The same 48 cases through both packages' ``StreamingIndexBuilder``
    (shards of 32 chunks, content spill on, tuning off): the report's
    counts, shards and the manifest equal; the three tries bitwise, with
    the spilled content trie; refs equal, vectors within 1e-5; the port's
    ANN rebuilt over the JAX vectors from the JAX centroids is the JAX
    layout; the vector directories hold the same files. The port's
    artifacts load in the JAX package."""
    _, (jcfg, jstore, jemb), (pcfg, pstore, pemb) = _stores_and_encoders(tmp_path, 48)
    for c in (jcfg, pcfg):
        c.trie.content_windowing = windowing
        c.vector.hnsw.tune_on_build = False
    jb = JaxStreamingBuilder(jstore, jcfg, embedder=jemb, work_dir=tmp_path / "jwork",
                             shard_chunks=32).build()
    pb = StreamingIndexBuilder(pstore, pcfg, embedder=pemb, work_dir=tmp_path / "pwork",
                               shard_chunks=32, device="cpu").build()
    jr, pr = jb.report, pb.report
    assert (pr.cases, pr.content_chunks, pr.citations, pr.shards, pr.resumed_from_row) == (
        jr.cases, jr.content_chunks, jr.citations, jr.shards, jr.resumed_from_row)
    assert pr.shards >= 3 and pr.embedded_chunks == pr.content_chunks
    assert pr.chunks_per_second > 0 and pr.peak_rss_bytes > 0 and pr.peak_anon_rss_bytes > 0
    assert set(pr.finalize_seconds) == {"run_sort", "merge", "csr", "store_fill", "ann"}
    assert (_Manifest.load(tmp_path / "pwork" / "manifest.json").__dict__
            == json.loads((tmp_path / "jwork" / "manifest.json").read_text()))
    _assert_same_tries(pb.trie, jb.trie)
    np.testing.assert_array_equal(np.asarray(pb.vector.refs), np.asarray(jb.vector.refs))
    np.testing.assert_allclose(np.asarray(pb.vector.vectors), np.asarray(jb.vector.vectors),
                               atol=1e-5, rtol=0)
    rebuilt = ta.PartitionedANN(pcfg.vector.hnsw, device="cpu")
    rebuilt.build_streaming(np.asarray(jb.vector.vectors),
                            reuse_centroids=np.asarray(jb.vector.ann.centroids))
    _assert_same_layout(rebuilt, jb.vector.ann)
    assert _files(Path(pcfg.vector.hnsw.index_path)) == _files(Path(jcfg.vector.hnsw.index_path))
    assert _files(tmp_path / "pwork") == _files(tmp_path / "jwork")
    jcfg.trie.index_path, jcfg.vector.hnsw.index_path = pcfg.trie.index_path, pcfg.vector.hnsw.index_path
    trie, vector, cols = jax_load_artifacts(jcfg, embedder=jemb)
    _assert_same_tries(trie, pb.trie)
    np.testing.assert_array_equal(np.asarray(vector.refs), np.asarray(pb.vector.refs))
    jstore.close()
    pstore.close()


def test_streaming_resume_after_crash(tmp_path, f32_jax_encoder):
    """A build that dies after its second checkpoint, resumed by a new
    builder, gives the uninterrupted build's tries, refs and vectors, and
    embeds only the chunks after the watermark."""
    _, _, (pcfg, pstore, pemb) = _stores_and_encoders(tmp_path, 48)
    pcfg.vector.hnsw.tune_on_build = False
    clean = StreamingIndexBuilder(pstore, pcfg, embedder=pemb, work_dir=tmp_path / "clean",
                                  shard_chunks=32, device="cpu").build()
    embedded = []
    real_embed = pemb.embed
    pemb.embed = lambda texts: embedded.append(len(texts)) or real_embed(texts)
    sb = StreamingIndexBuilder(pstore, pcfg, embedder=pemb, work_dir=tmp_path / "work",
                               shard_chunks=32, device="cpu")
    real_ckpt, count = sb._checkpoint, [0]

    def crashing(manifest, trie, next_row):
        real_ckpt(manifest, trie, next_row)
        count[0] += 1
        if count[0] == 2:
            raise KeyboardInterrupt("simulated crash")

    sb._checkpoint = crashing
    with pytest.raises(KeyboardInterrupt):
        sb.build()
    done = _Manifest.load(tmp_path / "work" / "manifest.json")
    assert len(done.shards) == 2 and done.next_row > 0
    assert [p.name for p in (tmp_path / "work").glob("trie_ckpt_*")] == [done.trie_ckpt]
    before = sum(embedded)
    built = StreamingIndexBuilder(pstore, pcfg, embedder=pemb, work_dir=tmp_path / "work",
                                  shard_chunks=32, device="cpu").build(resume=True)
    r = built.report
    assert r.resumed_from_row == done.next_row and r.cases == clean.report.cases
    assert r.embedded_chunks == sum(embedded) - before == clean.report.content_chunks - done.chunks
    _assert_same_tries(built.trie, clean.trie)
    np.testing.assert_array_equal(np.asarray(built.vector.refs), np.asarray(clean.vector.refs))
    np.testing.assert_array_equal(np.asarray(built.vector.vectors), np.asarray(clean.vector.vectors))
    pstore.close()


@pytest.mark.parametrize("tune", [True, False])
def test_tune_on_build_persists_jax_nprobe(tmp_path, f32_jax_encoder, tune):
    """64 cases (past the 100-vector gate), both builders embedding with the
    JAX encoder's vectors: k-means within 1e-5 and the same partitions;
    with ``tune_on_build`` the saved artifact keeps the JAX package's
    nprobe; without it none is saved."""
    _, (jcfg, jstore, jemb), (pcfg, pstore, pemb) = _stores_and_encoders(tmp_path, 64)
    from trie_semantic_search_tpu_torch.models.embedder import EmbeddingResult

    pemb.embed = lambda texts: EmbeddingResult(np.asarray(jemb.embed(list(texts)).embedding, np.float32), 0.0)
    for c in (jcfg, pcfg):
        c.vector.hnsw.tune_on_build = tune
        c.vector.hnsw.num_probes = 0
    jb = JaxStreamingBuilder(jstore, jcfg, embedder=jemb, work_dir=tmp_path / "jwork",
                             shard_chunks=64).build()
    pb = StreamingIndexBuilder(pstore, pcfg, embedder=pemb, work_dir=tmp_path / "pwork",
                               shard_chunks=64, device="cpu").build()
    assert pb.vector.ann.num_vectors >= 100
    np.testing.assert_array_equal(np.asarray(pb.vector.vectors), np.asarray(jb.vector.vectors))
    np.testing.assert_allclose(ta._host(pb.vector.ann.centroids), np.asarray(jb.vector.ann.centroids),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ta._host(pb.vector.ann.part_rows), np.asarray(jb.vector.ann.part_rows))
    assert pb.vector.ann.tuned_nprobe == jb.vector.ann.tuned_nprobe
    assert (pb.vector.ann.tuned_nprobe > 0) == tune and ("tune" in pb.report.finalize_seconds) == tune
    _, vector, _ = load_artifacts(pcfg, embedder=pemb, device="cpu")
    assert vector.ann.tuned_nprobe == pb.vector.ann.tuned_nprobe
    jstore.close()
    pstore.close()


def _tiny_encoders(monkeypatch, with_jax: bool = False):
    """The streaming builders' ``Embedder`` at TINY width over the corpus
    vocab (they make theirs from ``vector.model``, full width): the port's,
    and the JAX package's too with ``with_jax``."""
    import trie_semantic_search_tpu.index.streaming as jstreaming
    import trie_semantic_search_tpu.models.minilm as jm
    import trie_semantic_search_tpu_torch.index.streaming as tstreaming
    import trie_semantic_search_tpu_torch.models.minilm as tm

    def geometry(cls, tokenizer):
        return cls(**dict(TINY, vocab_size=max(len(tokenizer), 128)))

    monkeypatch.setattr(tstreaming, "Embedder", lambda cfg, tokenizer, device: Embedder(
        cfg, tokenizer=tokenizer, device=device, model_config=geometry(tm.MiniLMConfig, tokenizer)))
    if with_jax:
        monkeypatch.setattr(jstreaming, "Embedder", lambda cfg, tokenizer: JaxEmbedder(
            cfg, tokenizer=tokenizer, model_config=geometry(jm.MiniLMConfig, tokenizer)))


def _recording(monkeypatch, mod, calls: list):
    """Wrap ``mod.pretrain_encoder_guarded``: each call's docs, arguments
    and report go to ``calls``."""
    fn = mod.pretrain_encoder_guarded

    def wrapped(embedder, docs, **kw):
        rep = fn(embedder, docs, **kw)
        calls.append((docs, kw, rep))
        return rep

    monkeypatch.setattr(mod, "pretrain_encoder_guarded", wrapped)


def _sha256s(d: Path) -> dict[str, str]:
    import hashlib

    return {str(f.relative_to(d)): hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(d.rglob("*")) if f.is_file()}


def test_fresh_store_pretraining_matches_jax(tmp_path, monkeypatch):
    """No saved encoder, both builders at TINY width with 3 pretraining
    steps: the docs handed to ``pretrain_encoder_guarded`` (the first cases
    by rowid, their sentences) and its arguments equal the JAX package's,
    and the reports carry the same keys and pairs."""
    import trie_semantic_search_tpu.models.train as jtrain
    import trie_semantic_search_tpu_torch.models.train as ttrain

    cases = _cases(30)
    jcfg, pcfg = _configs(tmp_path, "f")
    pcfg.vector.hnsw.index_path = str(tmp_path / "f_port" / "vec")
    jstore = _write_store(JaxStorage, JaxCaseMetadata, jcfg.storage.db_path, cases)
    pcfg.storage.db_path = str(tmp_path / "f_port.sqlite")
    pstore = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases)
    _tiny_encoders(monkeypatch, with_jax=True)
    jcalls, pcalls = [], []
    _recording(monkeypatch, jtrain, jcalls)
    _recording(monkeypatch, ttrain, pcalls)
    JaxStreamingBuilder(jstore, jcfg, work_dir=tmp_path / "jw", pretrain_steps=3, pretrain_sample_cases=20)
    StreamingIndexBuilder(pstore, pcfg, work_dir=tmp_path / "pw", pretrain_steps=3, pretrain_sample_cases=20,
                          device="cpu")
    (jdocs, jkw, jrep), = jcalls
    (pdocs, pkw, prep), = pcalls
    assert pdocs == jdocs and len(pdocs) == 20 and pkw == jkw == {"steps": 3, "max_len": 64}
    assert sorted(prep) == sorted(jrep) and prep["pairs"] == jrep["pairs"] and prep["steps"] == 3
    assert sorted(prep["guardrail"]) == sorted(jrep["guardrail"])
    for c in (jcfg, pcfg):
        assert (Path(c.vector.hnsw.index_path) / "encoder" / "step_0" / "params.npz").exists()
    jstore.close()
    pstore.close()


def test_fresh_store_streaming_build_pretrains_once_and_resumes(tmp_path, monkeypatch):
    """The operator's first build over a fresh store at TINY width: the
    builder pretrains (the default 300 steps cut to 4), saves the encoder
    before the first shard, and is interrupted after 2 shards; the resumed
    build loads that encoder (no second pretraining, the encoder files'
    bytes unchanged), embeds only the chunks after the watermark, and its
    artifacts serve a case name."""
    import trie_semantic_search_tpu_torch.models.train as ttrain
    from trie_semantic_search_tpu_torch.core.types import SearchConfig
    from trie_semantic_search_tpu_torch.search.engine import SearchEngine, SearchQuery

    cases = _cases(40)
    _, pcfg = _configs(tmp_path, "o")
    pcfg.vector.hnsw.tune_on_build = False
    store = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases)
    vec_dir = Path(pcfg.vector.hnsw.index_path)
    _tiny_encoders(monkeypatch)
    calls = []
    _recording(monkeypatch, ttrain, calls)

    first = StreamingIndexBuilder(store, pcfg, work_dir=tmp_path / "work", shard_chunks=24,
                                  pretrain_steps=4, device="cpu")
    assert len(calls) == 1 and calls[0][2]["steps"] == 4 and "guardrail" in calls[0][2]
    saved = _sha256s(vec_dir)
    assert "encoder/step_0/params.npz" in saved and "tokenizer.json" in saved
    assert not (tmp_path / "work").exists()  # the encoder is saved before any shard
    checkpoint, count = first._checkpoint, [0]

    def crashing(manifest, trie, next_row):
        checkpoint(manifest, trie, next_row)
        count[0] += 1
        if count[0] == 2:
            raise KeyboardInterrupt("simulated kill")

    first._checkpoint = crashing
    with pytest.raises(KeyboardInterrupt):
        first.build()
    done = _Manifest.load(tmp_path / "work" / "manifest.json")
    assert len(done.shards) == 2 and done.next_row > 0

    second = StreamingIndexBuilder(store, pcfg, work_dir=tmp_path / "work", shard_chunks=24,
                                   pretrain_steps=4, device="cpu")
    assert len(calls) == 1  # loaded, not trained again
    for (k, a), (_, b) in zip(first.embedder.model.leaves(), second.embedder.model.leaves()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    embedded = []
    write = second._write_shard

    def counted(manifest, texts, refs):
        embedded.append(len(texts))
        write(manifest, texts, refs)

    second._write_shard = counted
    built = second.build(resume=True)
    r = built.report
    assert r.resumed_from_row == done.next_row and r.cases == len(cases)
    assert sum(embedded) == r.embedded_chunks == r.content_chunks - done.chunks > 0
    after = _sha256s(vec_dir)
    assert {k: after[k] for k in saved} == saved
    store.close()

    engine = SearchEngine(pcfg, StorageManager(pcfg.storage), *load_artifacts(pcfg, device="cpu"), device="cpu")
    name = cases[7][0]
    res = engine.search_batch([SearchQuery(query=name.lower(), config=SearchConfig(min_similarity=-1.0)),
                               SearchQuery(query="contract breach damages",
                                           config=SearchConfig(min_similarity=-1.0))])
    assert res[0][0].case_metadata.name == name and res[0][0].match_type.value in ("case_name", "exact")
    assert res[1]
    engine.storage.close()


def test_new_encoder_without_pretraining_is_saved_and_reused(tmp_path):
    """``pretrain_steps=0`` with no saved encoder: a corpus vocab, the
    pooling picked (``"auto"``), the encoder saved; a second builder loads
    that encoder and embeds the same vectors."""
    _, pcfg = _configs(tmp_path, "n")
    pcfg.vector.pooling = "auto"
    pcfg.vector.hnsw.tune_on_build = False
    store = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, _cases(12))
    first = StreamingIndexBuilder(store, pcfg, work_dir=tmp_path / "w1", pretrain_steps=0, device="cpu")
    assert (Path(pcfg.vector.hnsw.index_path) / "tokenizer.json").exists()
    second = StreamingIndexBuilder(store, pcfg, work_dir=tmp_path / "w2", device="cpu")
    texts = ["contract breach damages in matter 3 part 1.", "equal protection"]
    np.testing.assert_array_equal(first.embedder.embed(texts).embedding,
                                  second.embedder.embed(texts).embedding)
    assert (first.embedder.token_weights is None) == (second.embedder.token_weights is None)
    built = second.build()
    assert built.report.cases == 12 and built.vector.ann.num_vectors == built.report.content_chunks
    store.close()


def test_row_ids_follow_the_store_order(tmp_path, f32_jax_encoder):
    """Case ids in another order than the rows: the streaming build's refs
    and name postings use the dense row order, as the one-shot build's."""
    from trie_semantic_search_tpu_torch.index.builder import build_indexes

    _, _, (pcfg, pstore, pemb) = _stores_and_encoders(tmp_path, 20)
    pcfg.vector.hnsw.tune_on_build = False
    one = build_indexes(pstore, pcfg, embedder=pemb, device="cpu")
    built = StreamingIndexBuilder(pstore, pcfg, embedder=pemb, work_dir=tmp_path / "w",
                                  shard_chunks=16, device="cpu").build()
    np.testing.assert_array_equal(np.asarray(built.vector.refs), np.asarray(one.vector.refs, np.int32))
    _assert_same_tries(built.trie, one.trie)
    np.testing.assert_allclose(np.asarray(built.vector.vectors), one.vector.vectors, atol=1e-5, rtol=0)
    ids = [str(c) for c in built.columns.case_ids]
    assert ids != sorted(ids) and ids == [str(uuid.UUID(int=(i * 7919) % 1000 + 1)) for i in range(20)]
    pstore.close()
