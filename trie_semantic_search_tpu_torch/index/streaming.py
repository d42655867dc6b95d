"""Streaming, checkpointed, corpus-scale index build.

Port of ``trie_semantic_search_tpu/index/streaming.py``.
:func:`.builder.build_indexes` builds in one pass and loses everything when
it is interrupted; this builder is the corpus-scale path:

* **store → tokenize → bucketed encode → shard**: cases stream from sqlite
  in rowid order (the dense device row order); chunk texts wait only until
  a shard's worth is embedded in one bucketed encode and written as
  ``shard_XXXXX_{emb,refs}.npy``, so host memory stays bounded at any
  corpus size.
* **checkpointed and resumable**: after every shard the tries are frozen
  into a new checkpoint directory, then the manifest records the
  watermark row, then the old checkpoint goes; at every instant the
  manifest names a complete checkpoint. A killed build resumes from the
  manifest: the tries reload (their builders rehydrate at the first
  insert), finished shards are kept and the store restarts at the
  watermark, with no chunk embedded twice.
* **content spill** (:mod:`.spill`): content windows go to disk and are
  sorted into the content trie at the end, with no resident node pool.
* **finalize**: the shards fill one disk-backed vector store; the ANN
  builds from it slab by slab into a memmap emit directory that the save
  adopts (``PartitionedANN.build_streaming``), the nprobe is tuned when
  ``vector.hnsw.tune_on_build`` is set, and the artifacts save through
  :func:`.builder.save_artifacts` after the quality gate.

Without a saved encoder in the vector directory the builder trains a corpus
WordPiece vocab, selects the pooling and pretrains the encoder
(``pretrain_steps``, 300 by default, on the first ``pretrain_sample_cases``
cases by rowid; :func:`..models.train.pretrain_encoder_guarded`), then saves
it before the first shard, so a resumed run loads it and trains nothing.
"""

from __future__ import annotations

import json
import logging
import shutil
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.config import Config
from ..device import DeviceLike, resolve_device
from ..models.embedder import Embedder
from ..storage.columns import MetadataColumns
from ..storage.store import StorageManager
from ..text.processor import TextProcessor
from ..utils import SystemUtils, madvise_dontneed
from .builder import BuildReport, BuiltIndexes, save_artifacts
from .trie import TrieIndex
from .vector import VectorIndex

_log = logging.getLogger("tss_torch.streaming")

_MANIFEST = "manifest.json"


@dataclass
class StreamReport(BuildReport):
    """:class:`BuildReport` and the streaming build's own measures."""

    shards: int = 0
    resumed_from_row: int = 0
    chunks_per_second: float = 0.0
    peak_rss_bytes: int = 0
    #: peak anonymous RSS (``RssAnon``): the footprint that cannot be
    #: evicted, where ``peak_rss_bytes`` also counts file pages
    peak_anon_rss_bytes: int = 0
    #: chunks embedded by this run (a resumed run embeds only the rest)
    embedded_chunks: int = 0
    #: finalize seconds: spill ``run_sort`` / ``merge`` / ``csr``,
    #: ``store_fill``, ``ann`` and ``tune``
    finalize_seconds: dict = field(default_factory=dict)


@dataclass
class _Manifest:
    next_row: int = 0
    shards: list[str] = field(default_factory=list)
    cases: int = 0
    chunks: int = 0
    citations: int = 0
    trie_ckpt: str = ""  # the current trie checkpoint directory's name

    @classmethod
    def load(cls, path: Path) -> "_Manifest":
        if not path.exists():
            return cls()
        return cls(**json.loads(path.read_text()))

    def save(self, path: Path) -> None:
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.__dict__))
        tmp.replace(path)  # atomic


def _sample_docs(storage: StorageManager, tp: TextProcessor, limit: int) -> list[list[str]]:
    """Sentences of the first ``limit`` stored cases with text."""
    docs = []
    for i, (_row, _meta, text) in enumerate(storage.iter_cases_rowid()):
        if i >= limit:
            break
        if text:
            docs.append(tp.extract_sentences(tp.normalize_text(text)))
    return docs


class StreamingIndexBuilder:
    """Checkpointed corpus-scale build on ``device`` (module docstring)."""

    def __init__(
        self,
        storage: StorageManager,
        config: Config,
        embedder: Optional[Embedder] = None,
        work_dir: Optional[str | Path] = None,
        shard_chunks: int = 8192,
        max_chunks_per_case: int = 64,
        max_cases: int = 0,
        content_spill: bool = True,
        pretrain_steps: int = 300,
        pretrain_sample_cases: int = 2000,
        device: DeviceLike = None,
    ):
        self.storage = storage
        self.config = config
        self.device = resolve_device(device)
        #: 0: the whole corpus; above 0, streaming stops after that many cases
        self.max_cases = max_cases
        #: the content trie from the external-sort spill instead of the pool
        self.content_spill = content_spill
        self.work_dir = Path(work_dir or (Path(config.trie.index_path).parent / "stream_build"))
        self.shard_chunks = shard_chunks
        self.max_chunks_per_case = max_chunks_per_case
        self.tp = TextProcessor(config.text_processing)
        if embedder is None:
            from .builder import _load_encoder

            vec_dir = Path(config.vector.hnsw.index_path)
            try:
                embedder = _load_encoder(config, vec_dir, self.device)
            except Exception:
                embedder = None
            if embedder is None:
                embedder = self._new_encoder(storage, config, pretrain_steps, pretrain_sample_cases)
                from .builder import save_encoder

                save_encoder(embedder, vec_dir)
        self.embedder = embedder

    def _new_encoder(
        self, storage: StorageManager, config: Config, pretrain_steps: int, sample_cases: int,
    ) -> Embedder:
        """A corpus WordPiece vocab from at most 10,000 cases, the encoder
        from ``vector.model``, the pooling picked on probe merit unless
        ``vector.pooling`` is ``"mean"``, then ``pretrain_steps`` of guarded
        pretraining on the first ``sample_cases`` cases."""
        from ..models.tokenizer import WordPieceTokenizer, train_wordpiece_vocab

        def sample():
            for i, (_row, _meta, text) in enumerate(storage.iter_cases_rowid()):
                if i >= 10_000:
                    return
                if text:
                    yield text

        vocab = train_wordpiece_vocab(sample(), vocab_size=8192)
        embedder = Embedder(config.vector.model, tokenizer=WordPieceTokenizer(vocab), device=self.device)
        if config.vector.pooling != "mean":
            from ..models.train import select_pooling_guarded

            rec = select_pooling_guarded(
                embedder, _sample_docs(storage, self.tp, 2000),
                sif_a=config.vector.sif_a,
                force=None if config.vector.pooling == "auto" else "sif",
            )
            _log.info("pooling selection: %s", rec)
        if pretrain_steps > 0:
            from ..models.train import pretrain_encoder_guarded

            rep = pretrain_encoder_guarded(
                embedder, _sample_docs(storage, self.tp, sample_cases), steps=pretrain_steps,
                max_len=min(64, config.vector.model.max_sequence_length),
            )
            _log.info("streaming-build pretraining: %s", rep)
        return embedder

    # -- stages ------------------------------------------------------------------

    def _load_or_new_trie(self, manifest: _Manifest) -> TrieIndex:
        if manifest.next_row > 0 and manifest.trie_ckpt:
            ckpt = self.work_dir / manifest.trie_ckpt
            _log.info("resuming tries from %s (row %d)", ckpt, manifest.next_row)
            return TrieIndex.load_from_disk(ckpt, self.config.trie, device=self.device)
        return TrieIndex(self.config.trie, device=self.device)

    def _write_shard(self, manifest: _Manifest, texts: list[str], refs: list[tuple[int, int]]) -> None:
        embs = self.embedder.embed(texts).embedding  # one bucketed encode
        name = f"shard_{len(manifest.shards):05d}"
        np.save(self.work_dir / f"{name}_emb.npy", embs.astype(np.float32))
        np.save(self.work_dir / f"{name}_refs.npy", np.asarray(refs, np.int32))
        manifest.shards.append(name)

    def _checkpoint(self, manifest: _Manifest, trie: TrieIndex, next_row: int) -> None:
        """Write the tries to a new numbered directory, point the manifest
        at it (an atomic rename), and only then delete the one before."""
        prev = manifest.trie_ckpt
        new = f"trie_ckpt_{len(manifest.shards):05d}"
        trie.freeze()
        trie.save_to_disk(self.work_dir / new)
        manifest.trie_ckpt = new
        manifest.next_row = next_row
        manifest.save(self.work_dir / _MANIFEST)
        if prev and prev != new and (self.work_dir / prev).exists():
            shutil.rmtree(self.work_dir / prev)

    def build(self, resume: bool = True) -> BuiltIndexes:
        t0 = time.perf_counter()
        self.work_dir.mkdir(parents=True, exist_ok=True)
        manifest = _Manifest.load(self.work_dir / _MANIFEST) if resume else _Manifest()
        if not resume:
            for p in self.work_dir.glob("shard_*"):
                p.unlink()
            for p in self.work_dir.glob("trie_ckpt_*"):
                shutil.rmtree(p)
        resumed_from = manifest.next_row
        trie = self._load_or_new_trie(manifest)
        _log.info("trie builder: %s", trie.backend)
        spill = None
        if self.content_spill:
            from .spill import SpillContentBuilder

            spill = SpillContentBuilder(self.work_dir, self.config.trie, resume=resume)

        pending_texts: list[str] = []
        pending_refs: list[tuple[int, int]] = []
        row_after_pending = manifest.next_row
        peak_rss = 0
        t_stream = time.perf_counter()
        chunks_at_start = manifest.chunks
        embed_s = 0.0

        def flush_shard() -> None:
            nonlocal pending_texts, pending_refs, embed_s
            t = time.perf_counter()
            self._write_shard(manifest, pending_texts, pending_refs)
            embed_s += time.perf_counter() - t
            pending_texts, pending_refs = [], []
            if spill is not None:
                spill.flush(manifest.shards[-1])
            self._checkpoint(manifest, trie, row_after_pending)

        for row, meta, text in self.storage.iter_cases_rowid(manifest.next_row):
            trie.insert_case_name(meta.name, row)
            if meta.citation:
                trie.insert_citation(meta.citation, row)
                manifest.citations += 1
            for cit in meta.citations:
                trie.insert_citation(cit, row)
                manifest.citations += 1
            body = text or meta.full_text
            if body:
                processed = self.tp.process_text(body)
                for para_idx, sentence in enumerate(processed.sentences[: self.max_chunks_per_case]):
                    toks = [t for t in sentence.lower().split() if t]
                    if spill is not None:
                        spill.insert_content(toks, row, para_idx)
                    else:
                        trie.insert_content(toks, row, para_idx)
                    pending_texts.append(sentence)
                    pending_refs.append((row, para_idx))
                    manifest.chunks += 1
                for cit in processed.citations:
                    trie.insert_citation(cit.normalized, row)
            manifest.cases += 1
            row_after_pending = row + 1
            if self.max_cases and manifest.cases >= self.max_cases:
                break
            if len(pending_texts) >= self.shard_chunks:
                flush_shard()
                rss = SystemUtils.memory_usage() or 0
                peak_rss = max(peak_rss, rss)
                rate = (manifest.chunks - chunks_at_start) / max(time.perf_counter() - t_stream, 1e-9)
                _log.info(
                    "shard %d: row %d, %d chunks total, %.0f chunks/s, rss %s",
                    len(manifest.shards), row_after_pending, manifest.chunks, rate,
                    SystemUtils.format_bytes(rss),
                )
        if pending_texts:
            flush_shard()
        stream_s = time.perf_counter() - t_stream

        # finalize, with the peak RSS sampled in a thread (the ANN build and
        # the transfers are where a corpus-scale build peaks)
        peak_fin = {"rss": 0, "anon": 0}
        stop_sampler = threading.Event()

        def sample_rss() -> None:
            while not stop_sampler.wait(2.0):
                peak_fin["rss"] = max(peak_fin["rss"], SystemUtils.memory_usage() or 0)
                peak_fin["anon"] = max(peak_fin["anon"], SystemUtils.anon_memory_usage() or 0)

        sampler = threading.Thread(target=sample_rss, daemon=True)
        sampler.start()
        fin: dict[str, float] = {}
        try:
            trie.freeze()
            if spill is not None:
                trie.set_content_frozen(spill.finalize(manifest.shards))
                fin.update(spill.finalize_seconds)
            columns = MetadataColumns.build(self.storage.fetch_filter_columns())
            vector = VectorIndex(self.config.vector, embedder=self.embedder, device=self.device)
            tune_s = 0.0
            if manifest.shards:
                t = time.perf_counter()
                ref_arr = self._fill_store(manifest, vector)
                fin["store_fill"] = time.perf_counter() - t
                if len(ref_arr):
                    t = time.perf_counter()
                    vector.ann.build_streaming(
                        vector._vectors,
                        emit_dir=Path(self.config.vector.hnsw.index_path) / "ann.mmap.emit",
                        # a build that never searches saves without a copy
                        # to the card; a tuner's first search makes one
                        device_resident=False,
                    )
                    fin["ann"] = time.perf_counter() - t
                    if vector.ann.num_vectors >= 100 and self.config.vector.hnsw.tune_on_build:
                        t = time.perf_counter()
                        self._tune(vector, ref_arr)
                        tune_s = fin["tune"] = time.perf_counter() - t
        finally:
            stop_sampler.set()
            sampler.join(timeout=5.0)
        rate = (manifest.chunks - chunks_at_start) / max(stream_s, 1e-9)
        report = StreamReport(
            cases=manifest.cases,
            content_chunks=manifest.chunks,
            citations=manifest.citations,
            seconds=time.perf_counter() - t0,
            embed_seconds=embed_s,
            tune_seconds=tune_s,
            shards=len(manifest.shards),
            resumed_from_row=resumed_from,
            chunks_per_second=round(rate, 1),
            peak_rss_bytes=max(peak_rss, peak_fin["rss"], SystemUtils.memory_usage() or 0),
            peak_anon_rss_bytes=max(peak_fin["anon"], SystemUtils.anon_memory_usage() or 0),
            embedded_chunks=manifest.chunks - chunks_at_start,
            finalize_seconds=fin,
        )
        built = BuiltIndexes(trie=trie, vector=vector, columns=columns, report=report)
        save_artifacts(built, self.config, storage=self.storage)
        _log.info(
            "streaming build complete: %d cases, %d chunks, %d shards, %.0f chunks/s, %.1fs total",
            report.cases, report.content_chunks, report.shards, report.chunks_per_second,
            report.seconds,
        )
        return built

    def _fill_store(self, manifest: _Manifest, vector: VectorIndex) -> np.ndarray:
        """The shards into one disk-backed ``vectors_f32.npy`` (never an
        O(corpus) concatenation in RAM), skipped when its completion marker
        records this shard set's shape; installs the store (read-only
        memmap) and the refs in ``vector``. Returns the refs."""
        ref_arr = np.concatenate(
            [np.load(self.work_dir / f"{s}_refs.npy") for s in manifest.shards]
        ).astype(np.int32)
        total = len(ref_arr)
        dim = int(np.load(self.work_dir / f"{manifest.shards[0]}_emb.npy", mmap_mode="r").shape[1])
        store_path = self.work_dir / "vectors_f32.npy"
        store_done = self.work_dir / "vectors_f32.complete"
        if store_done.exists() and store_done.read_text() == f"{total}x{dim}":
            _log.info("vector store fill skipped (complete marker)")
        else:
            store_done.unlink(missing_ok=True)
            mm = np.lib.format.open_memmap(store_path, mode="w+", dtype=np.float32, shape=(total, dim))
            pos = 0
            for s in manifest.shards:
                emb = np.load(self.work_dir / f"{s}_emb.npy", mmap_mode="r")
                mm[pos : pos + len(emb)] = emb
                pos += len(emb)
                madvise_dontneed(mm)  # keep the fill O(shard) in RSS
            mm.flush()
            del mm
            store_done.write_text(f"{total}x{dim}")
        vector._vectors = np.load(store_path, mmap_mode="r")
        vector._refs = ref_arr
        return ref_arr

    def _tune(self, vector: VectorIndex, ref_arr: np.ndarray) -> None:
        """The nprobe by case-level recall of query-shaped probes (target
        and floor as :func:`.builder.build_indexes` tunes), else by the
        row-level tuner on 64 sampled rows when the corpus yields no probe;
        the value persists in the saved artifact."""
        from .tuning import build_probe_embeddings, tune_nprobe_case_recall

        probes = build_probe_embeddings(
            self.storage, TextProcessor(self.config.text_processing), vector.generate_embeddings)
        if probes is not None:
            mn = self.config.vector.hnsw.tune_min_recall
            nprobe = tune_nprobe_case_recall(
                vector.ann, ref_arr[:, 0], vector._vectors, probes, k=10, target_recall=0.95,
                min_recall=mn if mn > 0 else None,
            )
            _log.info("tuned nprobe=%d for case recall>=0.95", nprobe)
        else:
            rng = np.random.default_rng(0)
            n = vector.ann.num_vectors
            sample = np.asarray(vector._vectors[np.sort(rng.choice(n, min(64, n), replace=False))])
            nprobe = vector.ann.tune_nprobe(sample, k=10, target_recall=0.95)
            _log.warning("no retrieval probes; row-level fallback tuned nprobe=%d", nprobe)
