"""Index build pipeline and artifacts: storage → frozen trie, vector and
column artifacts, and back.

Port of ``trie_semantic_search_tpu/index/builder.py``: ``build_indexes``
(cases streamed in rowid order, the dense device row order; names and
citations into the name and citation tries; each case's sentences into the
content trie and the vector index, embedded every 8,192 pending chunks;
then everything frozen, the ANN built on ``device``), ``update_indexes``
(only the cases stored since, on the existing encoder and partitioning),
``save_artifacts`` (after the build-time quality gate when given the
store) and ``save_encoder`` (the encoder is part of the artifact set:
corpus vectors only compare with query vectors of the same encoder), and
``load_artifacts`` / ``_load_encoder``. The artifacts are the JAX
package's, so either package loads what the other saved.

``update_indexes`` works on forks of the live trie and vector index
(:meth:`TrieIndex.fork`, :meth:`VectorIndex.fork`) where the JAX package
inserts into them in place: a server keeps answering from the live
indexes until it swaps the result in, and the result is the same.

``build_indexes(tune_recall=...)`` tunes the built ANN's nprobe by
case-level recall of query-shaped probes (:mod:`.tuning`), or by the
row-level ``tune_nprobe`` on 64 sampled rows when the corpus yields no
probe; ``save_artifacts`` persists the tuned nprobe with the ANN.

With no embedder passed and ``vector.pooling`` other than ``"mean"``, the
pooling is picked on probe merit (:func:`..models.train.select_pooling_guarded`,
over the first 2,000 stored cases). ``pretrain_steps > 0`` then pretrains
the encoder on every stored case's sentences
(:func:`..models.train.pretrain_encoder_guarded`, which keeps the init
weights when training lowers probe retrieval) before anything is embedded.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.config import Config
from ..core.errors import IndexCorrupted
from ..device import DeviceLike, resolve_device
from ..models import minilm
from ..models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..models.embedder import Embedder
from ..models.tokenizer import WordPieceTokenizer, train_wordpiece_vocab
from ..storage.columns import MetadataColumns
from ..storage.store import StorageManager
from ..text.processor import TextProcessor
from .ann import PartitionedANN
from .trie import TrieIndex
from .vector import VectorIndex

_log = logging.getLogger("tss_torch.builder")

#: pending chunks embedded at a time while the build streams the store
EMBED_FLUSH = 8192


@dataclass
class BuildReport:
    """What the build did and where its time went: ``seconds`` in all, of
    which the corpus vocab (with the pooling selection), the encoder
    pretraining, the chunk embedding, the freeze (tries and ANN) and the
    nprobe tuning (``tune_seconds``, of which embedding the probes
    ``tune_probe_seconds``); the rest is text processing and trie
    inserts."""

    cases: int = 0
    content_chunks: int = 0
    citations: int = 0
    seconds: float = 0.0
    vocab_seconds: float = 0.0
    pretrain_seconds: float = 0.0
    embed_seconds: float = 0.0
    freeze_seconds: float = 0.0
    tune_seconds: float = 0.0
    tune_probe_seconds: float = 0.0


@dataclass
class BuiltIndexes:
    trie: TrieIndex
    vector: VectorIndex
    columns: MetadataColumns
    report: BuildReport


def build_indexes(
    storage: StorageManager,
    config: Config,
    text_processor: Optional[TextProcessor] = None,
    embedder: Optional[Embedder] = None,
    max_chunks_per_case: int = 64,
    tune_recall: Optional[float] = None,
    pretrain_steps: int = 0,
    device: DeviceLike = None,
    mesh=None,
) -> BuiltIndexes:
    """Build all frozen search artifacts from the document store, on
    ``device`` (default ``"cuda"``). With no ``embedder``, a WordPiece
    vocab is trained on the corpus, the encoder comes from
    ``config.vector.model`` (its checkpoint, else a seeded init) and the
    pooling is selected unless ``vector.pooling`` is ``"mean"``. With
    ``pretrain_steps``, the encoder (passed or made) is pretrained that many
    steps on the stored cases' sentences first. With ``tune_recall``, the
    ANN's nprobe is tuned to that case-level recall@10
    (:func:`_tune_nprobe`). ``mesh`` (data axis > 1) makes the vector index
    a sharded exact scan over the mesh (:mod:`.sharded`)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    tp = text_processor or TextProcessor(config.text_processing)
    columns = MetadataColumns.build(storage.fetch_filter_columns())
    trie = TrieIndex(config.trie, device=dev)
    _log.info("trie builder: %s", trie.backend)
    report = BuildReport()
    if embedder is None:
        vocab = train_wordpiece_vocab(
            (text for _, text in storage.iter_cases() if text), vocab_size=8192
        )
        embedder = Embedder(config.vector.model, tokenizer=WordPieceTokenizer(vocab), device=dev)
        if config.vector.pooling != "mean":
            from ..models.train import select_pooling_guarded

            docs = []
            for i, (_meta, text) in enumerate(storage.iter_cases()):
                if i >= 2000:
                    break
                if text:
                    docs.append(tp.extract_sentences(tp.normalize_text(text)))
            rec = select_pooling_guarded(
                embedder, docs, sif_a=config.vector.sif_a,
                force=None if config.vector.pooling == "auto" else "sif",
            )
            _log.info("pooling selection: %s", rec)
        report.vocab_seconds = time.perf_counter() - t0
    if pretrain_steps > 0:
        from ..models.train import pretrain_encoder_guarded

        t = time.perf_counter()
        docs = [
            tp.extract_sentences(tp.normalize_text(text))
            for _, text in storage.iter_cases()
            if text
        ]
        rep = pretrain_encoder_guarded(
            embedder, docs, steps=pretrain_steps,
            max_len=min(64, config.vector.model.max_sequence_length),
        )
        report.pretrain_seconds = time.perf_counter() - t
        _log.info("encoder pretraining: %s", rep)
    vector = VectorIndex(config.vector, embedder=embedder, device=dev, mesh=mesh)

    def embed(flush_threshold: int) -> int:
        t = time.perf_counter()
        n = vector.embed_pending(flush_threshold=flush_threshold)
        report.embed_seconds += time.perf_counter() - t
        return n

    for row, meta, text in storage.iter_cases_rowid():
        assert columns.row_of_case[meta.id] == row
        _index_case(trie, vector, tp, report, row, meta, text, max_chunks_per_case)
        embedded = embed(EMBED_FLUSH)
        if embedded:
            _log.info("embedded %d chunks (%d cases done)", embedded, report.cases)

    embed(0)
    t = time.perf_counter()
    trie.freeze()
    vector.freeze()
    report.freeze_seconds = time.perf_counter() - t
    if tune_recall and vector.ann.num_vectors >= 100 and vector.vectors is not None:
        t = time.perf_counter()
        _tune_nprobe(storage, config, tp, vector, tune_recall, report)
        report.tune_seconds = time.perf_counter() - t
    report.seconds = time.perf_counter() - t0
    _log.info(
        "built indexes: %d cases, %d chunks, %d citations in %.2fs",
        report.cases, report.content_chunks, report.citations, report.seconds,
    )
    return BuiltIndexes(trie=trie, vector=vector, columns=columns, report=report)


def _tune_nprobe(storage, config, tp, vector, tune_recall, report) -> None:
    """The built ANN's nprobe, tuned by the case-level recall@10 of
    query-shaped probes embedded by the serving encoder (the worst probe
    held to ``vector.hnsw.tune_min_recall`` when it is above 0); by the
    row-level ``tune_nprobe`` on 64 sampled rows when the corpus yields no
    probe. Kept in ``vector.ann.tuned_nprobe``."""
    from .tuning import build_probe_embeddings, tune_nprobe_case_recall

    t = time.perf_counter()
    probes = build_probe_embeddings(storage, tp, vector.generate_embeddings)
    report.tune_probe_seconds = time.perf_counter() - t
    if probes is not None and len(vector.refs):
        mn = config.vector.hnsw.tune_min_recall
        nprobe = tune_nprobe_case_recall(
            vector.ann, np.asarray(vector.refs)[:, 0], vector.vectors, probes, k=10,
            target_recall=tune_recall, min_recall=mn if mn > 0 else None,
        )
        _log.info("tuned nprobe=%d for case recall>=%.2f", nprobe, tune_recall)
    else:
        rng = np.random.default_rng(0)
        n = vector.ann.num_vectors
        sample = vector.vectors[rng.choice(n, min(64, n), replace=False)]
        nprobe = vector.ann.tune_nprobe(sample, k=10, target_recall=tune_recall)
        _log.info("tuned nprobe=%d for recall>=%.2f", nprobe, tune_recall)


def _index_case(trie, vector, tp, report, row, meta, text, max_chunks_per_case) -> None:
    """One stored case into the tries and the vector index's pending
    chunks (the JAX package's per-case loop)."""
    trie.insert_case_name(meta.name, row)
    if meta.citation:
        trie.insert_citation(meta.citation, row)
        report.citations += 1
    for cit in meta.citations:
        trie.insert_citation(cit, row)
        report.citations += 1
    body = text or meta.full_text
    if body:
        processed = tp.process_text(body)
        for para_idx, sentence in enumerate(processed.sentences[:max_chunks_per_case]):
            trie.insert_content([t for t in sentence.lower().split() if t], row, para_idx)
            vector.add_document(row, sentence, para_idx)
            report.content_chunks += 1
        for cit in processed.citations:
            trie.insert_citation(cit.normalized, row)
    report.cases += 1


def update_indexes(
    built: BuiltIndexes,
    storage: StorageManager,
    config: Config,
    text_processor: Optional[TextProcessor] = None,
    max_chunks_per_case: int = 64,
) -> BuiltIndexes:
    """Index only the cases stored since ``built`` was produced, on its
    encoder and its ANN partitioning (no re-embedding of old chunks, no
    k-means), and return new indexes for an engine swap; ``built`` is not
    changed. When the old cases no longer lead the store's row order (a
    case was deleted), dense row ids have moved, and this falls back to a
    full :func:`build_indexes` with the same encoder."""
    t0 = time.perf_counter()
    tp = text_processor or TextProcessor(config.text_processing)
    columns = MetadataColumns.build(storage.fetch_filter_columns())
    known = set(built.columns.row_of_case)
    report = BuildReport(cases=built.report.cases, content_chunks=built.report.content_chunks,
                         citations=built.report.citations)
    new = [(row, meta, text) for row, meta, text in storage.iter_cases_rowid()
           if meta.id not in known]
    if not new:
        report.seconds = time.perf_counter() - t0
        return BuiltIndexes(trie=built.trie, vector=built.vector, columns=columns, report=report)
    old_rows = built.columns.case_ids
    if columns.case_ids[: len(old_rows)] != old_rows:
        _log.info("row order changed; falling back to full rebuild")
        return build_indexes(
            storage, config, text_processor=tp, embedder=built.vector.embedder,
            max_chunks_per_case=max_chunks_per_case, device=built.vector.device,
        )
    trie, vector = built.trie.fork(), built.vector.fork()
    _log.info("trie builder: %s", trie.backend)
    for row, meta, text in new:
        _index_case(trie, vector, tp, report, row, meta, text, max_chunks_per_case)
    inserted = time.perf_counter()
    trie.freeze()
    t = time.perf_counter()
    report.freeze_seconds = t - inserted
    vector.embed_pending()
    report.embed_seconds = time.perf_counter() - t
    t = time.perf_counter()
    if vector.vectors is not None and len(vector.vectors):
        live = built.vector.ann
        vector.ann = PartitionedANN(vector.config.hnsw, device=vector.device)
        vector.ann.tuned_nprobe = live.tuned_nprobe
        if live.centroids is not None:
            cent = live.centroids  # a host array while a streamed index waits for its first search
            vector.ann.build(vector.vectors, reuse_centroids=np.asarray(
                cent.cpu() if hasattr(cent, "cpu") else cent))
        else:
            vector.ann.build(vector.vectors)
    ann_seconds = time.perf_counter() - t
    report.freeze_seconds += ann_seconds
    report.seconds = time.perf_counter() - t0
    _log.info(
        "incremental update: %d new cases in %.2fs (read and insert %.2f, trie freeze %.2f, "
        "embed %.2f, ANN from centroids %.2f)", len(new), report.seconds, inserted - t0,
        report.freeze_seconds - ann_seconds, report.embed_seconds, ann_seconds,
    )
    return BuiltIndexes(trie=trie, vector=vector, columns=columns, report=report)


def save_artifacts(
    built: BuiltIndexes, config: Config, storage: Optional[StorageManager] = None,
) -> None:
    """Persist every frozen artifact: the tries and the columns under
    ``config.trie.index_path``, the vector index and the encoder under
    ``config.vector.hnsw.index_path``. Given the store, the build-time
    quality gate (:mod:`.quality_gate`) runs first: in ``"refuse"`` mode a
    degraded encoder raises before anything is written, and its report is
    saved as ``quality.json`` beside the vector artifacts."""
    from .quality_gate import run_quality_gate, save_quality_meta

    quality = None
    if storage is not None and built.vector.size:
        quality = run_quality_gate(storage, config, built.vector.embedder)
    vec_dir = Path(config.vector.hnsw.index_path)
    built.trie.save_to_disk(config.trie.index_path)
    built.vector.save(vec_dir)
    built.columns.save(Path(config.trie.index_path) / "columns.npz")
    save_encoder(built.vector.embedder, vec_dir)
    save_quality_meta(quality, vec_dir)


def save_encoder(emb: Embedder, enc_dir: Path) -> None:
    """Persist the encoder: tokenizer vocab, parameters (step 0, the JAX
    package's checkpoint layout) and SIF pooling weights when it has them."""
    enc_dir.mkdir(parents=True, exist_ok=True)
    emb.tokenizer.save(enc_dir / "tokenizer.json")
    tw_path = enc_dir / "token_weights.npy"
    if emb.token_weights is not None:
        np.save(tw_path, emb.token_weights.cpu().numpy().astype(np.float32))
    elif tw_path.exists():
        tw_path.unlink()
    c = emb.model_config
    save_checkpoint(
        enc_dir / "encoder", 0, emb.model.state_dict(),
        metadata={
            "vocab_size": c.vocab_size,
            "hidden_size": c.hidden_size,
            "num_layers": c.num_layers,
            "num_heads": c.num_heads,
            "intermediate_size": c.intermediate_size,
            "max_position": c.max_position,
        },
        keep=1,
    )


def load_artifacts(
    config: Config, embedder: Optional[Embedder] = None, device: DeviceLike = None,
    mesh=None,
) -> Optional[tuple[TrieIndex, VectorIndex, MetadataColumns]]:
    """``(trie, vector index, columns)`` from saved artifacts, or None when
    they are absent. Restores the saved encoder unless one is passed. With
    a ``mesh`` (data axis > 1) the vector index is sharded over it, loaded
    from a sharded artifact or rebuilt from the saved vectors."""
    dev = resolve_device(device)
    trie_dir = Path(config.trie.index_path)
    vec_dir = Path(config.vector.hnsw.index_path)
    cols_path = trie_dir / "columns.npz"
    has_trie = (trie_dir / "name_trie.npz").exists() or (trie_dir / "name_trie.mmap").is_dir()
    if not has_trie or not cols_path.exists():
        return None
    trie = TrieIndex.load_from_disk(trie_dir, config.trie, device=dev)
    if embedder is None:
        embedder = _load_encoder(config, vec_dir, dev)
    vector = VectorIndex(config.vector, embedder=embedder, device=dev, mesh=mesh)
    if (vec_dir / "refs.npz").exists():
        vector.load(vec_dir)
    return trie, vector, MetadataColumns.load(cols_path)


def _load_encoder(config: Config, vec_dir: Path, device: DeviceLike = None) -> Optional[Embedder]:
    """The build-time encoder from ``vec_dir``: None without a saved
    tokenizer; :class:`IndexCorrupted` when the tokenizer is there but the
    checkpoint is missing or unreadable (a fresh random encoder would
    mis-score every semantic query without a sign)."""
    tok_path = vec_dir / "tokenizer.json"
    enc_dir = vec_dir / "encoder"
    if not tok_path.exists():
        return None
    tokenizer = WordPieceTokenizer.load(tok_path)
    step = latest_step(enc_dir)
    if step is None:
        raise IndexCorrupted(
            index_type="encoder",
            details=f"tokenizer present but no checkpoint under {enc_dir}",
        )
    meta = json.loads((enc_dir / f"step_{step}" / "meta.json").read_text())
    model_config = minilm.MiniLMConfig(
        vocab_size=meta["vocab_size"],
        hidden_size=meta["hidden_size"],
        num_layers=meta["num_layers"],
        num_heads=meta["num_heads"],
        intermediate_size=meta["intermediate_size"],
        max_position=meta["max_position"],
    )
    restored = restore_checkpoint(enc_dir, model_config)
    if restored is None:
        raise IndexCorrupted(index_type="encoder", details=f"unreadable checkpoint in {enc_dir}")
    model = minilm.MiniLM(model_config, device="cpu").load_params(restored[0])
    tw_path = vec_dir / "token_weights.npy"
    return Embedder(
        config.vector.model, tokenizer=tokenizer, model=model,
        token_weights=np.load(tw_path) if tw_path.exists() else None, device=device,
    )
