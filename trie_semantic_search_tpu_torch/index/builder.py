"""Index build pipeline and artifacts: storage → frozen trie, vector and
column artifacts, and back.

Port of ``trie_semantic_search_tpu/index/builder.py``: ``build_indexes``
(cases streamed in rowid order, the dense device row order; names and
citations into the name and citation tries; each case's sentences into the
content trie and the vector index, embedded every 8,192 pending chunks;
then everything frozen, the ANN built on ``device``), ``save_artifacts``
and ``save_encoder`` (the encoder is part of the artifact set: corpus
vectors only compare with query vectors of the same encoder), and
``load_artifacts`` / ``_load_encoder``. The artifacts are the JAX
package's, so either package loads what the other saved.

Paths of later slices raise ``NotImplementedError`` rather than diverge:
pooling selection (``vector.pooling`` other than ``"mean"`` with no
embedder passed) and encoder pretraining come with the training slice; the
build-time quality gate (``save_artifacts(..., storage=...)``) with
``models/quality.py``; ``tune_recall`` with the case-level tuner of
``index/tuning.py``.
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
from .trie import TrieIndex
from .vector import VectorIndex

_log = logging.getLogger("tss_torch.builder")

#: pending chunks embedded at a time while the build streams the store
EMBED_FLUSH = 8192


@dataclass
class BuildReport:
    """What the build did and where its time went: ``seconds`` in all, of
    which the corpus vocab, the chunk embedding and the freeze (tries and
    ANN); the rest is text processing and trie inserts."""

    cases: int = 0
    content_chunks: int = 0
    citations: int = 0
    seconds: float = 0.0
    vocab_seconds: float = 0.0
    embed_seconds: float = 0.0
    freeze_seconds: float = 0.0


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
) -> BuiltIndexes:
    """Build all frozen search artifacts from the document store, on
    ``device`` (default ``"cuda"``). With no ``embedder``, a WordPiece
    vocab is trained on the corpus and the encoder comes from
    ``config.vector.model`` (its checkpoint, else a seeded init)."""
    if tune_recall:
        raise NotImplementedError(
            "tune_recall needs the case-level tuner of index/tuning.py, which a later "
            "slice ports; call vector.ann.tune_nprobe on the built index instead"
        )
    if pretrain_steps > 0:
        raise NotImplementedError("encoder pretraining comes with the training slice")
    if embedder is None and config.vector.pooling != "mean":
        raise NotImplementedError(
            f"vector.pooling={config.vector.pooling!r} selects the pooling by training "
            "(select_pooling_guarded), which comes with the training slice; use 'mean' "
            "or pass an embedder"
        )
    dev = resolve_device(device)
    t0 = time.perf_counter()
    tp = text_processor or TextProcessor(config.text_processing)
    columns = MetadataColumns.build(storage.fetch_filter_columns())
    trie = TrieIndex(config.trie, device=dev)
    report = BuildReport()
    if embedder is None:
        vocab = train_wordpiece_vocab(
            (text for _, text in storage.iter_cases() if text), vocab_size=8192
        )
        embedder = Embedder(config.vector.model, tokenizer=WordPieceTokenizer(vocab), device=dev)
        report.vocab_seconds = time.perf_counter() - t0
    vector = VectorIndex(config.vector, embedder=embedder, device=dev)

    def embed(flush_threshold: int) -> int:
        t = time.perf_counter()
        n = vector.embed_pending(flush_threshold=flush_threshold)
        report.embed_seconds += time.perf_counter() - t
        return n

    for row, meta, text in storage.iter_cases_rowid():
        assert columns.row_of_case[meta.id] == row
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
        embedded = embed(EMBED_FLUSH)
        if embedded:
            _log.info("embedded %d chunks (%d cases done)", embedded, report.cases)

    embed(0)
    t = time.perf_counter()
    trie.freeze()
    vector.freeze()
    report.freeze_seconds = time.perf_counter() - t
    report.seconds = time.perf_counter() - t0
    _log.info(
        "built indexes: %d cases, %d chunks, %d citations in %.2fs",
        report.cases, report.content_chunks, report.citations, report.seconds,
    )
    return BuiltIndexes(trie=trie, vector=vector, columns=columns, report=report)


def save_artifacts(
    built: BuiltIndexes, config: Config, storage: Optional[StorageManager] = None,
) -> None:
    """Persist every frozen artifact: the tries and the columns under
    ``config.trie.index_path``, the vector index and the encoder under
    ``config.vector.hnsw.index_path``."""
    if storage is not None:
        raise NotImplementedError(
            "the build-time quality gate needs models/quality.py, which a later slice "
            "ports; call save_artifacts without storage"
        )
    built.trie.save_to_disk(config.trie.index_path)
    built.vector.save(config.vector.hnsw.index_path)
    built.columns.save(Path(config.trie.index_path) / "columns.npz")
    save_encoder(built.vector.embedder, Path(config.vector.hnsw.index_path))


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
) -> Optional[tuple[TrieIndex, VectorIndex, MetadataColumns]]:
    """``(trie, vector index, columns)`` from saved artifacts, or None when
    they are absent. Restores the saved encoder unless one is passed."""
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
    vector = VectorIndex(config.vector, embedder=embedder, device=dev)
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
