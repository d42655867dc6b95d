"""Loading the index artifacts the JAX package's build saves.

Port of ``load_artifacts`` and ``_load_encoder`` of
``trie_semantic_search_tpu/index/builder.py``: the three tries and the
metadata columns under ``config.trie.index_path``, the vector index (refs,
vectors, partitioned ANN) and the encoder (WordPiece vocab, MiniLM
checkpoint, SIF pooling weights) under ``config.vector.hnsw.index_path``,
all placed on ``device``. Building and saving come with the index-build
slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.config import Config
from ..core.errors import IndexCorrupted
from ..device import DeviceLike, resolve_device
from ..models import minilm
from ..models.checkpoint import latest_step, restore_checkpoint
from ..models.embedder import Embedder
from ..models.tokenizer import WordPieceTokenizer
from ..storage.columns import MetadataColumns
from .trie import TrieIndex
from .vector import VectorIndex


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
