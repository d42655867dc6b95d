"""Embedding model runtime: tokenizer + encoder + shape bucketing.

Port of ``trie_semantic_search_tpu/models/embedder.py``: text → WordPiece
ids (host) → the encoder on the device → L2-normalised ``[B, D]`` f32.
Sequences pad to the next power of two (>= 16, <= the configured maximum)
and batches to the shared serving ladder (``utils.batch_bucket``), the same
shapes the JAX embedder runs (:162-184).

The encoder is any module of the :class:`Encoder` interface:
:class:`~.minilm.MiniLM` (BERT's post-norm layers, mean pooled) or
:class:`~.deepseek_v2.DeepseekV2` (a decoder, last-token pooled). One
passed in is used as it is (for example a MiniLM loaded with
:func:`~.minilm.params_from_jax`, or the benchmark's seeded DeepSeek-V2).
Else ``config.model_type`` names it: a ``deepseek_v2.MODEL_TYPES`` name
builds a seeded DeepSeek-V2 (no checkpoint loader exists for it yet),
anything else a MiniLM of ``minilm.MODEL_FAMILIES``' geometry, from the
HuggingFace checkpoint at ``config.model_path`` when that path exists,
else a seeded init (also when the checkpoint cannot be read: a warning is
logged, as the JAX embedder does, :79-93).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional, Protocol, Sequence

import numpy as np
import torch

from ..core.config import EmbeddingModelConfig
from ..core.errors import EmbeddingGenerationFailed
from ..core.metrics import metrics
from ..device import DeviceLike, resolve_device
from ..utils import batch_bucket
from . import deepseek_v2, minilm
from .tokenizer import WordPieceTokenizer, load_tokenizer

_log = logging.getLogger("tss_torch.embedder")


class Encoder(Protocol):
    """What ``Embedder`` needs of an encoder module: ``config.hidden_size``
    (the embedding's width) and ``encode(ids, mask, token_weights)`` →
    ``[B, hidden_size]`` f32, L2-normalised, for right-padded ``[B, L]``
    ids and mask. A module with ``packs_tokens`` also takes
    ``real_tokens=`` (the mask's sum, known on the host here); one with
    ``take_stats`` hands back a small device vector after each forward,
    which ``Embedder`` copies to the host with the embedding and gives to
    its ``observe_stats``."""

    config: Any

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               token_weights: Optional[torch.Tensor] = None) -> torch.Tensor: ...


@dataclass
class EmbeddingResult:
    embedding: np.ndarray
    processing_time_ms: float


def _bucket_len(n: int, max_len: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return min(b, max_len)


class Embedder:
    """The serving-side embedding model, on ``device`` (default ``"cuda"``)."""

    def __init__(
        self,
        config: Optional[EmbeddingModelConfig] = None,
        tokenizer: Optional[WordPieceTokenizer] = None,
        model: Optional[Encoder] = None,
        model_config: Optional[minilm.MiniLMConfig] = None,
        seed: int = 0,
        token_weights: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        self.config = config or EmbeddingModelConfig()
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or load_tokenizer(self.config.tokenizer_path)
        family = self.config.model_type.lower()
        if model is not None:
            self.model = model.to(self.device)
            self.model_config = model.config
        elif family in deepseek_v2.MODEL_TYPES:
            base = deepseek_v2.MODEL_TYPES[family]
            self.model_config = dataclasses.replace(
                base, vocab_size=max(base.vocab_size, len(self.tokenizer)))
            self.model = deepseek_v2.DeepseekV2(self.model_config, device=self.device, seed=seed)
            if Path(self.config.model_path).exists():
                _log.warning("no checkpoint loader for %s yet; seeded init", family)
        else:
            self.model_config = model_config or minilm.config_for_model_type(
                self.config.model_type,
                vocab_size=max(len(self.tokenizer), 128),
                max_position=self.config.max_sequence_length,
            )
            self.model = minilm.MiniLM(self.model_config, device=self.device, seed=seed)
            mp = Path(self.config.model_path)
            if mp.exists():
                try:
                    loaded = minilm.load_hf_checkpoint(mp, self.model_config)
                except (KeyError, ValueError, ImportError) as e:
                    _log.warning("HF checkpoint load failed (%s); random init", e)
                else:
                    if loaded is not None:
                        self.model.load_params(loaded)
        self.token_weights = None
        self.set_token_weights(token_weights)
        self._stats = {"texts_embedded": 0, "batches": 0, "total_ms": 0.0}

    @property
    def dimension(self) -> int:
        return self.model_config.hidden_size

    def set_token_weights(self, token_weights: Optional[np.ndarray]) -> None:
        """SIF pooling weights ``[vocab]`` (None = plain mean pooling)."""
        self.token_weights = (
            None if token_weights is None
            else torch.as_tensor(token_weights, dtype=torch.float32, device=self.device)
        )

    def embed(self, texts: Sequence[str]) -> EmbeddingResult:
        """Embed a batch of texts → ``[B, D]`` f32 (L2-normalised)."""
        if not texts:
            return EmbeddingResult(np.zeros((0, self.dimension), np.float32), 0.0)
        t0 = time.perf_counter()
        try:
            out = np.concatenate([
                self._embed_chunk(list(texts[i : i + 256]))
                for i in range(0, len(texts), 256)
            ])
        except Exception as e:
            raise EmbeddingGenerationFailed(
                text_preview=str(texts[0])[:60], reason=str(e)
            ) from e
        ms = (time.perf_counter() - t0) * 1000
        self._stats["texts_embedded"] += len(texts)
        self._stats["batches"] += 1
        self._stats["total_ms"] += ms
        return EmbeddingResult(out, ms)

    def embed_one(self, text: str) -> np.ndarray:
        return self.embed([text]).embedding[0]

    def get_stats(self) -> dict:
        """Texts embedded, ``embed`` calls and their milliseconds (and the
        mean per call once there is one)."""
        s = dict(self._stats)
        if s["batches"]:
            s["avg_batch_ms"] = s["total_ms"] / s["batches"]
        return s

    def _embed_chunk(self, texts: list[str]) -> np.ndarray:
        """Spans ``embed.tokenize`` (WordPiece and the padded id and mask
        arrays) and ``embed.forward`` (the encoder and the copy of its
        result to the host, which waits for it)."""
        with metrics.leaf("embed.tokenize"):
            enc = [self.tokenizer.encode(t, self.config.max_sequence_length) for t in texts]
            true_len = max(max(sum(m) for _, m in enc), 2)
            L = _bucket_len(true_len, self.config.max_sequence_length)
            B = len(texts)
            Bpad = batch_bucket(B)
            ids = np.zeros((Bpad, L), np.int32)
            mask = np.zeros((Bpad, L), np.int32)
            for i, (a, m) in enumerate(enc):
                ids[i] = a[:L]
                mask[i] = m[:L]
        with metrics.leaf("embed.forward"):
            kw = {"real_tokens": int(mask.sum())} if getattr(self.model, "packs_tokens", False) else {}
            emb = self.model.encode(
                torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device),
                self.token_weights,
                **kw,
            )
            stats = self.model.take_stats() if hasattr(self.model, "take_stats") else None
            if stats is None:
                return emb[:B].cpu().numpy()
            # the module's device statistics ride on the embedding's copy
            flat = torch.cat([emb[:B].reshape(-1), stats.to(emb.dtype)]).cpu().numpy()
            self.model.observe_stats(flat[B * emb.shape[1]:])
            return flat[: B * emb.shape[1]].reshape(B, emb.shape[1])
