"""Tokenizer, encoders, the serving embedder and training.

The serving embedder (:class:`~.embedder.Embedder`) runs any module of the
encoder interface (:class:`~.embedder.Encoder`): :class:`~.minilm.MiniLM`,
BERT's post-norm encoder (the ``minilm.MODEL_FAMILIES`` model types), or
:class:`~.deepseek_v2.DeepseekV2`, DeepSeek-V2 used as a last-token pooled
encoder (the ``deepseek_v2.MODEL_TYPES`` model type ``"deepseek-v2-lite"``;
seeded weights only, no checkpoint loader yet). Training and the
checkpoints are MiniLM's.

The JAX package's functional ``init_params`` / ``forward`` / ``encode`` are
the :class:`~.minilm.MiniLM` module's constructor and methods here (see
:mod:`.minilm`).
"""

from .minilm import (
    MiniLM,
    MiniLMConfig,
    count_params,
    load_hf_checkpoint,
    param_partition_specs,
)
from .tokenizer import (
    WordPieceTokenizer,
    basic_tokenize,
    load_tokenizer,
    train_wordpiece_vocab,
)

__all__ = [
    "MiniLM",
    "MiniLMConfig",
    "WordPieceTokenizer",
    "basic_tokenize",
    "count_params",
    "load_hf_checkpoint",
    "load_tokenizer",
    "param_partition_specs",
    "train_wordpiece_vocab",
]
