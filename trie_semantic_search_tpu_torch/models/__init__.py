"""Tokenizer, MiniLM encoder, the serving embedder and training.

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
