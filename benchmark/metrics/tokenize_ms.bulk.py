"""tokenize_ms: the embed.tokenize total (WordPiece and the padded arrays) over the window's batches, ms a batch."""
from benchmark.leaf_spans import per_batch_ms


def read(obs):
    return per_batch_ms(obs, "embed.tokenize")
