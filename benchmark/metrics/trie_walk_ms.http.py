"""trie_walk_ms.http: the step.trie_walk total (the three tries' batched walk) over the window's batches, ms a batch."""
from benchmark.leaf_spans import per_batch_ms


def read(obs):
    return per_batch_ms(obs, "step.trie_walk")
