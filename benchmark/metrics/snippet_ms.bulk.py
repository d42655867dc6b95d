"""snippet_ms.bulk: the hydrate.sentences plus hydrate.snippet totals (sentence split and generate_snippet) over the window's batches, ms a batch."""
from benchmark.leaf_spans import per_batch_ms


def read(obs):
    return per_batch_ms(obs, "hydrate.sentences", "hydrate.snippet")
