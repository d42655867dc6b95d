"""store_read_ms.bulk: the hydrate.meta_select plus hydrate.text_select totals (the sqlite selects and cache fills) over the window's batches, ms a batch."""
from benchmark.leaf_spans import per_batch_ms


def read(obs):
    return per_batch_ms(obs, "hydrate.meta_select", "hydrate.text_select")
