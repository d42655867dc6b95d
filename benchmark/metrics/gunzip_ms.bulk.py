"""gunzip_ms.bulk: the store.gunzip total (decompress and decode of case texts) over the window's batches, ms a batch."""
from benchmark.leaf_spans import per_batch_ms


def read(obs):
    return per_batch_ms(obs, "store.gunzip")
