"""queue_wait_ms.http: the mean batch.queue_wait span over the window's batches, per request (BatchingQueue: submit to its batch's start)."""
from benchmark.leaf_spans import mean_ms


def read(obs):
    return mean_ms(obs, "batch.queue_wait")
