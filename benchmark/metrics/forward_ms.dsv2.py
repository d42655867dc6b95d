"""forward_ms.dsv2: the embed.forward total (the encoder's forward and the copy of its result to the host, which waits for it) over the window's batches, ms a batch."""
from benchmark.leaf_spans import per_batch_ms


def read(obs):
    return per_batch_ms(obs, "embed.forward")
