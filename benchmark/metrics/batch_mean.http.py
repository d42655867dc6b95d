"""batch_mean.http: queries per batch the BatchingQueue formed in the window (its stats: items over batches)."""


def read(obs):
    b = obs.get("batcher")
    return b["items"] / b["batches"] if b and b["batches"] else None
