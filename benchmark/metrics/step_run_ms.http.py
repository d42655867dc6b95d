"""step_run_ms.http: the step.run total (the stage's call until its results are on the host) over the window's batches, ms a batch."""
from benchmark.leaf_spans import per_batch_ms


def read(obs):
    return per_batch_ms(obs, "step.run")
