"""step_mfu: the window's batches' least time (encoder FLOPs of the real tokens at the bf16 peak plus the probed partitions' bytes at the HBM peak) over their wall time, in %."""
from benchmark.readers import step_mfu as read  # noqa: F401
