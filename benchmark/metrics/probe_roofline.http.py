"""probe_roofline.http: the probe kernels' least time (the int8 rows and scales of every partition a batch probes, once, at 3.35 TB/s) over their device time, in %, over the traced batches."""
from benchmark.readers import kernel_roofline, least_semantic_s


def read(obs):
    return kernel_roofline(obs, "probe_", least_semantic_s)
