"""fused_scan_roofline.dsv2: the fused scan's least time (the whole int8 corpus and its scales at D=2048, once a batch, at 3.35 TB/s) over its device time, in %, over the traced batches."""
from benchmark.readers import kernel_roofline, stream_least_s


def read(obs):
    return kernel_roofline(obs, "fused_scan", stream_least_s)
