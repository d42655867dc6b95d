"""p50_ms.http: the median of the same samples as p95_ms.http."""
from benchmark.readers import latency_percentile


def read(obs):
    return latency_percentile(obs, 50)
