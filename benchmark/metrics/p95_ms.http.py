"""p95_ms.http: the 95th percentile of every request due in the window, timed by the client from when it was due; a failed or refused request counts as slower than any served one."""
from benchmark.readers import latency_percentile


def read(obs):
    return latency_percentile(obs, 95)
