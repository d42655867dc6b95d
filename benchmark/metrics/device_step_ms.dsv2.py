"""device_step_ms: mean of the engine's fused_device span over the window."""
from benchmark.readers import span_mean_ms


def read(obs):
    return span_mean_ms(obs, "fused_device")
