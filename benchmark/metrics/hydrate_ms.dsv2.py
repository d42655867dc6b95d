"""hydrate_ms: the engine's mean search_batch span less its mean fused_embed and fused_device spans, over the window (core/metrics totals)."""
from benchmark.readers import hydrate_ms as read  # noqa: F401
