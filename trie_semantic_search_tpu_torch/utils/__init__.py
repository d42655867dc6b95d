"""Serving helpers shared by every device entry point (copy of
``trie_semantic_search_tpu/utils/__init__.py``'s batch ladder)."""

from __future__ import annotations

#: THE serving batch-bucket ladder, shared by the embedder batch pad and the
#: fused hybrid batch pad, so both run the same set of shapes.
BATCH_BUCKETS = (1, 8, 32, 64)


def batch_bucket(b: int) -> int:
    """Smallest ladder bucket >= b (powers of two past the ladder)."""
    for cap in BATCH_BUCKETS:
        if b <= cap:
            return cap
    return 1 << max(0, b - 1).bit_length()
