"""Arithmetic of the per-layer metrics that read the served batch's leaf
spans (``core/metrics``: ``batch.queue_wait``, ``embed.*``, ``step.*``,
``hydrate.*``, ``store.gunzip``) over the window's batches.

The window's batches are ``obs["window_batches"]``, ``(start, end,
indices)`` on ``time.perf_counter``. The program's registry keeps each
span's newest observations with their end times
(``MetricsRegistry.between``), so a reader asks it, after the run, for the
spans that ended between the first batch's start and the last batch's end.
A program without that registry call, or that records none of the named
spans there, reads None, and the metric is left out of the result line."""

from __future__ import annotations


def window_spans(obs: dict) -> dict:
    """``{name: (count, total ms)}`` of the spans that ended within the
    window's batches; empty where the program cannot say."""
    from trie_semantic_search_tpu_torch.core.metrics import metrics

    batches = obs.get("window_batches") or []
    between = getattr(metrics, "between", None)
    if between is None or not batches:
        return {}
    return between(min(b[0] for b in batches), max(b[1] for b in batches))


def per_batch_ms(obs: dict, *names: str):
    """The window's total of the spans ``names`` ÷ its ``search_batch``
    count."""
    spans = window_spans(obs)
    batches = spans.get("search_batch", (0, 0.0))[0]
    parts = [spans.get(n, (0, 0.0)) for n in names]
    if not batches or not any(count for count, _ in parts):
        return None
    return sum(total for _, total in parts) / batches


def mean_ms(obs: dict, name: str):
    """The window's mean of the span ``name``."""
    count, total = window_spans(obs).get(name, (0, 0.0))
    return total / count if count else None
