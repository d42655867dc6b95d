"""The per-layer metrics that read the served batch's leaf spans: each
reader's arithmetic on a synthetic window of the program's registry, its
silence where the program records no such span or cannot say when, and the
traced tiny run of each cell reporting its four."""

from __future__ import annotations

import time

import pytest

from benchmark import cell
from trie_semantic_search_tpu_torch.core import metrics as core_metrics

#: the window's spans, (count, total ms): 10 batches of 32 requests
SPANS = {
    "search_batch": (10, 3000.0), "fused_embed": (10, 400.0), "fused_device": (10, 600.0),
    "batch.queue_wait": (320, 16000.0), "embed.tokenize": (10, 50.0), "embed.forward": (10, 340.0),
    "step.trie_walk": (10, 120.0), "step.inputs": (10, 30.0), "step.run": (10, 400.0),
    "step.escalate": (4, 20.0), "hydrate.meta_select": (10, 300.0), "hydrate.text_select": (10, 500.0),
    "hydrate.results": (10, 1100.0), "store.gunzip": (11, 420.0), "hydrate.sentences": (10, 250.0),
    "hydrate.snippet": (10, 650.0),
}
PARENTS = ("search_batch", "fused_embed", "fused_device")
#: the window's batches, (start, end, indices) on the host clock
WINDOW = [(100.0 + k, 100.5 + k, []) for k in range(10)]

#: metric → what it reads from SPANS (ms a batch; the queue wait per request)
WANT = {
    "queue_wait_ms.http": 50.0,
    "tokenize_ms.http": 5.0,
    "trie_walk_ms.http": 12.0,
    "step_run_ms.http": 40.0,
    "tokenize_ms.bulk": 5.0,
    "store_read_ms.bulk": 80.0,
    "gunzip_ms.bulk": 42.0,
    "snippet_ms.bulk": 90.0,
}

CELL_METRICS = {
    "minilm-l6.http-steady": {"queue_wait_ms.http", "tokenize_ms.http", "trie_walk_ms.http", "step_run_ms.http"},
    "legal-bert.bulk-256": {"tokenize_ms.bulk", "store_read_ms.bulk", "gunzip_ms.bulk", "snippet_ms.bulk"},
}


def _registry(monkeypatch, spans: dict) -> core_metrics.MetricsRegistry:
    """A fresh process registry holding ``spans`` spread over the window's
    batches, and the same again before and after the window."""
    reg = core_metrics.MetricsRegistry()
    for name, (count, total) in spans.items():
        for shift in (-50.0, 0.0, 50.0):
            for i in range(count):
                b = WINDOW[i % len(WINDOW)]
                reg.histogram(name).observe(total / count, b[0] + shift + 0.1 + 0.3 * i / count)
    monkeypatch.setattr(core_metrics, "metrics", reg)
    return reg


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_spans(name, monkeypatch):
    read = cell.reader(name)
    _registry(monkeypatch, SPANS)
    assert read({"window_batches": WINDOW}) == pytest.approx(WANT[name])
    # no batches in the window, as in an untraced http run
    assert read({"window_batches": []}) is None
    # a program that records the parents alone, or nothing
    _registry(monkeypatch, {n: SPANS[n] for n in PARENTS})
    assert read({"window_batches": WINDOW}) is None
    _registry(monkeypatch, {})
    assert read({"window_batches": WINDOW}) is None


def test_a_registry_without_between_reads_none(monkeypatch):
    """A registry without ``between`` (older versions of the program): every
    reader is silent."""
    reg = _registry(monkeypatch, SPANS)
    monkeypatch.setattr(core_metrics, "metrics", type("Old", (), {"histogram": reg.histogram})())
    assert all(cell.reader(n)({"window_batches": WINDOW}) is None for n in WANT)


def test_a_ring_that_dropped_part_of_the_window_reads_none(monkeypatch):
    monkeypatch.setattr(core_metrics, "RECENT", 24)
    _registry(monkeypatch, SPANS)
    # queue waits overran the ring; the per-batch spans still fit
    assert cell.reader("queue_wait_ms.http")({"window_batches": WINDOW}) is None
    assert cell.reader("tokenize_ms.http")({"window_batches": WINDOW}) == pytest.approx(WANT["tokenize_ms.http"])


@pytest.mark.parametrize("workload", sorted(CELL_METRICS))
def test_traced_tiny_run_reports_the_leaf_metrics(tiny_spec, tiny_scale, workload):
    out = cell.run(tiny_spec(workload), 2**31 + 4321, 1.0, True, "cpu", time.perf_counter(), scale=tiny_scale)
    line = out["line"]
    assert line["correct"], out["verdict"].notes
    metrics = line["metrics"]
    assert CELL_METRICS[workload] <= set(metrics)
    assert all(metrics[n]["value"] >= 0 and metrics[n]["unit"] == "ms" for n in CELL_METRICS[workload])
