"""The served batch's spans in the port's ``core/metrics`` registry.

A fused ``search_batch`` records each of its leaf spans once (the encoder's
``embed.*``, the fused step's ``step.*``, hydration's ``hydrate.*`` and the
store's ``store.gunzip``); the leaves inside ``fused_embed`` and
``fused_device`` add up to no more than their parent; under
``torch.profiler`` each contiguous leaf is a ``user_annotation`` range and
the parents and the summed spans are not. ``BatchingQueue`` records one
``batch.queue_wait`` per request, from ``submit`` to its batch's start.

The engine serves, on the CPU, the artifacts and store that the JAX package
built (``torch_engine_fixtures.art``).
"""

import asyncio
import json
import time

import pytest
import torch
from torch_engine_fixtures import CASES, art  # noqa: F401  (fixture)

from trie_semantic_search_tpu_torch.api import batching
from trie_semantic_search_tpu_torch.api.batching import BatchingQueue
from trie_semantic_search_tpu_torch.core.config import Config
from trie_semantic_search_tpu_torch.core.metrics import MetricsRegistry, metrics
from trie_semantic_search_tpu_torch.index.builder import load_artifacts
from trie_semantic_search_tpu_torch.search.engine import SearchEngine, SearchQuery
from trie_semantic_search_tpu_torch.search.fused import FusedHybridSearch
from trie_semantic_search_tpu_torch.storage.store import StorageManager

torch.set_num_threads(1)

PARENTS = ("search_batch", "fused_embed", "fused_device")
#: contiguous leaves, which are also profiler ranges, by fused path
RANGES = {
    "brute": ("embed.tokenize", "embed.forward", "step.trie_walk", "step.inputs", "step.run",
              "hydrate.meta_select", "hydrate.text_select", "hydrate.results"),
}
RANGES["stream"] = RANGES["brute"]
RANGES["probe"] = RANGES["brute"] + ("step.escalate",)
#: spans summed over a batch or a store call, recorded into the registry only
SUMMED = ("store.gunzip", "hydrate.sentences", "hydrate.snippet")
ALL = sorted(set(PARENTS) | set(RANGES["probe"]) | set(SUMMED) | {"batch.queue_wait"})


def _texts(n: int) -> list[str]:
    """``n`` distinct queries: case names, citations and phrases of the
    fixture's texts, each with its own suffix so that no cache answers."""
    base = [c[0] for c in CASES] + [c[1] for c in CASES] + [" ".join(c[4].split()[3:9]) for c in CASES]
    return [f"{base[i % len(base)]} {i}" for i in range(n)]


def _engine(art, path: str, monkeypatch) -> SearchEngine:  # noqa: F811
    """A fresh port engine on one fused path: ``brute``, ``stream`` (the
    partitioned mode past its break-even, which the fixture's four
    partitions always are) or ``probe`` (the partitioned mode held below
    it)."""
    cfg = Config.from_file(art["toml"])
    cfg.search.fused_ann_mode = "brute" if path == "brute" else "partitioned"
    cfg.search.enable_query_cache = False
    if path == "probe":
        monkeypatch.setattr(FusedHybridSearch, "_layout_brute_batch", lambda self, B: False)
    return SearchEngine(cfg, StorageManager(cfg.storage), *load_artifacts(cfg, device="cpu"), device="cpu")


def _spans() -> dict:
    return {n: (metrics.histogram(n).count, metrics.histogram(n).total_ms) for n in ALL}


def _delta(before: dict) -> dict:
    now = _spans()
    return {n: (now[n][0] - before[n][0], now[n][1] - before[n][1]) for n in ALL}


@pytest.mark.parametrize("B", [8, 64])
@pytest.mark.parametrize("path", ["brute", "stream", "probe"])
def test_a_fused_batch_records_each_span_once(art, path, B, monkeypatch):  # noqa: F811
    eng = _engine(art, path, monkeypatch)
    before = _spans()
    t0 = time.perf_counter()
    out = eng.search_batch([SearchQuery(query=t) for t in _texts(B)])
    t1 = time.perf_counter()
    d = _delta(before)
    assert len(out) == B and any(out)
    want = set(PARENTS) | set(RANGES[path]) | set(SUMMED)
    assert {n: c for n, (c, _) in d.items() if c} == dict.fromkeys(want, 1)
    # the registry tells the same of the batch's stretch after the fact
    after = metrics.between(t0, t1)
    assert {n: after[n] for n in after if n in ALL and after[n][0]} == {n: d[n] for n in want}
    # the leaves add up to no more than their parents
    ms = {n: t for n, (_, t) in d.items()}
    assert ms["embed.tokenize"] + ms["embed.forward"] <= ms["fused_embed"]
    assert sum(ms[n] for n in RANGES[path] if n.startswith("step.")) <= ms["fused_device"]
    hydrate = ms["search_batch"] - ms["fused_embed"] - ms["fused_device"]
    assert ms["hydrate.meta_select"] + ms["hydrate.text_select"] + ms["hydrate.results"] <= hydrate
    assert ms["hydrate.sentences"] + ms["hydrate.snippet"] <= ms["hydrate.results"]
    assert ms["store.gunzip"] <= ms["hydrate.text_select"]


@pytest.mark.parametrize("path", ["brute", "stream", "probe"])
def test_leaves_are_profiler_ranges_and_parents_are_not(art, path, monkeypatch, tmp_path):  # noqa: F811
    from torch.profiler import ProfilerActivity, profile

    eng = _engine(art, path, monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.search_batch([SearchQuery(query=t) for t in _texts(8)])
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert {n: names.count(n) for n in set(names) & set(ALL)} == dict.fromkeys(RANGES[path], 1)


def test_a_leaf_outside_a_profiler_is_a_registry_entry_only():
    from trie_semantic_search_tpu_torch.core import metrics as core_metrics

    assert core_metrics._profiler_range("x") is None
    reg = MetricsRegistry()
    with reg.leaf("x"):
        time.sleep(0.01)
    with reg.leaf("x"):
        pass
    h = reg.histogram("x")
    assert h.count == 2 and h.total_ms >= 10.0
    assert set(reg.snapshot()) == {"counters", "latency"}


def test_between_reads_a_stretch_only_while_the_ring_holds_it(monkeypatch):
    from trie_semantic_search_tpu_torch.core import metrics as core_metrics

    monkeypatch.setattr(core_metrics, "RECENT", 8)
    reg = MetricsRegistry()
    for i in range(20):
        reg.histogram("x").observe(1.0 + i, float(i))
    reg.histogram("y").observe(5.0, 14.0)
    # x keeps the observations that ended at 12 to 19
    assert reg.between(12.0, 15.5) == {"x": (4, 13.0 + 14.0 + 15.0 + 16.0), "y": (1, 5.0)}
    assert reg.between(11.5, 15.5) == {"y": (1, 5.0)}
    assert reg.between(20.0, 30.0) == {"x": (0, 0), "y": (0, 0)}
    assert reg.histogram("x").count == 20


def test_queue_wait_is_recorded_once_per_request(monkeypatch):
    """``inflight=1``, a slow ``run_batch`` and two batches' worth of
    requests: the second batch waits for the whole first run."""
    reg = MetricsRegistry()
    monkeypatch.setattr(batching, "metrics", reg)
    runs = []

    def run_batch(items):
        t0 = time.perf_counter()
        time.sleep(0.2)
        runs.append((len(items), time.perf_counter() - t0))
        return [f"r{i}" for i in items]

    async def go():
        bq = BatchingQueue(run_batch, max_batch=4, window_ms=2, inflight=1)
        await bq.start()
        out = await asyncio.gather(*(bq.submit(i) for i in range(8)))
        await bq.stop()
        return out, bq.stats

    out, stats = asyncio.new_event_loop().run_until_complete(go())
    assert out == [f"r{i}" for i in range(8)]
    assert [n for n, _ in runs] == [4, 4]
    assert set(stats) == {"batches", "items", "ghosts_dropped", "shed", "batch_failures"}
    h = reg.histogram("batch.queue_wait")
    assert h.count == 8
    waits = h._samples  # sorted: the first batch's four, then the second's
    assert all(w >= runs[0][1] * 1000 for w in waits[4:])
    assert all(w < runs[0][1] * 1000 for w in waits[:4])
