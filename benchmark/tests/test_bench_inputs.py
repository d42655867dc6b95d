"""The yardstick's own arithmetic: seeded generators, percentiles over
every request, whole-window rates, counts from shapes, the module check."""

from __future__ import annotations

import json
import math
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from benchmark import cell, costs, data, readers

ROOT = Path(__file__).resolve().parents[2]
MIX = json.loads((ROOT / "benchmark" / "traffic" / "http-steady.json").read_text())


@pytest.fixture(scope="module")
def cases():
    return data.make_cases(4096, 4, 11)


def test_queries_repeat_per_seed_and_keep_their_sizes(cases):
    a = data.make_queries(MIX, 600, cases, 7)
    b = data.make_queries(MIX, 600, cases, 7)
    c = data.make_queries(MIX, 600, cases, 8)
    assert [q.body() for q in a] == [q.body() for q in b]
    assert [q.text for q in a] != [q.text for q in c]
    assert len({q.text for q in a}) == len(a)

    def sizes(qs):
        return Counter((q.kind, len(q.text.split()) if q.kind == "semantic" else 0,
                        bool(q.court_filter), bool(q.date_range)) for q in qs)

    # the same multiset of kinds and phrase lengths whatever the seed
    assert Counter((q.kind, len(q.text.split()) if q.kind == "semantic" else 0) for q in a) == \
        Counter((q.kind, len(q.text.split()) if q.kind == "semantic" else 0) for q in c)
    assert sum(bool(q.court_filter) for q in a) == sum(bool(q.court_filter) for q in c) == 60
    assert sizes(a) == sizes(b)


def test_named_queries_name_their_case(cases):
    for q in data.make_queries(MIX, 120, cases, 3):
        if q.kind == "name":
            assert q.text == cases.name(q.target)
        elif q.kind == "citation":
            assert q.text == cases.citation(q.target)


def test_arrivals_offer_the_same_gaps_every_seed():
    a, b, c = data.arrivals(200.0, 1000, 1), data.arrivals(200.0, 1000, 1), data.arrivals(200.0, 1000, 2)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.allclose(np.sort(np.diff(np.r_[0, a])), np.sort(np.diff(np.r_[0, c])), atol=1e-9) or \
        math.isclose(a[-1], c[-1], rel_tol=1e-9)
    assert abs(len(a) / a[-1] - 200.0) < 5.0


def test_cases_and_corpus_repeat_per_seed():
    import torch

    a, b = data.make_cases(512, 4, 5), data.make_cases(512, 4, 5)
    assert [a.name(c) for c in range(512)] == [b.name(c) for c in range(512)]
    assert len({a.name(c) for c in range(512)}) == 512
    assert len({data.citation(c) for c in range(100_000)}) == 100_000
    x = [v for _p, _c, v in data.corpus_slabs(torch, 64, 32, 16, 9, "cpu")]
    y = [v for _p, _c, v in data.corpus_slabs(torch, 64, 32, 16, 9, "cpu")]
    assert all(torch.equal(u, v) for u, v in zip(x, y))


def test_percentile_counts_every_request_and_failures_as_slowest():
    lat = [float(i) for i in range(1, 101)]
    assert costs.percentile(lat, 95) == 95.0
    assert costs.percentile(lat, 50) == 50.0
    # six failures among a hundred: the 95th percentile is a failure
    assert costs.percentile(lat[:94] + [math.inf] * 6, 95) == math.inf
    assert costs.percentile(lat[:96] + [math.inf] * 4, 95) == 95.0
    obs = {"latencies_ms": [1.0] * 90 + [math.inf] * 10, "cfg": {"serving": {"failed_request_ms": 65000}}}
    assert readers.latency_percentile(obs, 95) == 65000


def test_rates_are_whole_window():
    qps = cell.reader("qps")
    assert qps({"answered": 2560, "window_s": 20.48}) == 125.0
    assert cell.reader("batch_mean.http")({"batcher": {"items": 300, "batches": 20}}) == 15.0
    spans = {"search_batch": (10, 3000.0), "fused_embed": (10, 400.0), "fused_device": (10, 600.0)}
    assert cell.reader("hydrate_ms.bulk")({"spans": spans}) == 200.0
    assert cell.reader("embed_ms.http")({"spans": spans}) == 40.0


def test_counts_from_shapes():
    enc = {"arch": "bert", "hidden_size": 384, "intermediate_size": 1536, "num_hidden_layers": 6}
    # one 10-token query: per layer 2*(4*384^2 + 2*384*1536) per token plus 4*n^2*H
    want = 6 * (10 * 2 * (4 * 384 * 384 + 2 * 384 * 1536) + 4 * 100 * 384)
    assert costs.encoder_flops(enc, [10]) == want
    assert costs.probe_bytes(3, 1024, 384) == 3 * 1024 * 388
    assert costs.stream_bytes(5120, 1024, 384) == 5120 * 1024 * 388
    assert costs.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4


def test_module_check_compares_whole_top_level_names():
    mods = ["trie_semantic_search_tpu_torch", "trie_semantic_search_tpu_torch.search.engine", "jaxtyping",
            "numpy", "flaxen"]
    assert cell.forbidden_modules(mods) == []
    assert cell.forbidden_modules(mods + ["trie_semantic_search_tpu.ops"]) == ["trie_semantic_search_tpu"]
    assert cell.forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_planted_rows_sit_at_their_cosine():
    import torch

    g = torch.Generator().manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(32, 64, generator=g) + 3.0, dim=1)
    mu = torch.nn.functional.normalize(q.mean(0), dim=0)
    tau = torch.linspace(0.55, 0.9, 32)
    r = data.plant_targets(torch, q, tau, mu, g, 0.5)
    assert torch.allclose((r * q).sum(1), tau, atol=1e-4)
    assert torch.allclose(r.norm(dim=1), torch.ones(32), atol=1e-5)
