"""The encoder plug-ins: the loader finds a plug-in by the configuration's
``arch`` and nothing else, and the BERT plug-in gives, for both BERT
configurations, the bits the harness gave before the plug-ins existed.

The digests were recorded from the harness before the move (one seeded
draw over the leaves, ``reference/bert.encode`` on it, in float32 and in
float8) on this scale's queries; they hold for any number of CPU threads
(read at 1, 3 and 8). The FLOP counts are those of the count the harness
had then."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest
import torch

from benchmark import cell, costs, data, encoders, sut
from benchmark.reference import wordpiece

ROOT = Path(__file__).resolve().parents[2]

#: config → (weights, f32 reference, fp8 reference, FLOPs of 2, 10, 37,
#: 128 and 512 tokens)
PINNED = {
    "minilm-l6-cap1m": ("b351e5ea2db1f679f32374dc14dcd27b", "a36af6aaa510717d25b262c53349cbfa",
                        "43d9a05107a36a72445c047ffdaef8db", 17210483712.0),
    "legal-bert-cap1m": ("48218dbb6a3771128deee328b8f34e3a", "6af1e51fe424b67b828b07295ed9df1e",
                         "4c119a345890057ccd6bf87acfe8cac2", 127361912832.0),
}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


@pytest.fixture(scope="module")
def queries():
    lex = data.lexicon()
    cases = data.make_cases(4096, 4, 3, lex)
    mix = cell.load_spec("minilm-l6.http-steady").traffic
    return lex, [q.text for q in data.make_queries(mix, 48, cases, 3)] + ["Ünïcode, punctuation: (x) v. y!", "a" * 120]


@pytest.mark.parametrize("config", sorted(PINNED))
def test_bert_plugin_gives_the_bits_it_gave_before(config, queries):
    lex, qs = queries
    enc = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())["encoder"]
    plugin = encoders.load(enc)
    want_w, want_f32, want_fp8, want_flops = PINNED[config]
    w = plugin.make_weights(torch, enc, 5, "cpu")
    assert list(w) == list(plugin.leaf_shapes(enc))
    assert all(tuple(t.shape) == s for t, s in zip(w.values(), plugin.leaf_shapes(enc).values()))
    assert digest(w.values()) == want_w
    vocab = data.vocabulary(lex, enc["vocab_size"])
    ids = [wordpiece.token_ids(t, vocab, 512) for t in qs]
    assert digest([plugin.reference_embeddings(torch, enc, 5, ids, "cpu")]) == want_f32
    assert digest([plugin.reference_embeddings(torch, enc, 5, ids, "cpu", "fp8")]) == want_fp8
    assert plugin.flops(enc, [2, 10, 37, 128, 512]) == costs.encoder_flops(enc, [2, 10, 37, 128, 512]) == want_flops
    # the port's module holds the same draw, leaf for leaf
    model = plugin.build_model(torch, enc, 5, "cpu")
    params = dict(model.named_parameters())
    assert set(params) == set(w) and all(torch.equal(params[k], w[k]) for k in w)
    assert sut.build_embedder(model, vocab, "cpu").dimension == enc["hidden_size"]


def test_the_loader_needs_an_arch_and_its_file():
    with pytest.raises(KeyError):
        encoders.load({"hidden_size": 384})
    with pytest.raises(FileNotFoundError):
        encoders.load({"arch": "no-such-arch"})
    assert encoders.load({"arch": "bert"}) is encoders.load({"arch": "bert"})


def test_listing_names_each_cells_arch_and_plugin():
    lines = cell.listing()
    assert len(lines) == len(json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
    assert all(" arch=bert encoder=benchmark/encoders/bert.py " in ln for ln in lines)
