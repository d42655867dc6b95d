"""The plain reference against the port at a small size on the CPU, and the
check that decides ``correct``: a sound run passes it, the reference in
float8 put in the program's place fails it, and so does a run whose timed
path is broken underneath (an answer altered where it is produced; half of
each batch left out)."""

from __future__ import annotations

import itertools
import time

import pytest
import torch

from benchmark import cell, data, encoders, sut
from benchmark.reference import wordpiece

ENC = {"arch": "bert", "family": "minilm-l6", "hidden_size": 384, "num_hidden_layers": 6, "num_attention_heads": 12,
       "intermediate_size": 1536, "vocab_size": 30522, "max_position_embeddings": 512, "type_vocab_size": 2,
       "layer_norm_eps": 1e-12}


@pytest.fixture(scope="module")
def texts_and_vocab():
    lex = data.lexicon()
    cases = data.make_cases(4096, 4, 3, lex)
    mix = cell.load_spec("minilm-l6.http-steady").traffic
    qs = [q.text for q in data.make_queries(mix, 48, cases, 3)] + ["Ünïcode, punctuation: (x) v. y!", "a" * 120]
    return qs, data.vocabulary(lex, ENC["vocab_size"])


def test_wordpiece_matches_the_port(texts_and_vocab):
    from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer

    qs, vocab = texts_and_vocab
    tok = WordPieceTokenizer(vocab)
    for t in qs:
        ids, mask = tok.encode(t, 512)
        assert wordpiece.token_ids(t, vocab, 512) == ids[: sum(mask)]


def test_reference_encoder_matches_the_port(texts_and_vocab):
    qs, vocab = texts_and_vocab
    plugin = encoders.load(ENC)
    ids = [wordpiece.token_ids(t, vocab, 512) for t in qs]
    ref = plugin.reference_embeddings(torch, ENC, 5, ids, "cpu")
    emb = sut.build_embedder(plugin.build_model(torch, ENC, 5, "cpu"), vocab, "cpu")
    bf16 = torch.as_tensor(emb.embed(qs).embedding)
    emb.model.compute_dtype = torch.float32
    f32 = torch.as_tensor(emb.embed(qs).embedding)
    # the same function: float32 agrees to rounding, the served bf16 within
    # its precision, and the float8 control falls well outside that
    assert (f32 - ref).abs().max() < 2e-5
    gap_bf16 = (bf16 - ref).abs().max()
    fp8 = plugin.reference_embeddings(torch, ENC, 5, ids, "cpu", "fp8")
    assert gap_bf16 < 5e-3
    assert (fp8 - ref).abs().max() > 4 * gap_bf16


@pytest.fixture()
def run_tiny(tiny_spec, tiny_scale):
    def run(workload, fault=None, control=False, trace_on=False):
        return cell.run(tiny_spec(workload), 2**31 + 12345, 1.0, trace_on, "cpu", time.perf_counter(),
                        scale=tiny_scale, fault=fault, control=control)

    return run


def test_sound_run_is_correct_and_the_control_is_not(run_tiny):
    out = run_tiny("legal-bert.bulk-256", control=True)
    line, limits = out["line"], out["numbers"]
    assert line["correct"], out["verdict"].notes
    assert out["verdict"].results > 0 and line["metrics"]["recall_at_10"]["value"] > 0.5
    assert 0 < limits["score_gap"]["value"] < limits["score_gap"]["limit"] / 3
    # the reference in float8 in the program's place fails the score limit
    assert out["control"]["score_gap"] > limits["score_gap"]["limit"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def _altered(search_batch):
    def run(queries):
        out = search_batch(queries)
        for rs in out:
            for r in rs:
                if r.match_type.value == "semantic":
                    r.score += 0.02
                else:
                    r.case_metadata.court = "Court 99"
        return out

    return run


def _half_left_out(search_batch):
    def run(queries):
        out = search_batch(queries)
        return [rs if i % 2 == 0 else [] for i, rs in enumerate(out)]

    return run


@pytest.mark.parametrize("fault", [_altered, _half_left_out], ids=["answer_altered", "half_batch_left_out"])
def test_a_broken_timed_path_is_not_correct(run_tiny, fault):
    out = run_tiny("legal-bert.bulk-256", fault=fault)
    assert not out["line"]["correct"]


def _semantic_half_left_out(search_batch):
    # every other query served, counted across batches: the http cell's
    # batches at the tests' rate often hold one query
    served = itertools.count()

    def run(queries):
        out = search_batch(queries)
        return [rs if next(served) % 2 == 0 else [r for r in rs if r.match_type.value != "semantic"]
                for rs in out]

    return run


@pytest.mark.parametrize("workload", ["legal-bert.bulk-256", "minilm-l6.http-steady"])
def test_semantic_results_left_out_fall_past_the_recall_bound(run_tiny, workload):
    """Every lexical hit kept, the semantic stage's results left out for
    half of the queries: ``correct`` need not see it (an approximate stage
    may miss), so ``recall_at_10`` has to fall by more than its bound,
    from a sound run that finds every planted case."""
    import json

    bound = next(m["bound"] for m in json.loads((cell.ROOT / "BENCHMARK.json").read_text())["end_to_end"]
                 if m["name"] == "recall_at_10")
    sound = run_tiny(workload)["line"]["metrics"]["recall_at_10"]["value"]
    broken = run_tiny(workload, fault=_semantic_half_left_out)["line"]["metrics"]["recall_at_10"]["value"]
    assert sound == 1.0
    assert broken < sound * (1 - bound)


def test_http_cell_runs_and_checks(run_tiny):
    out = run_tiny("minilm-l6.http-steady", trace_on=True)
    line = out["line"]
    assert line["correct"], out["verdict"].notes
    assert line["attempted"] >= 10 and line["failed"] == 0
    assert {"p50_ms.http", "batch_mean.http", "embed_ms.http", "hydrate_ms.http"} <= set(line["metrics"])
    assert line["device"]["window_s"] > 0
    assert list(line)[-1] == "checks"
