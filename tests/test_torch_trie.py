"""Tries built and saved by the JAX package give the port identical
``search_batch_rows`` rows and validity flags; the port's own builder
freezes to the same arrays, also after ``load_from_disk`` and further
inserts (builder rehydration)."""

import numpy as np
import pytest
import torch

from trie_semantic_search_tpu.core.config import TrieConfig as JaxTrieConfig
from trie_semantic_search_tpu.index.trie import TrieBuilder as JaxTrieBuilder
from trie_semantic_search_tpu.index.trie import TrieIndex as JaxTrieIndex
from trie_semantic_search_tpu_torch.core.config import TrieConfig
from trie_semantic_search_tpu_torch.index.trie import (
    FrozenTrie,
    TrieBuilder,
    TrieIndex,
)

from torch_trie_backend import BACKENDS, force_trie_backend

torch.set_num_threads(1)

WORDS = [f"w{i}" for i in range(40)] + ["v.", "ohio", "state", "the", "of"]


def _corpus(seed=0, n_cases=120):
    rng = np.random.default_rng(seed)
    names, cites, paras = [], [], []
    for row in range(n_cases):
        names.append(" ".join(rng.choice(WORDS, rng.integers(2, 5))) + " v. ohio")
        cites.append(f"{row % 37} U.S. {row * 3 + 1} (19{50 + row % 50})")
        paras.append([str(w) for w in rng.choice(WORDS, rng.integers(4, 14))])
    return names, cites, paras


def _queries(names, cites, paras, seed=1):
    rng = np.random.default_rng(seed)
    qs = [names[i] for i in rng.integers(0, len(names), 10)]
    qs += [cites[i] for i in rng.integers(0, len(cites), 6)]
    qs += [" ".join(paras[i][1:4]) for i in rng.integers(0, len(paras), 8)]
    qs += ["w1", "ohio", "", "unknownword", " ".join(["w1"] * 20), "W2 w3", "v. ohio"]
    return qs


@pytest.mark.parametrize("mmap_format", [True, False])
def test_search_batch_rows_matches_jax_saved_trie(tmp_path, mmap_format):
    names, cites, paras = _corpus()
    jcfg = JaxTrieConfig(enable_memory_mapping=mmap_format, max_windows_per_paragraph=6)
    jidx = JaxTrieIndex(jcfg)
    for row, (n, c, p) in enumerate(zip(names, cites, paras)):
        jidx.insert_case_name(n, row)
        jidx.insert_citation(c, row)
        jidx.insert_content(p, row, 0)
    jidx.freeze()
    jidx.save_to_disk(tmp_path)
    tidx = TrieIndex.load_from_disk(
        tmp_path, TrieConfig(enable_memory_mapping=mmap_format), device="cpu"
    )
    qs = _queries(names, cites, paras)
    for batch in (qs[:1], qs[:7], qs):
        for max_postings in (64, 4):
            jr, jv = jidx.search_batch_rows(batch, max_postings=max_postings)
            tr, tv = tidx.search_batch_rows(batch, max_postings=max_postings)
            np.testing.assert_array_equal(tr, np.asarray(jr))
            np.testing.assert_array_equal(tv, np.asarray(jv))
    assert tidx.get_completions("w1") == jidx.get_completions("w1")
    # freeze() after a bare load keeps the loaded state; an insert rehydrates
    tidx.freeze()
    np.testing.assert_array_equal(tidx.search_batch_rows(qs)[0], np.asarray(jidx.search_batch_rows(qs)[0]))
    tidx.insert_case_name("new case", 0)
    tidx.freeze()
    assert tidx.search_batch_rows(["new case"])[0][0, 0] == 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("windowing", ["all", "phrase_start", "sentence_start"])
def test_port_builder_freezes_like_jax(windowing, backend, monkeypatch):
    """Both packages on the same trie backend (the native one assigns token
    ids per paragraph, the Python one per window, so the vocab depends on
    it): every frozen array and the vocab equal."""
    force_trie_backend(monkeypatch, backend)
    names, cites, paras = _corpus(seed=3, n_cases=60)
    jidx = JaxTrieIndex(JaxTrieConfig(content_windowing=windowing, max_windows_per_paragraph=5))
    tidx = TrieIndex(TrieConfig(content_windowing=windowing, max_windows_per_paragraph=5), device="cpu")
    for row, (n, c, p) in enumerate(zip(names, cites, paras)):
        for idx in (jidx, tidx):
            idx.insert_case_name(n, row)
            idx.insert_citation(c, row)
            idx.insert_content(p + ["of", "the", "w7"], row, 1)
    jidx.freeze()
    tidx.freeze()
    for attr in ("name_trie", "citation_trie", "content_trie"):
        a, b = getattr(tidx, attr), getattr(jidx, attr)
        for field in FrozenTrie._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.vocab == b.vocab
    qs = _queries(names, cites, paras, seed=5)
    jr, jv = jidx.search_batch_rows(qs)
    tr, tv = tidx.search_batch_rows(qs)
    np.testing.assert_array_equal(tr, np.asarray(jr))
    np.testing.assert_array_equal(tv, np.asarray(jv))


def test_empty_trie_walks_to_no_hits():
    jf = JaxTrieBuilder().freeze()
    tf = TrieBuilder().freeze()
    ids = tf.encode_queries([["a"], []], 4)
    np.testing.assert_array_equal(ids, jf.encode_queries([["a"], []], 4))
    nodes, rows, valid = tf.walk_and_gather(ids, torch.device("cpu"), 3)
    _, jrows, jvalid = jf.search_batch(ids, 3)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    assert not valid.numpy().any()


def _insert_more(idx, names, cites, paras, start):
    for row, (n, c, p) in enumerate(zip(names, cites, paras), start=start):
        idx.insert_case_name(n, row)
        idx.insert_citation(c, row)
        idx.insert_content(p + ["new", "words", f"x{row}"], row, 2)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mmap_format", [True, False])
def test_insert_after_load_matches_jax(tmp_path, mmap_format, backend, monkeypatch):
    """Both packages, on the same trie backend, load the same saved tries,
    insert the same cases and freeze: every frozen array and the vocab are
    equal (the native backend rehydrates by replaying the paths). A bare
    round trip (rehydrate, no insert, freeze) gives the loaded arrays
    back."""
    force_trie_backend(monkeypatch, backend)
    names, cites, paras = _corpus(seed=7, n_cases=80)
    jcfg = JaxTrieConfig(enable_memory_mapping=mmap_format, max_windows_per_paragraph=6)
    src = JaxTrieIndex(jcfg)
    _insert_more(src, names[:50], cites[:50], paras[:50], 0)
    src.freeze()
    src.save_to_disk(tmp_path)
    jidx = JaxTrieIndex.load_from_disk(tmp_path, jcfg)
    tidx = TrieIndex.load_from_disk(
        tmp_path, TrieConfig(enable_memory_mapping=mmap_format, max_windows_per_paragraph=6),
        device="cpu",
    )
    for attr in ("name_trie", "citation_trie", "content_trie"):
        f = getattr(tidx, attr)
        again = TrieBuilder.from_frozen(f).freeze()
        for field in FrozenTrie._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(again, field), getattr(f, field))
    for idx in (jidx, tidx):
        _insert_more(idx, names[50:], cites[50:], paras[50:], 50)
        idx.freeze()
    for attr in ("name_trie", "citation_trie", "content_trie"):
        a, b = getattr(tidx, attr), getattr(jidx, attr)
        for field in FrozenTrie._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=f"{attr}.{field}")
        assert a.vocab == b.vocab
        assert a.num_postings > getattr(src, attr).num_postings
    qs = _queries(names, cites, paras, seed=9)
    np.testing.assert_array_equal(tidx.search_batch_rows(qs)[0], np.asarray(jidx.search_batch_rows(qs)[0]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_set_content_frozen_matches_jax(backend, monkeypatch):
    """An externally built content trie survives freeze(); a later content
    insert rehydrates its builder first, in both packages, on either trie
    backend."""
    force_trie_backend(monkeypatch, backend)
    names, cites, paras = _corpus(seed=11, n_cases=30)
    jb, tb = JaxTrieBuilder(), TrieBuilder()
    for row, p in enumerate(paras):
        jb.insert(p, row, 0)
        tb.insert(p, row, 0)
    jidx, tidx = JaxTrieIndex(JaxTrieConfig()), TrieIndex(TrieConfig(), device="cpu")
    jidx.set_content_frozen(jb.freeze())
    tidx.set_content_frozen(tb.freeze())
    for idx in (jidx, tidx):
        idx.insert_case_name(names[0], 0)
        idx.freeze()
    for field in FrozenTrie._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tidx.content_trie, field), getattr(jidx.content_trie, field))
    for idx in (jidx, tidx):
        idx.insert_content(["w1", "w2", "fresh"], 31, 0)
        idx.freeze()
    for field in FrozenTrie._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tidx.content_trie, field), getattr(jidx.content_trie, field))
    assert tidx.content_trie.vocab == jidx.content_trie.vocab
