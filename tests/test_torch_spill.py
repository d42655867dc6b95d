"""The port's spill-built content trie against the JAX package's, on the CPU.

The same content stream goes through the port's ``SpillContentBuilder`` and
the JAX package's, both on the Python CSR pass or both on the native one:
the frozen arrays and the vocab must be bitwise equal, and
equal to the port's pooled builder (``TrieIndex.insert_content`` +
``freeze``) over the same stream. Resume, the sorted-run cache, a k-way
merge of many rounds and ``set_content_frozen`` are held as the JAX
package's own spill tests hold them.
"""

import numpy as np
import pytest
import torch

import trie_semantic_search_tpu.native as jax_native
from trie_semantic_search_tpu.core.config import TrieConfig as JaxTrieConfig
from trie_semantic_search_tpu.index import spill as jspill
from trie_semantic_search_tpu_torch.core.config import TrieConfig
from trie_semantic_search_tpu_torch.index import spill as tspill
from trie_semantic_search_tpu_torch.index.trie import FrozenTrie, TrieIndex

from torch_trie_backend import BACKENDS, force_trie_backend

torch.set_num_threads(1)

SENTS = [
    ("the defendant was convicted of fraud in the district court", 0, 0),
    ("the district court denied the motion to suppress evidence", 0, 1),
    ("evidence obtained by unlawful search is inadmissible", 1, 0),
    ("the defendant was convicted of fraud in the district court", 2, 0),
    ("a police officer may stop and frisk upon reasonable suspicion", 2, 1),
    ("the motion to suppress was denied by the district court", 3, 0),
]


def _random_sents(seed=3, n=40):
    """``n`` sentences over six words, 30% exact copies of an earlier one
    (equal windows across runs: the merge's stability)."""
    rng = np.random.default_rng(seed)
    vocab = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    sents = []
    for row in range(n):
        if row and rng.random() < 0.3:
            text = sents[rng.integers(0, len(sents))][0]
        else:
            text = " ".join(rng.choice(vocab, size=rng.integers(4, 12)))
        sents.append((text, row, int(rng.integers(0, 3))))
    return sents


def _configs(mode, window=8):
    return (TrieConfig(content_windowing=mode, content_window=window),
            JaxTrieConfig(content_windowing=mode, content_window=window))


def _pooled(cfg, sents) -> FrozenTrie:
    idx = TrieIndex(cfg, device="cpu")
    for text, row, para in sents:
        idx.insert_content(text.split(), row, para)
    idx.freeze()
    return idx.content_trie


def _spilled(module, cfg, sents, work, flush_every=2, merge_block_rows=1 << 19):
    sp = module.SpillContentBuilder(work, cfg, resume=False)
    names = []
    for i, (text, row, para) in enumerate(sents):
        sp.insert_content(text.split(), row, para)
        if (i + 1) % flush_every == 0:
            names.append(f"s{len(names):03d}")
            sp.flush(names[-1])
    if sp._buf:
        names.append(f"s{len(names):03d}")
        sp.flush(names[-1])
    return sp.finalize(names, merge_block_rows=merge_block_rows), names


def _assert_same(got, want):
    assert got.vocab == want.vocab
    assert list(got.id_to_token) == list(want.id_to_token)
    for f in FrozenTrie._ARRAY_FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(params=BACKENDS)
def trie_backend(request, monkeypatch):
    """Both packages' spills (and pooled builders) on the same backend: the
    Python CSR pass, or the native one writing into the memmaps."""
    force_trie_backend(monkeypatch, request.param)
    return request.param


@pytest.mark.parametrize("mode", ["all", "phrase_start", "sentence_start"])
@pytest.mark.parametrize("stream", ["legal", "random"])
def test_spill_finalize_matches_jax_and_pooled(tmp_path, trie_backend, mode, stream):
    """Arrays and vocab bitwise the JAX package's spill and, windowing
    every token or phrase starts, the port's pooled builder over the same
    stream (with sentence starts the spill's vocab also holds the tokens
    past the first window, in both packages); the native pass writes its
    outputs as memmaps under ``work_dir/csr``, the Python pass keeps them
    in RAM, as the JAX package's passes do."""
    sents = SENTS if stream == "legal" else _random_sents()
    tcfg, jcfg = _configs(mode)
    got, names = _spilled(tspill, tcfg, sents, tmp_path / "port")
    want, _ = _spilled(jspill, jcfg, sents, tmp_path / "jax")
    _assert_same(got, want)
    if mode != "sentence_start":
        _assert_same(got, _pooled(tcfg, sents))
    native = trie_backend == "native"
    assert isinstance(got.post_case, np.memmap) == native
    assert (tmp_path / "port" / "csr" / "post_case.npy").exists() == native
    assert isinstance(want.post_case, np.memmap) == native
    assert sorted(p.name for p in (tmp_path / "port").glob("*.npy")) == sorted(
        p.name for p in (tmp_path / "jax").glob("*.npy"))
    assert set(tspill.SpillContentBuilder(tmp_path / "port", tcfg).vocab) == set(got.vocab)


def test_python_csr_matches_jax_python_and_native():
    """``csr_from_sorted_windows_py`` over sorted random windows (random
    suffix padding) is bitwise the JAX package's Python pass, and its
    native pass where the library loads."""
    rng = np.random.default_rng(3)
    n, L = 500, 8
    W = rng.integers(0, 12, (n, L)).astype(np.int32)
    for i in range(n):
        W[i, rng.integers(1, L + 1):] = -1
    W = np.ascontiguousarray(W[np.lexsort(tuple(W[:, c] for c in range(L - 1, -1, -1)))])
    rows = rng.integers(0, 50, n).astype(np.int32)
    paras = rng.integers(0, 5, n).astype(np.int32)
    got = tspill.csr_from_sorted_windows_py(W, rows, paras)
    want = jspill.csr_from_sorted_windows_py(W, rows, paras)
    assert got.keys() == want.keys()
    for f in want:
        assert got[f].dtype == np.asarray(want[f]).dtype, f
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)
    if jax_native.available():
        native = jax_native.csr_from_sorted_windows(W, rows, paras)
        for f in native:
            np.testing.assert_array_equal(got[f], native[f], err_msg=f)
    empty = tspill.csr_from_sorted_windows_py(np.zeros((0, L), np.int32), np.zeros(0, np.int32),
                                              np.zeros(0, np.int32))
    for f, a in jspill.csr_from_sorted_windows_py(np.zeros((0, L), np.int32), np.zeros(0, np.int32),
                                                  np.zeros(0, np.int32)).items():
        np.testing.assert_array_equal(empty[f], np.asarray(a), err_msg=f)


@pytest.mark.parametrize("block", [1, 4, 7])
def test_multi_round_merge_matches_jax(tmp_path, trie_backend, block):
    """A tiny ``merge_block_rows`` forces many pivot rounds and galloping
    over eight or more runs: bitwise the JAX package's and the pooled
    builder's, duplicates across runs in stream order."""
    sents = _random_sents()
    tcfg, jcfg = _configs("all")
    got, names = _spilled(tspill, tcfg, sents, tmp_path / "port", flush_every=5, merge_block_rows=block)
    want, _ = _spilled(jspill, jcfg, sents, tmp_path / "jax", flush_every=5, merge_block_rows=block)
    assert len(names) >= 8
    _assert_same(got, want)
    _assert_same(got, _pooled(tcfg, sents))


def test_resume_keeps_vocab_and_shards(tmp_path):
    """The vocab persists at each flush; records not flushed are dropped
    (``discard_buffer`` or a new builder), and the stream again from the
    watermark gives the trie of an uninterrupted spill."""
    tcfg, _ = _configs("phrase_start")
    d = tmp_path / "spill"
    sp = tspill.SpillContentBuilder(d, tcfg, resume=False)
    sp.insert_content(SENTS[0][0].split(), 0, 0)
    sp.insert_content(SENTS[1][0].split(), 0, 1)
    sp.flush("s000")
    vocab_at_ckpt = dict(sp.vocab)
    sp.insert_content(SENTS[2][0].split(), 1, 0)  # never flushed: the crash
    assert sp._buf_rows > 0
    sp.discard_buffer()
    assert sp._buf == [] and sp._buf_rows == 0

    sp2 = tspill.SpillContentBuilder(d, tcfg, resume=True)
    assert sp2.vocab == vocab_at_ckpt and sp2._buf == []
    for text, row, para in SENTS[2:]:
        sp2.insert_content(text.split(), row, para)
    sp2.flush("s001")
    resumed = sp2.finalize(["s000", "s001"])
    oracle, _ = _spilled(tspill, tcfg, SENTS, tmp_path / "oracle", flush_every=3)
    _assert_same(resumed, oracle)
    _assert_same(resumed, _pooled(tcfg, SENTS))
    fresh = tspill.SpillContentBuilder(d, tcfg, resume=False)
    assert fresh.vocab == {} and not list(d.glob("spill_*.npy")) and not list(d.glob("sorted_*.npy"))


def test_sorted_run_cache_survives_a_resumed_finalize(tmp_path, trie_backend):
    """A second finalize over the same shards reuses the cached sorted runs
    (their mtimes unchanged) and gives the same arrays; shards left out of
    the manifest's list are left out, as in the JAX package."""
    tcfg, jcfg = _configs("all")
    sp = tspill.SpillContentBuilder(tmp_path / "spill", tcfg, resume=False)
    jp = jspill.SpillContentBuilder(tmp_path / "jax", jcfg, resume=False)
    names = []
    for i, (text, row, para) in enumerate(SENTS):
        sp.insert_content(text.split(), row, para)
        jp.insert_content(text.split(), row, para)
        names.append(f"s{i:03d}")
        sp.flush(names[-1])
        jp.flush(names[-1])
    a = sp.finalize(names, merge_block_rows=2)
    assert set(sp.finalize_seconds) == {"run_sort", "merge", "csr"}
    assert sp.csr_route == trie_backend
    mtimes = {p.name: p.stat().st_mtime_ns for p in (tmp_path / "spill").glob("sorted_s*.npy")}
    assert len(mtimes) == len(SENTS)
    b = tspill.SpillContentBuilder(tmp_path / "spill", tcfg, resume=True).finalize(names, merge_block_rows=2)
    assert mtimes == {p.name: p.stat().st_mtime_ns for p in (tmp_path / "spill").glob("sorted_s*.npy")}
    _assert_same(a, b)
    _assert_same(sp.finalize(names[:3]), jp.finalize(names[:3]))


def test_set_content_frozen_survives_freeze(tmp_path):
    """``freeze()`` keeps an installed content trie (names and citations
    still freeze from their builders); it serves lookups, and a later
    insert rehydrates the builder from it instead of dropping it."""
    tcfg, _ = _configs("all")
    content, _ = _spilled(tspill, tcfg, SENTS, tmp_path)
    idx = TrieIndex(tcfg, device="cpu")
    idx.insert_case_name("Mapp v. Ohio", 0)
    idx.set_content_frozen(content)
    idx.freeze()
    assert idx.content_trie is content
    assert idx.name_trie.num_postings == 1
    rows, valid = idx.search_batch_rows(["district court"])
    assert {0, 2, 3} <= set(rows[0][valid[0]].tolist())
    idx.insert_content("entirely new content sentence".split(), 9, 0)
    idx.freeze()
    rows, valid = idx.search_batch_rows(["district court"])
    assert {0, 2, 3} <= set(rows[0][valid[0]].tolist())
    rows, valid = idx.search_batch_rows(["entirely new content"])
    assert 9 in rows[0][valid[0]].tolist()


def test_empty_finalize_matches_jax(tmp_path, trie_backend):
    """Shards with no content windows finalize to the empty trie, as the
    JAX package's do."""
    tcfg, jcfg = _configs("all")
    sp = tspill.SpillContentBuilder(tmp_path / "p", tcfg, resume=False)
    sp.flush("s000")
    jp = jspill.SpillContentBuilder(tmp_path / "j", jcfg, resume=False)
    jp.flush("s000")
    _assert_same(sp.finalize(["s000", "missing"]), jp.finalize(["s000", "missing"]))
