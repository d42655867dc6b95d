"""The port's native host library against the JAX package's, on the CPU.

Both libraries build from the same C++ (the port's copy in
``csrc/host/``), so the text helpers, the WordPiece encoder, the trie pool
and the sorted-window CSR pass must give the JAX library's results bit for
bit. ``FastTrieBuilder`` round trips on both backends; two processes that
start together in an empty build directory build one library. On
paragraphs that run past their last content window the native builders
assign ids to the tokens past it; the port's default ``TrieIndex``,
``build_indexes`` and streaming build then write the JAX package's
default arrays and vocab, and with both packages forced to the Python
backend they agree as well.
"""

import datetime as dt
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_build import _configs, _encoders, _write_store

import trie_semantic_search_tpu.native as jnative
from trie_semantic_search_tpu.core.config import TrieConfig as JaxTrieConfig
from trie_semantic_search_tpu.core.types import CaseMetadata as JaxCaseMetadata
from trie_semantic_search_tpu.index import spill as jspill
from trie_semantic_search_tpu.index.builder import build_indexes as jax_build_indexes
from trie_semantic_search_tpu.index.streaming import StreamingIndexBuilder as JaxStreamingBuilder
from trie_semantic_search_tpu.index.trie import TrieIndex as JaxTrieIndex
from trie_semantic_search_tpu.models.embedder import Embedder as JaxEmbedder
from trie_semantic_search_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from trie_semantic_search_tpu.storage.store import StorageManager as JaxStorage
from trie_semantic_search_tpu_torch import native
from trie_semantic_search_tpu_torch.core.config import TrieConfig
from trie_semantic_search_tpu_torch.core.types import CaseMetadata
from trie_semantic_search_tpu_torch.index import spill as tspill
from trie_semantic_search_tpu_torch.index.builder import build_indexes
from trie_semantic_search_tpu_torch.index.streaming import StreamingIndexBuilder
from trie_semantic_search_tpu_torch.index.trie import FastTrieBuilder, FrozenTrie, TrieBuilder, TrieIndex
from trie_semantic_search_tpu_torch.models.embedder import Embedder
from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer, train_wordpiece_vocab
from trie_semantic_search_tpu_torch.storage.store import StorageManager
from trie_semantic_search_tpu_torch.text.processor import count_syllables as py_syllables

from torch_trie_backend import BACKENDS, force_trie_backend

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TRIES = ("name_trie", "content_trie", "citation_trie")
TEXTS = [
    "The court's holding, in 347 U.S. 483 (1954), was unanimous!",
    "café naïve résumé — the défendant's 2nd appeal",
    "  leading spaces\tand\ttabs\nnewlines__under_scores x1y2 ",
    "",
]


def test_library_builds_and_loads():
    assert native.available() and jnative.available()
    assert native.LIBRARY_PATH.name == "libtss_native.so"
    assert native.BUILD_SECONDS is not None and native.BUILD_SECONDS >= 0


@pytest.mark.parametrize("text", TEXTS)
def test_tokenize_spans_matches_jax_and_regex(text):
    got = native.tokenize_spans(text)
    np.testing.assert_array_equal(got, jnative.tokenize_spans(text))
    assert got.dtype == np.int32 and got.shape[1:] == (2,)
    if text.isascii():
        assert [tuple(s) for s in got.tolist()] == [(m.start(), m.end()) for m in re.finditer(r"\w+", text)]
    # every non-ASCII character counts as a word character (the scanner
    # works on UTF-8 bytes)
    raw = text.encode("utf-8")
    words = [raw[s:e].decode("utf-8") for s, e in got.tolist()]
    assert words == re.findall(r"[\w\u0080-\U0010ffff]+", text)


def test_count_syllables_matches_jax_and_python():
    for w in ("cat", "table", "constitution", "b", "jurisprudence", "eye", "", "rhythm", "queue"):
        assert native.count_syllables(w) == jnative.count_syllables(w) == py_syllables(w), w


CORPUS = [
    "the supreme court held that due process requires notice",
    "the defendant filed a motion to suppress the evidence",
    "unreasonable searches and seizures violate the fourth amendment",
] * 3


def test_wordpiece_matches_jax_and_python():
    """``encode_word`` and ``encode_text`` against the JAX library's
    encoder and the port's Python WordPiece."""
    vocab = train_wordpiece_vocab(CORPUS, vocab_size=512, min_frequency=1)
    tok = WordPieceTokenizer(vocab)
    got, want = native.NativeWordPiece(vocab, tok.unk_id), jnative.NativeWordPiece(vocab, tok.unk_id)
    for word in ("the", "supreme", "court", "defendant", "suppress", "zzz", "amendments", "x" * 150):
        py = tok.wordpiece(word)
        py_ids = None if py == ["[UNK]"] else [vocab[p] for p in py]
        assert got.encode_word(word) == want.encode_word(word) == py_ids, word
    for text in CORPUS[:3] + ["Courts HELD xyz; the Evidence!", ""]:
        ids = got.encode_text(text)
        np.testing.assert_array_equal(ids, want.encode_text(text))
        py = [vocab.get(p, tok.unk_id) for w in re.findall(r"\w+", text.lower()) for p in tok.wordpiece(w)]
        assert ids.tolist() == py, text


def _paths(seed, n=400, n_words=40):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, n_words, rng.integers(1, 7)).astype(np.int32), int(rng.integers(0, 60)),
             int(rng.integers(0, 4))) for _ in range(n)]


def test_trie_pool_freezes_like_jax():
    """Inserts and windowed inserts into both pools: ``freeze_arrays``
    bitwise the JAX library's, and the Python builder's over the same
    paths."""
    got, want, py = native.NativeTrieBuilder(), jnative.NativeTrieBuilder(), TrieBuilder()
    py.vocab = {str(i): i for i in range(40)}  # the pools' token ids
    for ids, row, para in _paths(5):
        for b in (got, want):
            b.insert(ids, row, para)
        py.insert([str(i) for i in ids], row, para)
    long = np.random.default_rng(6).integers(0, 40, 30).astype(np.int32)
    for b in (got, want):
        b.insert_windows(long, 8, 5, 61, 2)
    for s in range(5):
        py.insert([str(i) for i in long[s : s + 8]], 61, 2)
    a, b = got.freeze_arrays(), want.freeze_arrays()
    assert a.keys() == b.keys() == set(FrozenTrie._ARRAY_FIELDS)
    for f in a:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    frozen = py.freeze()
    for f in FrozenTrie._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(frozen, f), a[f], err_msg=f)


def _sorted_windows(seed, n=600, L=8):
    rng = np.random.default_rng(seed)
    W = rng.integers(0, 12, (n, L)).astype(np.int32)
    for i in range(n):
        W[i, rng.integers(1, L + 1):] = -1
    W = np.ascontiguousarray(W[np.lexsort(tuple(W[:, c] for c in range(L - 1, -1, -1)))])
    return W, rng.integers(0, 50, n).astype(np.int32), rng.integers(0, 5, n).astype(np.int32)


@pytest.mark.parametrize("memmap", [False, True])
def test_csr_from_sorted_windows_matches_jax_and_python(tmp_path, memmap):
    """The native CSR pass, into arrays or a memmap ``alloc``, bitwise the
    JAX library's and :func:`csr_from_sorted_windows_py`."""
    W, rows, paras = _sorted_windows(3)
    alloc = None
    if memmap:
        def alloc(name, shape, dtype):
            return np.lib.format.open_memmap(tmp_path / f"{name}.npy", mode="w+", dtype=dtype, shape=shape)
    got = native.csr_from_sorted_windows(W, rows, paras, alloc=alloc)
    want = jnative.csr_from_sorted_windows(W, rows, paras)
    py = tspill.csr_from_sorted_windows_py(W, rows, paras)
    assert got.keys() == want.keys() == py.keys()
    for f in want:
        assert got[f].dtype == want[f].dtype == py[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_array_equal(got[f], py[f], err_msg=f)
        assert isinstance(got[f], np.memmap) == memmap, f
    if memmap:
        got["post_case"].flush()
        np.testing.assert_array_equal(np.load(tmp_path / "post_case.npy"), py["post_case"])


def _python_builder() -> FastTrieBuilder:
    b = FastTrieBuilder()
    b._nat, b._py = None, TrieBuilder()
    b.vocab = b._py.vocab
    return b


@pytest.mark.parametrize("backend", BACKENDS)
def test_fast_builder_round_trip(backend):
    """``freeze(load_frozen(f)) == f`` on either backend; an insert after
    the rehydration extends the trie, never wipes it; a second
    ``load_frozen`` replaces the first."""
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(40)]
    inserts = [([words[i] for i in rng.integers(0, 40, rng.integers(1, 6))], int(rng.integers(0, 50)),
                int(rng.integers(0, 4))) for _ in range(300)]
    make = FastTrieBuilder if backend == "native" else _python_builder
    b = make()
    assert b.is_native == (backend == "native")
    for path, row, para in inserts:
        b.insert(path, row, para)
    b.insert_windows(words[:25], 8, 6, 77, 1)
    frozen = b.freeze()
    b2 = make()
    b2.load_frozen(frozen)
    b2.load_frozen(frozen)
    again = b2.freeze()
    for f in FrozenTrie._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(frozen, f), getattr(again, f), err_msg=f"{backend}:{f}")
    assert frozen.vocab == again.vocab
    b2.insert(["brand", "new", "path"], 99, 0)
    assert b2.freeze().num_postings == frozen.num_postings + 1


def test_two_processes_build_one_library(tmp_path):
    """Two processes started together in one empty build directory both
    load the same library; one build, no temporary file left."""
    code = ("from trie_semantic_search_tpu_torch import native\n"
            "assert native.available()\n"
            "print(native.LIBRARY_PATH)\n")
    env = {**__import__("os").environ, "TSS_TORCH_BUILD_DIR": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    so = Path(paths.pop())
    assert so.parent.parent == tmp_path / "host" and so.exists()
    assert sorted(p.name for p in so.parent.iterdir()) == ["build.lock", "build.log", "libtss_native.so"]


# -- paragraphs past their last window ----------------------------------------------------

#: a content window and a per-paragraph cap well under the paragraphs' length
WINDOW, MAX_WINDOWS = 8, 6


def _long_paragraphs(seed, n, length):
    """Paragraphs of ``length`` tokens whose tail (past ``MAX_WINDOWS +
    WINDOW - 1``) holds words found nowhere else."""
    rng = np.random.default_rng(seed)
    head = [f"w{i}" for i in range(30)]
    out = []
    for p in range(n):
        toks = [str(w) for w in rng.choice(head, MAX_WINDOWS + WINDOW - 1)]
        toks += [f"tail{p}x{i}" for i in range(length - len(toks))]
        out.append(toks)
    return out


def _assert_same_trie(got, want, what):
    assert got.vocab == want.vocab, what
    for f in FrozenTrie._ARRAY_FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f"{what}.{f}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("default_config", [True, False], ids=["defaults", "small_cap"])
def test_long_paragraphs_trie_index_matches_jax(monkeypatch, backend, default_config):
    """``TrieIndex`` of each package over paragraphs longer than
    ``max_windows_per_paragraph + content_window`` (601 tokens under the
    default 512 + 8; 30 under 6 + 8): bitwise equal, vocab included. The
    native vocab holds the tail tokens, the Python one does not."""
    force_trie_backend(monkeypatch, backend)
    if default_config:
        tcfg, jcfg, paras = TrieConfig(), JaxTrieConfig(), _long_paragraphs(1, 6, 601)
        cap = 512 + 8 - 1
    else:
        kw = dict(content_window=WINDOW, max_windows_per_paragraph=MAX_WINDOWS)
        tcfg, jcfg, paras = TrieConfig(**kw), JaxTrieConfig(**kw), _long_paragraphs(2, 20, 30)
        cap = MAX_WINDOWS + WINDOW - 1
    t, j = TrieIndex(tcfg, device="cpu"), JaxTrieIndex(jcfg)
    assert t.backend == backend
    for idx in (t, j):
        for row, toks in enumerate(paras):
            idx.insert_content(toks, row, row % 3)
            idx.insert_case_name(" ".join(toks[:3]), row)
        idx.freeze()
    for name in TRIES:
        _assert_same_trie(getattr(t, name), getattr(j, name), name)
    tail = {w for toks in paras for w in toks[cap:]}
    assert tail and (tail <= set(t.content_trie.vocab)) == (backend == "native")
    assert not tail & set(t.content_trie.vocab) or backend == "native"


def _long_cases(n=12):
    rng = np.random.default_rng(9)
    out = []
    for i in range(n):
        sents = []
        for j in range(2):
            head = " ".join(rng.choice([f"w{k}" for k in range(30)], 10))
            sents.append(f"{head.capitalize()} " + " ".join(f"t{i}x{j}y{k}" for k in range(20)) + ".")
        out.append((f"Alpha{i} v. Beta{i}", f"{i} U.S. {100 + i} (1970)", "Court 1",
                    dt.date(1970, 1, 1) + dt.timedelta(days=97 * i), " ".join(sents)))
    return out


def _long_stores(tmp_path, tag, cases):
    jcfg, pcfg = _configs(tmp_path, tag)
    pcfg.storage.db_path = str(tmp_path / f"{tag}_port.sqlite")
    for c in (jcfg, pcfg):
        c.trie.content_window = WINDOW
        c.trie.max_windows_per_paragraph = MAX_WINDOWS
        c.vector.hnsw.tune_on_build = False
    jstore = _write_store(JaxStorage, JaxCaseMetadata, jcfg.storage.db_path, cases)
    pstore = _write_store(StorageManager, CaseMetadata, pcfg.storage.db_path, cases)
    vocab, params, mcfg, model = _encoders(cases)
    jemb = JaxEmbedder(jcfg.vector.model, tokenizer=JaxTokenizer(vocab), params=params, model_config=mcfg)
    pemb = Embedder(pcfg.vector.model, tokenizer=WordPieceTokenizer(vocab), model=model, device="cpu")
    return (jcfg, jstore, jemb), (pcfg, pstore, pemb)


@pytest.mark.parametrize("backend", BACKENDS)
def test_long_paragraphs_builds_match_jax(tmp_path, monkeypatch, caplog, backend):
    """``build_indexes`` and the streaming build (content spill on) of each
    package over cases whose sentences run past their last window: the
    three tries bitwise equal, vocab included; the port's builds log their
    backend, and the spill's CSR pass runs natively unless the Python
    backend is forced. On the native backend the one-shot build's content
    trie is the streamed one."""
    force_trie_backend(monkeypatch, backend)
    cases = _long_cases()
    (jcfg, jstore, jemb), (pcfg, pstore, pemb) = _long_stores(tmp_path, "b", cases)
    with caplog.at_level("INFO"):
        jb = jax_build_indexes(jstore, jcfg, embedder=jemb)
        pb = build_indexes(pstore, pcfg, embedder=pemb, device="cpu")
        js = JaxStreamingBuilder(jstore, jcfg, embedder=jemb, work_dir=tmp_path / "jwork",
                                 shard_chunks=8).build()
        ps = StreamingIndexBuilder(pstore, pcfg, embedder=pemb, work_dir=tmp_path / "pwork",
                                   shard_chunks=8, device="cpu").build()
    for name in TRIES:
        _assert_same_trie(getattr(pb.trie, name), getattr(jb.trie, name), f"build_indexes {name}")
        _assert_same_trie(getattr(ps.trie, name), getattr(js.trie, name), f"streaming {name}")
    lines = [r.getMessage() for r in caplog.records if r.name.startswith("tss_torch")]
    assert lines.count(f"trie builder: {backend}") == 2, lines
    assert any(m.startswith("spill finalize") and m.endswith(f", {backend})") for m in lines), lines
    if backend == "native":
        _assert_same_trie(pb.trie.content_trie, ps.trie.content_trie, "one-shot vs streamed")
        assert any(w.startswith("t0x0y19") for w in pb.trie.content_trie.vocab)


def test_spill_python_pass_matches_jax_on_long_paragraphs(tmp_path, monkeypatch):
    """With the library forced off in both packages, the spill's Python
    pass over long paragraphs is the JAX package's."""
    force_trie_backend(monkeypatch, "python")
    kw = dict(content_window=WINDOW, max_windows_per_paragraph=MAX_WINDOWS)
    frozen = []
    for mod, cfg in ((tspill, TrieConfig(**kw)), (jspill, JaxTrieConfig(**kw))):
        sp = mod.SpillContentBuilder(tmp_path / mod.__name__, cfg, resume=False)
        for row, toks in enumerate(_long_paragraphs(4, 10, 30)):
            sp.insert_content(toks, row, 0)
        sp.flush("s000")
        frozen.append(sp.finalize(["s000"]))
    _assert_same_trie(frozen[0], frozen[1], "spill")
