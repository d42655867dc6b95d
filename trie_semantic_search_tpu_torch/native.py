"""ctypes bindings for the native (C++) host library.

Port of ``trie_semantic_search_tpu/native.py``: the same C interface, built
from this package's own copy of the sources (``csrc/host/trie_builder.cpp``
and ``csrc/host/text_native.cpp``), so both packages run the same code:

  * :func:`tokenize_spans` / :func:`count_syllables` — text hot loops
  * :class:`NativeWordPiece` — greedy longest-match subword encoder
  * :class:`NativeTrieBuilder` — the CSR trie pool, bit-identical to the
    Python :class:`~.index.trie.TrieBuilder`
  * :func:`csr_from_sorted_windows` — the frozen CSR arrays of a sorted
    window matrix in one pass, into caller-allocated (memmap) buffers

This is host code, not a device kernel. The library builds at first use
with ``g++`` (the flags of the JAX package's ``native/Makefile``) into
``_build/host/<digest>/`` beside the kernel library (or under
``$TSS_TORCH_BUILD_DIR``); the digest covers the sources, the flags, the
compiler's version and the targets ``-march=native`` resolves to. The
build writes a temporary file and renames it into place under a file
lock, so processes that start together build once. Every caller gates on
:func:`available`, which logs the compiler's output and returns False when
the build fails.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_log = logging.getLogger("tss_torch.native")

_SRC_DIR = Path(__file__).resolve().parent / "csrc" / "host"
_SOURCES = ("text_native.cpp", "trie_builder.cpp")
_CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-Wall"]
_LIB_NAME = "libtss_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
#: set by the first successful load: the library's path and the seconds the
#: load took (the build included when it had to build)
LIBRARY_PATH: Optional[Path] = None
BUILD_SECONDS: Optional[float] = None

_i8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def build_dir() -> Path:
    """``host/`` under the kernel library's build directory:
    ``$TSS_TORCH_BUILD_DIR`` or ``_build`` inside the package."""
    env = os.environ.get("TSS_TORCH_BUILD_DIR")
    base = Path(env) if env else Path(__file__).resolve().parent / "_build"
    return base / "host"


def _compiler_identity(cxx: str) -> bytes:
    """``g++ --version`` and the target options ``-march=native`` enables
    here: a library built for another CPU is never reused."""
    out = b""
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        r = subprocess.run([cxx, *args], capture_output=True, timeout=60)
        out += r.stdout
    return out


def _build() -> Optional[Path]:
    """Build (once per digest) and return the library's path, or None."""
    cxx = shutil.which("g++")
    if cxx is None:
        _log.warning("native build failed: no C++ compiler (g++) on PATH")
        return None
    try:
        h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
        for name in _SOURCES:
            h.update((_SRC_DIR / name).read_bytes())
        h.update(_compiler_identity(cxx))
        out = build_dir() / h.hexdigest()[:16]
        so = out / _LIB_NAME
        if so.exists():
            return so
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if so.exists():  # another process built it while we waited
                return so
            tmp = out / f"libtss_native.{os.getpid()}.so"
            r = subprocess.run(
                [cxx, *_CXXFLAGS, "-o", str(tmp), *[str(_SRC_DIR / s) for s in _SOURCES]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300,
            )
            (out / "build.log").write_text(r.stdout)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                _log.warning("native build failed (exit %d):\n%s", r.returncode, r.stdout)
                return None
            os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, OSError) as e:
        _log.warning("native build failed: %s", e)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, LIBRARY_PATH, BUILD_SECONDS
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        t0 = time.perf_counter()
        path = _build()
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _log.warning("native load failed: %s", e)
            _load_failed = True
            return None
        # signatures
        lib.tss_tokenize_spans.restype = ctypes.c_int64
        lib.tss_tokenize_spans.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _i32p, _i32p, ctypes.c_int64,
        ]
        lib.tss_count_syllables.restype = ctypes.c_int32
        lib.tss_count_syllables.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.tss_wp_create.restype = ctypes.c_void_p
        lib.tss_wp_create.argtypes = [
            ctypes.c_char_p, _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        ]
        lib.tss_wp_free.argtypes = [ctypes.c_void_p]
        lib.tss_wp_encode_word.restype = ctypes.c_int64
        lib.tss_wp_encode_word.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, _i32p, ctypes.c_int64,
        ]
        lib.tss_wp_encode_text.restype = ctypes.c_int64
        lib.tss_wp_encode_text.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, _i32p, ctypes.c_int64,
        ]
        lib.tss_tb_create.restype = ctypes.c_void_p
        lib.tss_tb_free.argtypes = [ctypes.c_void_p]
        lib.tss_tb_insert.argtypes = [
            ctypes.c_void_p, _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.tss_tb_insert_windows.argtypes = [
            ctypes.c_void_p, _i32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.tss_tb_sizes.argtypes = [ctypes.c_void_p, _i64p]
        lib.tss_tb_freeze.argtypes = [ctypes.c_void_p] + [_i32p] * 6 + [_i32p, _i8p, _i32p]
        lib.tss_csr_count.restype = ctypes.c_int64
        lib.tss_csr_count.argtypes = [_i32p, ctypes.c_int64, ctypes.c_int64]
        lib.tss_csr_fill.argtypes = (
            [_i32p, _i32p, _i32p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64] + [_i32p] * 6 + [_i32p, _i8p, _i32p]
        )
        _lib = lib
        LIBRARY_PATH, BUILD_SECONDS = path, time.perf_counter() - t0
        _log.info("native library loaded: %s (%.2f s)", path, BUILD_SECONDS)
        return _lib


def available() -> bool:
    return _load() is not None


def _as_i32p(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


# ---------------------------------------------------------------------------
# text kernels
# ---------------------------------------------------------------------------


def tokenize_spans(text: str, max_tokens: int = 1 << 20) -> Optional[np.ndarray]:
    """Word spans as byte offsets ``[T, 2]`` into UTF-8 text, or None when
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("utf-8")
    starts = np.empty(max_tokens, np.int32)
    ends = np.empty(max_tokens, np.int32)
    n = lib.tss_tokenize_spans(raw, len(raw), _as_i32p(starts), _as_i32p(ends), max_tokens)
    return np.stack([starts[:n], ends[:n]], axis=1)


def count_syllables(word: str) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    raw = word.encode("utf-8")
    return int(lib.tss_count_syllables(raw, len(raw)))


class NativeWordPiece:
    """Native greedy WordPiece over a frozen vocab."""

    def __init__(self, vocab: dict[str, int], unk_id: int, max_chars: int = 100):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        pieces = b"\x00".join(k.encode("utf-8") for k in vocab) + b"\x00"
        ids = np.asarray(list(vocab.values()), np.int32)
        self._h = lib.tss_wp_create(pieces, _as_i32p(ids), len(vocab), unk_id, max_chars)

    def encode_word(self, word: str, max_out: int = 128) -> Optional[list[int]]:
        """Piece ids for one (pre-lowercased) word; None = [UNK]."""
        out = np.empty(max_out, np.int32)
        raw = word.encode("utf-8")
        n = self._lib.tss_wp_encode_word(self._h, raw, len(raw), _as_i32p(out), max_out)
        if n < 0:
            return None
        return out[:n].tolist()

    def encode_text(self, text: str, max_out: int = 4096) -> np.ndarray:
        """Full tokenize+lower+wordpiece pass over raw text → piece ids."""
        out = np.empty(max_out, np.int32)
        raw = text.encode("utf-8")
        n = self._lib.tss_wp_encode_text(self._h, raw, len(raw), _as_i32p(out), max_out)
        return out[:n]

    def __del__(self):
        try:
            self._lib.tss_wp_free(self._h)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# trie builder
# ---------------------------------------------------------------------------


class NativeTrieBuilder:
    """C++ CSR trie builder with the same frozen layout as the Python one."""

    def __init__(self) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.tss_tb_create()

    def insert(self, token_ids: Sequence[int] | np.ndarray, case_row: int,
               para_idx: int = 0) -> None:
        arr = np.ascontiguousarray(token_ids, np.int32)
        self._lib.tss_tb_insert(self._h, _as_i32p(arr), len(arr), case_row, para_idx)

    def insert_windows(self, token_ids: Sequence[int] | np.ndarray, window: int,
                       max_windows: int, case_row: int, para_idx: int = 0) -> None:
        arr = np.ascontiguousarray(token_ids, np.int32)
        self._lib.tss_tb_insert_windows(
            self._h, _as_i32p(arr), len(arr), window, max_windows, case_row, para_idx
        )

    def freeze_arrays(self) -> dict[str, np.ndarray]:
        sizes = np.zeros(3, np.int64)
        self._lib.tss_tb_sizes(self._h, sizes.ctypes.data_as(_i64p))
        n_nodes, n_edges, n_posts = (int(x) for x in sizes)
        arrays = {
            "edge_offsets": np.zeros(n_nodes + 1, np.int32),
            "edge_tokens": np.zeros(max(n_edges, 1), np.int32),
            "edge_targets": np.zeros(max(n_edges, 1), np.int32),
            "post_offsets": np.zeros(n_nodes + 1, np.int32),
            "post_case": np.zeros(max(n_posts, 1), np.int32),
            "post_para": np.zeros(max(n_posts, 1), np.int32),
            "subtree_post_end": np.zeros(n_nodes, np.int32),
            "is_end": np.zeros(n_nodes, np.uint8),
            "frequency": np.zeros(n_nodes, np.int32),
        }
        self._lib.tss_tb_freeze(
            self._h,
            _as_i32p(arrays["edge_offsets"]),
            _as_i32p(arrays["edge_tokens"]),
            _as_i32p(arrays["edge_targets"]),
            _as_i32p(arrays["post_offsets"]),
            _as_i32p(arrays["post_case"]),
            _as_i32p(arrays["post_para"]),
            _as_i32p(arrays["subtree_post_end"]),
            arrays["is_end"].ctypes.data_as(_i8p),
            _as_i32p(arrays["frequency"]),
        )
        arrays["edge_tokens"] = arrays["edge_tokens"][:n_edges]
        arrays["edge_targets"] = arrays["edge_targets"][:n_edges]
        arrays["post_case"] = arrays["post_case"][:n_posts]
        arrays["post_para"] = arrays["post_para"][:n_posts]
        arrays["is_end"] = arrays["is_end"].astype(bool)
        return arrays

    def __del__(self):
        try:
            self._lib.tss_tb_free(self._h)
        except Exception:
            pass


def csr_from_sorted_windows(
    windows: np.ndarray,  # [n, L] int32, lexicographically sorted, -1 pad
    rows: np.ndarray,  # [n] int32
    paras: np.ndarray,  # [n] int32
    alloc=None,  # (name, shape, dtype) -> zero-filled ndarray-like
) -> Optional[dict[str, np.ndarray]]:
    """The frozen CSR trie arrays of a SORTED window matrix in one native
    pass, bit-identical to the pooled builders' freeze (the sorted order is
    the DFS pre-order). Returns None when the native library is unavailable
    (callers fall back to :func:`.index.spill.csr_from_sorted_windows_py`).

    ``alloc`` overrides output allocation: the streaming build passes a
    disk-backed ``np.lib.format.open_memmap`` allocator so the CSR arrays
    never join the resident set (the native pass fills caller-allocated,
    zero-initialised buffers either way)."""
    lib = _load()
    if lib is None:
        return None
    if alloc is None:
        alloc = lambda name, shape, dtype: np.zeros(shape, dtype)  # noqa: E731
    W = np.ascontiguousarray(windows, np.int32)
    r = np.ascontiguousarray(rows, np.int32)
    p = np.ascontiguousarray(paras, np.int32)
    n, L = W.shape
    num_nodes = int(lib.tss_csr_count(_as_i32p(W), n, L))
    n_edges = num_nodes - 1
    arrays = {
        "edge_offsets": alloc("edge_offsets", (num_nodes + 1,), np.int32),
        "edge_tokens": alloc("edge_tokens", (max(n_edges, 1),), np.int32),
        "edge_targets": alloc("edge_targets", (max(n_edges, 1),), np.int32),
        "post_offsets": alloc("post_offsets", (num_nodes + 1,), np.int32),
        "post_case": alloc("post_case", (max(n, 1),), np.int32),
        "post_para": alloc("post_para", (max(n, 1),), np.int32),
        "subtree_post_end": alloc("subtree_post_end", (num_nodes,), np.int32),
        "is_end": alloc("is_end", (num_nodes,), np.uint8),
        "frequency": alloc("frequency", (num_nodes,), np.int32),
    }
    lib.tss_csr_fill(
        _as_i32p(W), _as_i32p(r), _as_i32p(p), n, L, num_nodes,
        _as_i32p(arrays["edge_offsets"]),
        _as_i32p(arrays["edge_tokens"]),
        _as_i32p(arrays["edge_targets"]),
        _as_i32p(arrays["post_offsets"]),
        _as_i32p(arrays["post_case"]),
        _as_i32p(arrays["post_para"]),
        _as_i32p(arrays["subtree_post_end"]),
        arrays["is_end"].ctypes.data_as(_i8p),
        _as_i32p(arrays["frequency"]),
    )
    arrays["edge_tokens"] = arrays["edge_tokens"][:n_edges]
    arrays["edge_targets"] = arrays["edge_targets"][:n_edges]
    arrays["post_case"] = arrays["post_case"][:n]
    arrays["post_para"] = arrays["post_para"][:n]
    # zero-copy bool view (values are 0/1): a memmap allocation stays one
    arrays["is_end"] = arrays["is_end"].view(bool)
    return arrays
