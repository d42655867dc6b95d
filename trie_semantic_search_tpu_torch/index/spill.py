"""External-sort build of the content trie: the streaming build's spill.

Port of ``trie_semantic_search_tpu/index/spill.py``. The pooled trie
builder holds every node resident while it builds; this module keeps the
content trie off the resident set:

* **spill**: each content window becomes one fixed-width record
  ``[window tokens (-1 padded), case_row, para]`` in a buffer that
  ``flush`` writes to ``spill_<shard>.npy`` at each checkpoint of the
  streaming build; only the token → id vocabulary stays resident (and is
  written beside, for a resume).
* **sort**: ``finalize`` sorts each run in memory and caches it
  (``sorted_<shard>.npy``), then merges the runs k-way with a pivot bound,
  stably, so equal windows keep stream order (the postings order of the
  pooled builder).
* **build**: the sorted order is the trie's DFS pre-order, so the CSR
  arrays come out of one pass over it, into memmaps under
  ``work_dir/csr`` (the native pass): bitwise :meth:`~.trie.TrieBuilder.freeze` over the same
  windows.

The windowing replays ``TrieIndex.insert_content`` (``word_tokens``,
``_phrase_start_positions``, the window and per-paragraph caps). The pass
is the native library's :func:`..native.csr_from_sorted_windows`, writing
straight into the memmaps, as in the JAX package; where the library does
not load, or no window was spilled, it is :func:`csr_from_sorted_windows_py`,
bitwise the same, whose outputs stay in RAM, as there.
:attr:`SpillContentBuilder.csr_route` says which ran.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .. import native as _native
from ..core.config import TrieConfig
from .trie import FrozenTrie, TrieBuilder, _phrase_start_positions, word_tokens

_log = logging.getLogger("tss_torch.spill")

_VOCAB_FILE = "spill_vocab.json"


def csr_from_sorted_windows_py(W: np.ndarray, rows: np.ndarray, paras: np.ndarray) -> dict[str, np.ndarray]:
    """The frozen trie's CSR arrays from windows ``W [n, L]`` (-1 padded)
    sorted lexicographically, with their postings ``rows``/``paras``, in
    one pass: each window adds the nodes past its common prefix with the
    one before."""
    n, L = W.shape
    if n == 0:
        empty = TrieBuilder().freeze()
        return {f: getattr(empty, f) for f in FrozenTrie._ARRAY_FIELDS}
    depth = np.argmax(W < 0, axis=1)
    depth[(W >= 0).all(axis=1)] = L
    cpl = np.zeros(n, np.int64)  # common prefix length with the row before
    if n > 1:
        eq = W[1:] == W[:-1]
        run = np.argmin(eq, axis=1)
        run[eq.all(axis=1)] = L
        cpl[1:] = np.minimum(run, depth[1:])
    num_nodes = int(1 + (depth - cpl).sum())

    parent = np.full(num_nodes, -1, np.int32)
    in_token = np.full(num_nodes, -1, np.int32)
    child_count = np.zeros(num_nodes, np.int64)
    post_count = np.zeros(num_nodes, np.int64)
    is_end = np.zeros(num_nodes, bool)
    frequency = np.zeros(num_nodes, np.int32)
    post_case = np.asarray(rows, np.int32).copy()
    post_para = np.asarray(paras, np.int32).copy()

    stack = np.zeros(L + 1, np.int32)
    next_id = 1
    for i in range(n):
        d, c = int(depth[i]), int(cpl[i])
        for t in range(c, d):
            parent[next_id] = stack[t]
            in_token[next_id] = W[i, t]
            child_count[stack[t]] += 1
            stack[t + 1] = next_id
            next_id += 1
        term = stack[d]
        is_end[term] = True
        frequency[term] += 1
        post_count[term] += 1

    edge_offsets = np.zeros(num_nodes + 1, np.int32)
    edge_offsets[1:] = np.cumsum(child_count)
    n_edges = num_nodes - 1
    edge_tokens = np.zeros(max(n_edges, 1), np.int32)
    edge_targets = np.zeros(max(n_edges, 1), np.int32)
    fill = np.zeros(num_nodes, np.int64)
    for nid in range(1, num_nodes):
        p = parent[nid]
        e = edge_offsets[p] + fill[p]
        fill[p] += 1
        edge_tokens[e] = in_token[nid]
        edge_targets[e] = nid
    post_offsets = np.zeros(num_nodes + 1, np.int32)
    post_offsets[1:] = np.cumsum(post_count)

    size = np.ones(num_nodes, np.int64)
    for nid in range(num_nodes - 1, 0, -1):
        size[parent[nid]] += size[nid]
    span_end = np.arange(num_nodes, dtype=np.int64) + size - 1
    subtree_post_end = post_offsets[span_end + 1].astype(np.int32)
    return {
        "edge_offsets": edge_offsets,
        "edge_tokens": edge_tokens[:n_edges],
        "edge_targets": edge_targets[:n_edges],
        "post_offsets": post_offsets,
        "post_case": post_case,
        "post_para": post_para,
        "subtree_post_end": subtree_post_end,
        "is_end": is_end,
        "frequency": frequency,
    }


def _void_keys(W: np.ndarray, L: int) -> np.ndarray:
    """One comparable scalar per window row: tokens shifted by +1 (the -1
    pad becomes 0) and packed big-endian, so that byte order equals
    ``np.lexsort``'s column order."""
    return (
        np.ascontiguousarray((W[:, :L].astype(np.int64) + 1).astype(">u4"))
        .view(f"|V{4 * L}")
        .ravel()
    )


class _RunReader:
    """Reads one sorted ``.npy`` run with ``seek`` + ``read``, not a memmap:
    the merge reads every run once, and mapped pages would count in the
    process's resident set while plain reads are served from the page
    cache."""

    def __init__(self, path: Path):
        self.f = open(path, "rb")
        ver = np.lib.format.read_magic(self.f)
        if ver == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(self.f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(self.f)
        assert not fortran and dtype == np.int32
        self.n, self.width = int(shape[0]), int(shape[1])
        self._off = self.f.tell()
        self._rowbytes = 4 * self.width

    def read(self, lo: int, hi: int) -> np.ndarray:
        self.f.seek(self._off + lo * self._rowbytes)
        buf = self.f.read((hi - lo) * self._rowbytes)
        return np.frombuffer(buf, np.int32).reshape(hi - lo, self.width)

    def key_at(self, i: int, L: int) -> bytes:
        # bytes compare by memcmp, the keys' order (void scalars do not compare)
        return _void_keys(self.read(i, i + 1), L)[0].tobytes()

    def advance_to(self, c: int, pivot: bytes, L: int) -> int:
        """The first index ``>= c`` whose key exceeds ``pivot``: galloping,
        then one binary search in the block that holds it."""
        n, lo, step = self.n, c, 4096
        while lo < n:
            hi = min(n, lo + step)
            if self.key_at(hi - 1, L) <= pivot:
                lo = hi
                step *= 2
                continue
            ks = _void_keys(self.read(lo, hi), L)
            pv = np.frombuffer(pivot, dtype=ks.dtype)
            return lo + int(np.searchsorted(ks, pv, side="right")[0])
        return n

    def close(self) -> None:
        self.f.close()


def _npy_stream_writer(path: Path, dtype, shape: tuple):
    """``path`` opened as a streaming ``.npy`` writer: the header now, the
    data by plain ``write()`` after (its pages belong to the page cache,
    not this process, as a filled memmap's would)."""
    f = open(path, "wb")
    np.lib.format.write_array_header_1_0(f, {
        "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
        "fortran_order": False,
        "shape": shape,
    })
    return f


def _lexsorted(a: np.ndarray, L: int) -> np.ndarray:
    """Rows of ``a`` in stable lexicographic order of their first ``L``
    columns."""
    return a[np.lexsort(tuple(a[:, c] for c in range(L - 1, -1, -1)))]


class SpillContentBuilder:
    """Disk-spilled builder of the content trie (module docstring)."""

    def __init__(self, work_dir: str | Path, config: Optional[TrieConfig] = None, resume: bool = True):
        self.config = config or TrieConfig()
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.window = self.config.content_window
        self.max_windows = self.config.max_windows_per_paragraph
        self.mode = self.config.content_windowing
        self.vocab: dict[str, int] = {}
        self._buf: list[np.ndarray] = []
        self._buf_rows = 0
        self.total_windows = 0
        #: seconds of the last :meth:`finalize`'s three phases
        self.finalize_seconds: dict[str, float] = {}
        vpath = self.work_dir / _VOCAB_FILE
        if resume and vpath.exists():
            d = json.loads(vpath.read_text())
            self.vocab = d["vocab"]
            self.total_windows = int(d.get("total_windows", 0))
        elif not resume:
            vpath.unlink(missing_ok=True)
            for p in (*self.work_dir.glob("spill_*.npy"), *self.work_dir.glob("sorted_*.npy")):
                p.unlink()

    # -- build time ------------------------------------------------------------

    def _ids(self, toks: Sequence[str]) -> list[int]:
        vocab = self.vocab
        out = []
        for t in toks:
            tid = vocab.get(t)
            if tid is None:
                tid = len(vocab)
                vocab[t] = tid
            out.append(tid)
        return out

    def insert_content(self, tokens: Sequence[str], case_row: int, para_idx: int = 0) -> None:
        """``TrieIndex.insert_content``'s windows, as records in the buffer."""
        toks = word_tokens(" ".join(tokens))
        if not toks:
            return
        ids = self._ids(toks)
        L = self.window
        if self.mode == "all":
            starts = list(range(min(len(ids), self.max_windows)))
        else:
            starts = _phrase_start_positions(toks, self.mode)[: self.max_windows]
        recs = np.full((len(starts), L + 2), -1, np.int32)
        for r, s in enumerate(starts):
            w = ids[s : s + L]
            recs[r, : len(w)] = w
            recs[r, L] = case_row
            recs[r, L + 1] = para_idx
        self._buf.append(recs)
        self._buf_rows += len(starts)
        self.total_windows += len(starts)

    def flush(self, shard_name: str) -> None:
        """Write the buffered windows to ``spill_<shard>.npy`` and the vocab
        beside (replaced atomically): called at each checkpoint, keyed by
        the shard the manifest records."""
        recs = (np.concatenate(self._buf, axis=0) if self._buf
                else np.zeros((0, self.window + 2), np.int32))
        np.save(self.work_dir / f"spill_{shard_name}.npy", recs)
        self._buf = []
        self._buf_rows = 0
        vpath = self.work_dir / _VOCAB_FILE
        tmp = vpath.with_suffix(".tmp")
        tmp.write_text(json.dumps({"vocab": self.vocab, "total_windows": self.total_windows}))
        tmp.replace(vpath)

    def discard_buffer(self) -> None:
        """Drop the records not flushed yet (a resume streams them again)."""
        self._buf = []
        self._buf_rows = 0

    # -- finalize --------------------------------------------------------------

    def finalize(self, shard_names: Sequence[str], merge_block_rows: int = 1 << 19) -> FrozenTrie:
        """Sort every spilled window and build the frozen content trie with
        O(block) resident memory. Only the spill files of ``shard_names``
        (the manifest's shards, in stream order) take part. Three phases,
        each safe to run again after a crash, timed in
        :attr:`finalize_seconds`:

        1. ``run_sort``: each spill file sorts alone (stable) and is cached
           as ``sorted_<shard>.npy``, which a later finalize reuses unless
           the spill file is newer;
        2. ``merge``: rounds bounded by a pivot, the smallest
           ``cursor + merge_block_rows``-th key over the runs: each run
           gives its rows up to the pivot, the gathered block (runs in
           stream order) sorts stably and is appended to
           ``sorted_windows/rows/paras.npy``;
        3. ``csr``: the native :func:`..native.csr_from_sorted_windows`
           over the merged arrays, its outputs memmaps under
           ``work_dir/csr`` (:func:`csr_from_sorted_windows_py`, in RAM,
           where the library does not load or nothing was spilled).
        """
        L = self.window
        t0 = time.perf_counter()
        run_paths: list[Path] = []
        total = 0
        for name in shard_names:
            p = self.work_dir / f"spill_{name}.npy"
            if not p.exists():
                continue
            sp = self.work_dir / f"sorted_{name}.npy"
            if not sp.exists() or sp.stat().st_mtime < p.stat().st_mtime:
                a = np.load(p)
                if len(a):
                    a = np.ascontiguousarray(_lexsorted(a, L))
                tmp = self.work_dir / f"sorted_{name}.tmp"
                with open(tmp, "wb") as f:
                    np.save(f, a)
                tmp.replace(sp)
            with open(sp, "rb") as f:
                ver = np.lib.format.read_magic(f)
                shape = (np.lib.format.read_array_header_1_0(f) if ver == (1, 0)
                         else np.lib.format.read_array_header_2_0(f))[0]
            if shape[0]:
                run_paths.append(sp)
                total += int(shape[0])
        t1 = time.perf_counter()

        w_path = self.work_dir / "sorted_windows.npy"
        r_path = self.work_dir / "sorted_rows.npy"
        p_path = self.work_dir / "sorted_paras.npy"
        if total:
            runs = [_RunReader(p) for p in run_paths]
            cursors = [0] * len(runs)
            fw = _npy_stream_writer(w_path, np.int32, (total, L))
            fr = _npy_stream_writer(r_path, np.int32, (total,))
            fp = _npy_stream_writer(p_path, np.int32, (total,))
            active = list(range(len(runs)))
            written = 0
            while active:
                pivot = min(runs[i].key_at(min(cursors[i] + merge_block_rows, runs[i].n) - 1, L)
                            for i in active)
                parts = []
                still = []
                for i in active:  # run order is stream order (stability)
                    e = runs[i].advance_to(cursors[i], pivot, L)
                    if e > cursors[i]:
                        parts.append(runs[i].read(cursors[i], e))
                        cursors[i] = e
                    if cursors[i] < runs[i].n:
                        still.append(i)
                active = still
                blk = parts[0] if len(parts) == 1 else np.concatenate(parts)
                if len(blk) > 1:
                    blk = _lexsorted(blk, L)
                fw.write(np.ascontiguousarray(blk[:, :L]).tobytes())
                fr.write(np.ascontiguousarray(blk[:, L]).tobytes())
                fp.write(np.ascontiguousarray(blk[:, L + 1]).tobytes())
                written += len(blk)
            for rd in runs:
                rd.close()
            for f in (fw, fr, fp):
                f.close()
            assert written == total, (written, total)
            W = np.load(w_path, mmap_mode="r")
            rows = np.load(r_path, mmap_mode="r")
            paras = np.load(p_path, mmap_mode="r")
        else:
            W = np.zeros((0, L), np.int32)
            rows = np.zeros(0, np.int32)
            paras = np.zeros(0, np.int32)
        t2 = time.perf_counter()

        # the native pass fills disk-backed memmaps (~21 B/node + 8 B/posting,
        # GBs at CAP scale, stay off the resident set)
        csr_dir = self.work_dir / "csr"
        csr_dir.mkdir(parents=True, exist_ok=True)

        def _alloc(name: str, shape: tuple, dtype) -> np.ndarray:
            return np.lib.format.open_memmap(csr_dir / f"{name}.npy", mode="w+", dtype=dtype, shape=shape)

        arrays = None
        if total:
            arrays = _native.csr_from_sorted_windows(W, rows, paras, alloc=_alloc)
        self.csr_route = "python" if arrays is None else "native"
        if arrays is None:
            arrays = csr_from_sorted_windows_py(np.asarray(W), np.asarray(rows), np.asarray(paras))
        else:
            for a in arrays.values():  # flush dirty pages; reopen lazily
                if isinstance(a, np.memmap):
                    a.flush()
        id_to_token = [""] * len(self.vocab)
        for tok, tid in self.vocab.items():
            id_to_token[tid] = tok
        self.finalize_seconds = {"run_sort": t1 - t0, "merge": t2 - t1, "csr": time.perf_counter() - t2}
        _log.info(
            "spill finalize: %d windows -> %d nodes, %d postings (run sort %.2fs, merge %.2fs, "
            "csr %.2fs, %s)", total, len(arrays["is_end"]), total, *self.finalize_seconds.values(),
            self.csr_route,
        )
        return FrozenTrie(vocab=dict(self.vocab), id_to_token=id_to_token, **arrays)
