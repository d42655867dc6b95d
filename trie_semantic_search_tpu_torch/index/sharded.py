"""Row-sharded semantic index and the per-shard partition layout.

Port of ``trie_semantic_search_tpu/index/sharded.py``.
:class:`ShardedCorpusIndex` holds the corpus (int8 + scales, and a bf16
copy) as row blocks over the mesh's data axis and answers exact top-k
queries through :func:`..parallel.collectives.sharded_int8_topk` /
``sharded_brute_topk``; :class:`.vector.VectorIndex` picks it in place of
:class:`.ann.PartitionedANN` when the data axis is > 1. Its ``save`` writes
the logical (unpadded) corpus in the JAX package's npz format, so either
package loads the other's file on any mesh size. On a mesh across
processes every process builds from the same host rows and keeps only its
own shards' blocks, as JAX's ``device_put`` places a process's addressable
shards; ``save``, which reads every shard back to the host, is refused
there, as reading a non-addressable array is in JAX.

:func:`build_sharded_partitions` lays each shard's rows out in the
partition-major blocks of the sharded-partitioned serving mode, on the
host in numpy as the JAX package does, but for the nearest-centroid
assignment (:func:`.kmeans.assign_clusters`, duplicated centroids tied to
the lower id) and the int8 quantisation, which run on a device; its arrays
are the JAX package's bit for bit.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.errors import IndexCorrupted, VectorIndexConstructionFailed
from ..device import DeviceLike, resolve_device
from ..ops.scoring import quantize_int8
from ..parallel.collectives import sharded_brute_topk, sharded_int8_topk
from ..parallel.mesh import DATA_AXIS, Mesh, pad_corpus, shard_block, shard_rows

_log = logging.getLogger("tss_torch.sharded")

#: rows quantised per step by :func:`build_sharded_partitions`
_QUANT_ROWS = 1 << 18


class ShardedCorpusIndex:
    """Row-sharded exact scan over a frozen corpus (int8 or bf16)."""

    def __init__(self, mesh: Mesh, use_int8: bool = True, row_multiple: int = 8):
        self.mesh = mesh
        self.use_int8 = use_int8
        self.row_multiple = row_multiple
        self.num_vectors = 0
        self._n_pad = 0
        # per shard (None where another process owns it)
        self._corpus: Optional[list] = None  # bf16 [Npad/S, D]
        self._corpus_q: Optional[list] = None  # int8 [Npad/S, D]
        self._corpus_scale: Optional[list] = None  # f32 [Npad/S, 1]

    @property
    def num_shards(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    def build(self, vectors: np.ndarray, seed: int = 0) -> None:
        if vectors.ndim != 2 or vectors.shape[0] == 0:
            raise VectorIndexConstructionFailed(f"need [N, D] vectors, got {vectors.shape}")
        v = np.asarray(vectors, np.float32)
        v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        padded, n = pad_corpus(v, self.mesh, self.row_multiple)
        self.num_vectors = n
        self._n_pad = padded.shape[0]
        r = self._n_pad // self.num_shards
        if self.use_int8:
            self._corpus_q = [None] * self.num_shards
            self._corpus_scale = [None] * self.num_shards
            for s in self.mesh.local_data_rows:
                q, scale = quantize_int8(shard_block(padded, self.mesh, s))
                # zero-scale the pad rows so they score exactly 0
                scale[max(0, n - s * r):] = 0.0
                self._corpus_q[s], self._corpus_scale[s] = q, scale
        self._corpus = shard_rows(padded, self.mesh, torch.bfloat16)
        _log.info("sharded corpus: %d vectors (+%d pad) over %d shards",
                  n, self._n_pad - n, self.num_shards)

    def search_brute(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact global top-k across all shards → host ``(values, rows)``.
        Pad rows never win: the scans mask rows at or past ``num_vectors``
        by global row id, and any such id left is masked here too."""
        self._require_built()
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.mesh.first_device)
        kk = min(k, self._n_pad)
        if self.use_int8:
            v, i = sharded_int8_topk(self.mesh, q, self._corpus_q, self._corpus_scale, kk,
                                     n_valid=self.num_vectors)
        else:
            v, i = sharded_brute_topk(self.mesh, q, self._corpus, kk, n_valid=self.num_vectors)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        invalid = i >= self.num_vectors
        i[invalid] = -1
        v[invalid] = -np.inf
        return v[:, :k], i[:, :k]

    # PartitionedANN-compatible surface
    def search(self, queries, k: int, nprobe: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        return self.search_brute(queries, k)

    def get_stats(self) -> dict:
        return {
            "num_vectors": self.num_vectors,
            "padded": self._n_pad,
            "shards": self.num_shards,
            "int8": self.use_int8,
        }

    def _require_built(self) -> None:
        if self._corpus is None:
            raise VectorIndexConstructionFailed("sharded index not built")

    def save(self, path) -> None:
        """Save the logical (unpadded) corpus as f16 in the JAX package's
        npz; the device layout is derived again from the loading mesh.
        Raises on a mesh across processes, where this process holds only
        its own shards."""
        self._require_built()
        if self.mesh.distributed:
            raise RuntimeError(
                "ShardedCorpusIndex.save reads every shard to the host; on a mesh across "
                f"processes rank {self.mesh.rank} holds only shards {self.mesh.local_data_rows}"
            )
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        n = self.num_vectors
        corpus = torch.cat([b.to(torch.float32).cpu() for b in self._corpus])[:n]
        np.savez_compressed(
            path,
            sharded_corpus_f16=corpus.numpy().astype(np.float16),
            use_int8=np.array(self.use_int8),
            row_multiple=np.array(self.row_multiple),
        )

    @classmethod
    def load(cls, path, mesh: Mesh) -> "ShardedCorpusIndex":
        try:
            with np.load(path, allow_pickle=False) as z:
                corpus = z["sharded_corpus_f16"].astype(np.float32)
                idx = cls(mesh, use_int8=bool(z["use_int8"]), row_multiple=int(z["row_multiple"]))
        except (KeyError, ValueError) as e:
            raise IndexCorrupted(index_type="sharded", details=str(e)) from e
        idx.build(corpus)
        return idx


def build_sharded_partitions(
    v: np.ndarray,  # [Npad, D] L2-normalised f32; pad rows (>= n_valid) zero
    n_valid: int,
    num_shards: int,
    centroids: np.ndarray,  # [P, D] f32 GLOBAL k-means centroids
    chunk_court: np.ndarray,  # [Npad] int32 court id per chunk
    chunk_date: np.ndarray,  # [Npad] int32 date per chunk
    lanes: int = 128,
    overalloc: float = 2.0,
    device: DeviceLike = None,
) -> dict:
    """Partition a row-sharded corpus PER SHARD against shared global
    centroids (the sharded-partitioned serving mode): every shard assigns
    its rows to the same P partitions, so probing partition p scans p's
    members on every shard. Rows stay on their shard, so the capacity cap
    and the overflow rebalance of :mod:`.ann` apply per shard. Host arrays:

      * ``part_rows [S, P, m]`` — SHARD-LOCAL row per slot (-1 pad),
      * ``part_int8 [S, P, m, D]`` / ``part_scale [S, P, m]`` — per-row
        symmetric int8 (scale 0 on pads),
      * ``part_cword/part_cbit/part_date [S, P, m]`` — partition-major
        filter columns for the probe kernel (``part_cbit`` uint32; pad
        slots: word -1, date INT32_MIN, so no filter passes),

    with ``m`` the largest partition fill over all shards, padded to a
    ``lanes`` multiple (the probe kernel's rule), and ``seconds`` by stage
    (assign, rebalance, quantise, layout). The nearest-centroid assignment
    and the quantisation run on ``device`` (default ``"cuda"``). Every
    shard's layout is computed (``m`` depends on all of them); on a mesh
    across processes each process then places only its own shards'."""
    from .ann import _capacity_cap, _rebalance_overflow
    from .kmeans import assign_clusters

    Npad, D = v.shape
    S = num_shards
    if Npad % S:
        raise VectorIndexConstructionFailed(f"padded rows {Npad} not divisible by {S} shards")
    shard_n = Npad // S
    P = centroids.shape[0]
    cent = np.asarray(centroids, np.float32)
    seconds: dict[str, float] = {}
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        t = time.perf_counter()
        seconds[name] = t - t0
        t0 = t

    assign = assign_clusters(v, cent, device=device)
    lap("assign")
    valid = np.arange(Npad) < n_valid

    shard_sorted: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    m = 0
    for s in range(S):
        lo = s * shard_n
        local = np.nonzero(valid[lo : lo + shard_n])[0].astype(np.int32)
        a = assign[lo + local].astype(np.int32)
        cap = _capacity_cap(len(local), P, overalloc)
        a = _rebalance_overflow(a, cap, cent, lambda rows, _lo=lo, _local=local: v[_lo + _local[rows]])
        order = np.argsort(a, kind="stable")  # ascending row id within p
        counts = np.bincount(a, minlength=P).astype(np.int64)
        shard_sorted.append((local[order], a[order], counts))
        if counts.size:
            m = max(m, int(counts.max()))
    m = max(lanes, -(-m // lanes) * lanes)
    lap("rebalance")

    # per-row int8 on the device, block by block: the numpy formula's
    # operations, each exactly rounded, so the same bits
    dev = resolve_device(device)
    q8 = np.empty((Npad, D), np.int8)
    scale = np.empty(Npad, np.float32)
    for lo in range(0, Npad, _QUANT_ROWS):
        q, sc = quantize_int8(torch.as_tensor(np.ascontiguousarray(v[lo : lo + _QUANT_ROWS]), device=dev))
        q8[lo : lo + _QUANT_ROWS], scale[lo : lo + _QUANT_ROWS] = q.cpu().numpy(), sc.reshape(-1).cpu().numpy()
    lap("quantise")

    part_rows = np.full((S, P, m), -1, np.int32)
    for s, (rows_sorted, a_sorted, counts) in enumerate(shard_sorted):
        offsets = np.zeros(P + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        pos = np.arange(len(rows_sorted)) - np.repeat(offsets[:-1], counts)
        part_rows[s, a_sorted, pos] = rows_sorted

    pad = part_rows < 0
    # local slot row → global row (embeddings and filter columns)
    glob = np.maximum(part_rows, 0) + (np.arange(S, dtype=np.int32) * shard_n)[:, None, None]
    part_int8 = q8[glob]
    part_scale = scale[glob]
    part_int8[pad] = 0
    part_scale[pad] = 0.0

    pc = chunk_court[glob].astype(np.int32)
    cword = (pc // 32).astype(np.int32)
    cbit = np.uint32(1) << (pc.astype(np.uint32) % 32)
    pdt = chunk_date[glob].astype(np.int32)
    cword[pad] = -1
    pdt[pad] = np.iinfo(np.int32).min
    lap("layout")
    return {
        "part_rows": part_rows,
        "part_int8": part_int8,
        "part_scale": part_scale,
        "part_cword": cword,
        "part_cbit": cbit,
        "part_date": pdt,
        "m": m,
        "seconds": seconds,
    }


def slot_court_ids(part_rows: np.ndarray, part_cword: np.ndarray, part_cbit: np.ndarray) -> np.ndarray:
    """Raw court id per slot (-1 on pads) from the probe kernel's word and
    bit columns: ``word * 32`` plus the index of the bit, found by an exact
    search over the 32 powers of two (the JAX package takes ``log2`` in
    float64, exact for powers of two; a zero bit reads as bit 0 there and
    here)."""
    powers = np.uint32(1) << np.arange(32, dtype=np.uint32)
    bit = np.searchsorted(powers, np.asarray(part_cbit).astype(np.uint32)).astype(np.int64)
    raw = np.asarray(part_cword, np.int64) * 32 + bit
    return np.where(np.asarray(part_rows) >= 0, raw, -1).astype(np.int32)
