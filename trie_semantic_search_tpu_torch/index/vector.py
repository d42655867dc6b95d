"""Vector index: embedder + partitioned ANN + embedding cache (load and
serve).

Port of ``trie_semantic_search_tpu/index/vector.py``: ``generate_embeddings``
(cache, then one batched encode for the misses), the staged search
(``search``, ``search_batch``, ``search_embedded``: probe for small
batches, the exact scan from 64 queries or below 10,000 chunks), ``load``
of the JAX package's artifact directory (``refs.npz``, ``vectors.npy``
memmapped, ``ann.mmap/`` or ``ann.npz``), and the ``vectors``/``refs``
views the fused search reads. ``vectors`` stays a memmap: the partitioned serving mode
reads only its length, and an f32 host copy at 5M chunks would be 8 GB.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..core.config import VectorConfig
from ..core.errors import AnnSearchError, VectorIndexConstructionFailed
from ..device import DeviceLike, resolve_device
from ..models.embedder import Embedder
from ..search.cache import VectorCache
from .ann import AnnStats, PartitionedANN

_log = logging.getLogger("tss_torch.vector")


@dataclass
class VectorSearchResult:
    """One semantic hit: the case row, its paragraph and the similarity."""

    row: int
    paragraph_index: int
    similarity_score: float


@dataclass
class VectorIndexStats:
    total_documents: int = 0
    dimension: int = 0
    cache_size: int = 0
    cache_hits: int = 0
    ann: Optional[AnnStats] = None


class VectorIndex:
    """Semantic index over (case_row, paragraph) chunks, on ``device``."""

    def __init__(
        self,
        config: Optional[VectorConfig] = None,
        embedder: Optional[Embedder] = None,
        device: DeviceLike = None,
    ):
        self.config = config or VectorConfig()
        self.device = resolve_device(device)
        self.embedder = embedder or Embedder(self.config.model, device=self.device)
        self.cache = VectorCache(max_size=1000)
        self.ann = PartitionedANN(self.config.hnsw, device=self.device)
        self._refs: "np.ndarray | list" = []
        self._vectors: Optional[np.ndarray] = None

    def generate_embeddings(self, texts: Sequence[str]) -> np.ndarray:
        """Batch embedding with the memo: ONE encode for all cache misses."""
        out: list[Optional[np.ndarray]] = [self.cache.get(t) for t in texts]
        miss = [i for i, e in enumerate(out) if e is None]
        if miss:
            embs = self.embedder.embed([texts[i] for i in miss]).embedding
            for j, i in enumerate(miss):
                out[i] = np.asarray(embs[j])
                self.cache.put(texts[i], out[i])
        return np.stack(out)  # type: ignore[arg-type]

    def search(
        self, query: str, top_k: int = 50, use_brute: Optional[bool] = None
    ) -> list[VectorSearchResult]:
        return self.search_batch([query], top_k, use_brute=use_brute)[0]

    def search_batch(
        self, queries: Sequence[str], top_k: int = 50, use_brute: Optional[bool] = None,
    ) -> list[list[VectorSearchResult]]:
        if self.ann.num_vectors == 0:
            return [[] for _ in queries]
        return self.search_embedded(self.generate_embeddings(queries), top_k, use_brute)

    def search_embedded(
        self, query_vecs: np.ndarray, top_k: int, use_brute: Optional[bool] = None,
    ) -> list[list[VectorSearchResult]]:
        """Semantic hits per query. The batch pads to a power of two (at
        least 8) with copies of the first query, as the JAX package does;
        ``use_brute`` defaults to the exact scan from 64 padded queries or
        below 10,000 chunks, the probe otherwise."""
        if self.ann.num_vectors == 0:
            return [[] for _ in range(len(query_vecs))]
        B = len(query_vecs)
        Bpad = 1 if B <= 1 else max(8, 1 << (B - 1).bit_length())
        if Bpad != B:
            query_vecs = np.concatenate([query_vecs, np.repeat(query_vecs[:1], Bpad - B, axis=0)])
        if use_brute is None:
            use_brute = len(query_vecs) >= 64 or self.ann.num_vectors < 10_000
        try:
            if use_brute:
                vals, rows = self.ann.search_brute(query_vecs, top_k)
            else:
                vals, rows = self.ann.search(query_vecs, top_k)
        except Exception as e:
            raise AnnSearchError(str(e)) from e
        out: list[list[VectorSearchResult]] = []
        for b in range(B):
            out.append([
                VectorSearchResult(
                    row=int(self._refs[int(r)][0]),
                    paragraph_index=int(self._refs[int(r)][1]),
                    similarity_score=float(v),
                )
                for v, r in zip(vals[b], rows[b])
                if r >= 0
            ])
        return out

    def get_stats(self) -> VectorIndexStats:
        cs = self.cache.get_stats()
        return VectorIndexStats(
            total_documents=self.size,
            dimension=self.embedder.dimension,
            cache_size=cs.size,
            cache_hits=cs.hits,
            ann=self.ann.get_stats() if self.ann.num_vectors else None,
        )

    @property
    def size(self) -> int:
        return len(self._refs)

    @property
    def refs(self) -> "np.ndarray | list":
        """(case_row, paragraph) per chunk; ``[N, 2]`` int32 once loaded."""
        return self._refs

    @property
    def vectors(self) -> Optional[np.ndarray]:
        return self._vectors

    def set_frozen(self, refs: np.ndarray, vectors, ann: PartitionedANN) -> None:
        """Install frozen state built elsewhere: ``refs [N, 2]``, any
        ``[N, D]`` array-like of vectors (only its length is read in the
        partitioned mode) and a loaded or assembled ANN."""
        self._refs = np.asarray(refs, np.int32)
        self._vectors = vectors
        self.ann = ann

    def load(self, path: str | Path) -> None:
        """Load the JAX package's ``VectorIndex.save`` directory."""
        path = Path(path)
        with np.load(path / "refs.npz", allow_pickle=False) as z:
            self._refs = z["refs"].astype(np.int32)
            v = z["vectors"] if "vectors" in z.files else None
        vec_path = path / "vectors.npy"
        if v is None and vec_path.exists():
            v = np.load(vec_path, mmap_mode="r")
        self._vectors = v if (v is not None and len(v)) else None
        ann_dir, ann_npz = path / "ann.mmap", path / "ann.npz"
        if ann_dir.exists():
            try:
                self.ann = PartitionedANN.load_dir(ann_dir, self.config.hnsw, self.device)
                return
            except Exception:
                _log.warning("ann artifact dir %s not loadable; trying %s", ann_dir, ann_npz)
        if ann_npz.exists():
            self.ann = PartitionedANN.load(ann_npz, self.config.hnsw, self.device)
            return
        if self._vectors is not None and len(self._vectors):
            raise VectorIndexConstructionFailed(
                "no ANN artifact next to the vectors; building one is not ported yet"
            )
