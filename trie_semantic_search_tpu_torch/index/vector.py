"""Vector index: embedder + partitioned ANN + embedding cache.

Port of ``trie_semantic_search_tpu/index/vector.py``: ``generate_embeddings``
(cache, then one batched encode for the misses), the build side
(``add_document``, ``embed_pending``, ``freeze``: documents pend on the
host, embed in bounded flushes, then the ANN builds over all of them), the
staged search (``search``, ``search_batch``, ``search_embedded``: probe for
small batches, the exact scan from 64 queries or below 10,000 chunks),
``save`` and ``load`` of the artifact directory (``refs.npz``,
``vectors.npy`` memmapped, ``ann.mmap/`` or ``ann.npz``; without an ANN
artifact the ANN is rebuilt from the vectors), and the ``vectors``/``refs``
views the fused search reads. A loaded ``vectors`` stays a memmap: the
partitioned serving mode reads only its length, and an f32 host copy at 5M
chunks would be 8 GB.

With a ``mesh`` whose data axis is > 1 the index is a
:class:`.sharded.ShardedCorpusIndex` (an exact scan over row blocks)
instead of a :class:`.ann.PartitionedANN`; ``load`` reads the saved ANN as
the class the mesh implies and rebuilds from the saved vectors when the
file is the other class's.
"""

from __future__ import annotations

import logging
import os
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..core.config import VectorConfig
from ..core.errors import AnnSearchError
from ..device import DeviceLike, resolve_device
from ..models.embedder import Embedder
from ..search.cache import VectorCache
from .ann import AnnStats, PartitionedANN
from .sharded import ShardedCorpusIndex

_log = logging.getLogger("tss_torch.vector")

#: ANN artifacts above this many bytes save as a raw-.npy directory
#: (``ann.mmap/``) instead of a DEFLATE npz
_ANN_MMAP_SAVE_BYTES = 64 * 2**20


def _mesh_data_size(mesh) -> int:
    from ..parallel.mesh import DATA_AXIS

    try:
        return int(mesh.shape[DATA_AXIS])
    except (KeyError, TypeError, AttributeError):
        return 1


def _holds_sharded_corpus(path: Path) -> bool:
    """Whether an ``ann.npz`` is a :class:`ShardedCorpusIndex` file."""
    with np.load(path, allow_pickle=False) as z:
        return "sharded_corpus_f16" in z.files


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
    """Semantic index over (case_row, paragraph) chunks, on ``device``
    (the encoder's device; a sharded index lies on its mesh)."""

    def __init__(
        self,
        config: Optional[VectorConfig] = None,
        embedder: Optional[Embedder] = None,
        device: DeviceLike = None,
        mesh=None,  # parallel.mesh.Mesh; data axis > 1 → ShardedCorpusIndex
    ):
        self.config = config or VectorConfig()
        self.device = resolve_device(device)
        self.embedder = embedder or Embedder(self.config.model, device=self.device)
        self.cache = VectorCache(max_size=1000)
        self.mesh = mesh
        if mesh is not None and _mesh_data_size(mesh) > 1:
            self.ann = ShardedCorpusIndex(mesh, use_int8=self.config.hnsw.quantize_int8)
        else:
            self.ann = PartitionedANN(self.config.hnsw, device=self.device)
        self._pending_texts: list[str] = []
        self._pending_refs: list[tuple[int, int]] = []  # (case_row, para)
        self._refs: "np.ndarray | list" = []
        self._vectors: Optional[np.ndarray] = None

    def generate_embedding(self, text: str) -> np.ndarray:
        """One text's embedding, through the memo."""
        cached = self.cache.get(text)
        if cached is not None:
            return cached
        emb = self.embedder.embed_one(text)
        self.cache.put(text, emb)
        return emb

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

    # -- building --------------------------------------------------------------

    def add_document(self, case_row: int, text: str, paragraph_index: int = 0) -> None:
        self._pending_texts.append(text)
        self._pending_refs.append((case_row, paragraph_index))

    def add_documents(self, items: Sequence[tuple[int, int, str]]) -> None:
        """Bulk add: ``(case_row, paragraph_index, text)``."""
        for row, para, text in items:
            self.add_document(row, text, para)

    def embed_pending(self, flush_threshold: int = 0) -> int:
        """Embed the pending documents into the vector store, without an
        ANN rebuild; a no-op until ``flush_threshold`` are pending. Returns
        the number embedded."""
        if not self._pending_texts or len(self._pending_texts) < flush_threshold:
            return 0
        n = len(self._pending_texts)
        embs = self.embedder.embed(self._pending_texts).embedding
        self._vectors = embs if self._vectors is None else np.concatenate([self._vectors, embs])
        if isinstance(self._refs, np.ndarray):  # loaded form
            self._refs = np.concatenate(
                [self._refs, np.asarray(self._pending_refs, np.int32).reshape(-1, 2)]
            )
        else:
            self._refs.extend(self._pending_refs)
        self._pending_texts = []
        self._pending_refs = []
        return n

    def freeze(self, seed: int = 0) -> None:
        """Embed the pending documents and (re)build the ANN over all."""
        self.embed_pending()
        if self._vectors is not None and len(self._vectors):
            self.ann.build(self._vectors, seed=seed)

    def fork(self) -> "VectorIndex":
        """A new index with this one's encoder, embedding memo, refs,
        vectors and ANN, for an update while this one serves: adding and
        embedding documents makes new refs and vectors arrays, and the
        caller installs a new ANN before building one."""
        out = VectorIndex(self.config, embedder=self.embedder, device=self.device, mesh=self.mesh)
        out.cache = self.cache
        out._refs = list(self._refs) if isinstance(self._refs, list) else self._refs
        out._vectors = self._vectors
        out.ann = self.ann
        return out

    # -- search ------------------------------------------------------------------

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

    def save(self, path: str | Path) -> None:
        """Persist refs, vectors and the ANN: ``refs.npz``, an uncompressed
        ``vectors.npy`` copied slab by slab, and ``ann.mmap/`` above
        :data:`_ANN_MMAP_SAVE_BYTES`, else ``ann.npz``."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        if self.ann.num_vectors:
            if (isinstance(self.ann, PartitionedANN)
                    and self.ann.get_stats().nbytes_total > _ANN_MMAP_SAVE_BYTES):
                self.ann.save_dir(path / "ann.mmap")
                (path / "ann.npz").unlink(missing_ok=True)
            else:
                self.ann.save(path / "ann.npz")
                if (path / "ann.mmap").exists():
                    shutil.rmtree(path / "ann.mmap")
        refs = np.asarray(self._refs, np.int32) if len(self._refs) else np.zeros((0, 2), np.int32)
        np.savez_compressed(path / "refs.npz", refs=refs)
        vec_path = path / "vectors.npy"
        src = self._vectors
        if src is not None and len(src):
            if (
                isinstance(src, np.memmap)
                and getattr(src, "filename", None) is not None
                and Path(src.filename).resolve() == vec_path.resolve()
            ):
                return  # saved in place already (a re-save after load)
            # written beside, then renamed over: a server may still map the
            # old file (a loaded index's memmap), which must keep its pages
            tmp = path / "vectors.npy.tmp"
            out = np.lib.format.open_memmap(
                tmp, mode="w+", dtype=np.float32, shape=(len(src), src.shape[1])
            )
            step = 1 << 18
            for lo in range(0, len(src), step):
                out[lo : lo + step] = src[lo : lo + step]
            out.flush()
            del out
            os.replace(tmp, vec_path)
        elif vec_path.exists():
            vec_path.unlink()

    def load(self, path: str | Path) -> None:
        """Load a ``VectorIndex.save`` directory (either package's). Without
        an ANN artifact the ANN is rebuilt from the saved vectors."""
        path = Path(path)
        with np.load(path / "refs.npz", allow_pickle=False) as z:
            self._refs = z["refs"].astype(np.int32)
            v = z["vectors"] if "vectors" in z.files else None
        vec_path = path / "vectors.npy"
        if v is None and vec_path.exists():
            v = np.load(vec_path, mmap_mode="r")
        self._vectors = v if (v is not None and len(v)) else None
        ann_dir, ann_npz = path / "ann.mmap", path / "ann.npz"
        sharded = isinstance(self.ann, ShardedCorpusIndex)
        if ann_dir.exists() and not sharded:
            try:
                self.ann = PartitionedANN.load_dir(ann_dir, self.config.hnsw, self.device)
                return
            except Exception:
                _log.warning("ann artifact dir %s not loadable; trying %s", ann_dir, ann_npz)
        if ann_npz.exists():
            # the file is the class the saving mesh implied; the other
            # class's file is rebuilt from the saved vectors below
            if _holds_sharded_corpus(ann_npz) == sharded:
                if sharded:
                    self.ann = ShardedCorpusIndex.load(ann_npz, self.mesh)
                else:
                    self.ann = PartitionedANN.load(ann_npz, self.config.hnsw, self.device)
                return
            _log.warning("ann artifact %s is not a %s; rebuilding from saved vectors",
                         ann_npz, type(self.ann).__name__)
        if self._vectors is not None and len(self._vectors):
            self.ann.build(self._vectors)
