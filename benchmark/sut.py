"""The system under test: the port's ``SearchEngine`` over the benchmark's
inputs, assembled the way the repository's chip smoke script assembles it
(the partition-major layout is attached to a ``PartitionedANN``; the port
has no public call for that yet). Every object here is the port's; the
benchmark only hands it the seeded rows, cases, vocabulary and the encoder
module its plug-in built (``benchmark/encoders/``)."""

from __future__ import annotations

import time

import numpy as np

from . import data


def seg_geometry(D: int) -> tuple[int, int]:
    """The port's bf16 rescore segments at width ``D``, as a saved index
    holds them: (rows of each segment but the last, row alignment)."""
    from trie_semantic_search_tpu_torch.ops.scan_kernels import GATHER_ROW_ALIGN_LCM, GATHER_SEG_BYTES

    L = GATHER_ROW_ALIGN_LCM
    return max(L, (GATHER_SEG_BYTES // (D * 2)) // L * L), L


def build_trie(cases: data.Cases, device):
    """Name, citation and content tries over every case: names and
    citations whole, the content trie over each case's opening words."""
    from trie_semantic_search_tpu_torch.index.trie import TrieIndex

    trie = TrieIndex(device=device)
    for c in range(cases.n):
        trie.insert_case_name(cases.name(c), c)
        trie.insert_citation(cases.citation(c), c)
        trie.insert_content(cases.opening(c), c, 0)
    trie.freeze()
    return trie


def build_embedder(model, vocab: dict, device):
    """The port's ``Embedder``: WordPiece over ``vocab`` and the encoder
    module that the configuration's plug-in built."""
    from trie_semantic_search_tpu_torch.models.embedder import Embedder
    from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer

    return Embedder(tokenizer=WordPieceTokenizer(vocab), model=model, device=device)


def build_engine(torch, cfg: dict, cases: data.Cases, layout: data.Layout, embedder, trie,
                 db_path: str, device, timings: dict):
    """``SearchEngine`` over the attached layout, the columns, the trie,
    the embedder and the sqlite store at ``db_path`` (written already)."""
    from trie_semantic_search_tpu_torch.core.config import AnnConfig, Config
    from trie_semantic_search_tpu_torch.index.ann import PartitionedANN
    from trie_semantic_search_tpu_torch.index.vector import VectorIndex
    from trie_semantic_search_tpu_torch.search.engine import SearchEngine
    from trie_semantic_search_tpu_torch.storage.columns import MetadataColumns
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    corpus = cfg["corpus"]
    P, m, D = corpus["partitions"], corpus["slots"], corpus["dim"]
    N = P * m
    t0 = time.perf_counter()
    config = Config()
    config.storage.db_path = db_path
    config.vector.hnsw = AnnConfig(num_probes=corpus["nprobe"])
    for key, value in cfg["serving"].get("server", {}).items():
        setattr(config.server, key, value)
    ann = PartitionedANN(config.vector.hnsw, device=device)
    ann.centroids, ann.part_int8, ann.part_scale = layout.centroids, layout.part_int8, layout.part_scale
    ann.corpus_bf16 = layout.segs
    ann.part_rows = torch.arange(N, dtype=torch.int32, device=device).reshape(P, m)
    ann.num_vectors = N
    rows = np.arange(N, dtype=np.int32)
    refs = np.stack([rows // cases.chunks, rows % cases.chunks], axis=1)
    vi = VectorIndex(config.vector, embedder=embedder, device=device)
    # only the vectors' length is read in the partitioned mode: a
    # zero-stride view stands for the f32 rows
    vi.set_frozen(refs, np.broadcast_to(np.zeros((1, D), np.float32), (N, D)), ann)
    columns = MetadataColumns(
        case_ids=[data.case_uuid(c) for c in range(cases.n)], court_ids=cases.court_ids,
        dates=cases.dates, court_vocab={c: i for i, c in enumerate(data.COURTS)},
    )
    storage = StorageManager(config.storage)
    engine = SearchEngine(config, storage, trie, vi, columns, device=device)
    timings["engine_s"] = time.perf_counter() - t0
    return engine
