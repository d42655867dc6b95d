"""Configuration sections the serving slice reads.

Copies of the dataclasses in ``trie_semantic_search_tpu/core/config.py``
with the same field names and defaults, so a config written for the JAX
package means the same thing here. Only the sections on the serving path
are carried over; the TOML loader and the other sections come with the
slices that need them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TrieConfig:
    """Trie section (same defaults as the JAX package)."""

    use_fst: bool = True
    index_case_names: bool = True
    index_citations: bool = True
    max_prefix_length: int = 50
    index_path: str = "./data/trie_index"
    enable_memory_mapping: bool = True
    #: sliding window width for content phrase indexing
    content_window: int = 8
    #: cap on windows per paragraph (bounds content-trie size)
    max_windows_per_paragraph: int = 512
    #: window start positions: "all", "phrase_start" or "sentence_start"
    content_windowing: str = "all"


@dataclass
class EmbeddingModelConfig:
    """Embedding model section (same defaults as the JAX package)."""

    model_path: str = "./models/minilm"
    tokenizer_path: str = "./models/tokenizer.json"
    model_type: str = "minilm-l6"
    use_gpu: bool = False
    batch_size: int = 32
    max_sequence_length: int = 512


@dataclass
class AnnConfig:
    """Partitioned-ANN section. The HNSW fields are kept so config files of
    the JAX package parse unchanged; the partitioned-scan fields drive the
    index."""

    m: int = 16
    ef_construction: int = 200
    ef_search: int = 50
    max_elements: int = 10_000_000
    index_path: str = "./data/vector_index"
    num_partitions: int = 0
    num_probes: int = 0
    quantize_int8: bool = True
    rescore_factor: int = 4
    kmeans_iters: int = 20
    kmeans_sample: int = 200_000
    partition_overalloc: float = 2.0
    kmeans_dedup: bool = False
    pad_replicas: bool = True
    replica_choices: int = 8
    tune_min_recall: float = 0.95
    tune_on_build: bool = True


HnswConfig = AnnConfig


@dataclass
class VectorConfig:
    """Vector section: encoder + ANN (same defaults as the JAX package)."""

    model: EmbeddingModelConfig = field(default_factory=EmbeddingModelConfig)
    hnsw: AnnConfig = field(default_factory=AnnConfig)
    dimension: int = 384
    similarity_threshold: float = 0.5
    max_ann_results: int = 100


@dataclass
class SearchEngineConfig:
    """The fused-path fields of the search section (same defaults as the
    JAX package's ``SearchEngineConfig``)."""

    default_max_results: int = 10
    use_fused_device_path: bool = True
    #: "auto" picks partitioned probing above ~50k chunks, brute below
    fused_ann_mode: str = "auto"
    #: chunk candidates examined per result slot before dedup-by-case
    fused_overfetch: int = 4
    #: < 1.0 permits the approximate scan kernels; 1.0 forces exact
    fused_recall_target: float = 0.97
    #: re-run probe results with a flat score boundary through the stream
    fused_flat_escalate: bool = True
    fused_flat_escalate_eps: float = 0.01
