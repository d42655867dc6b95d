"""Configuration: the sections the search engine reads and the TOML loader.

Copies of the dataclasses in ``trie_semantic_search_tpu/core/config.py``
with the same field names and defaults, and the same precedence
(environment variables > TOML file > defaults), so a config file written
for the JAX package means the same thing here. The sections of later
slices (ingestion, logging, performance, mesh) are not carried over yet;
their keys in a file are ignored, as unknown keys are.
"""

from __future__ import annotations

import os
import tomllib
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Optional

from .errors import ConfigError, ValidationFailed


@dataclass
class ServerConfig:
    """Server section (same defaults as the JAX package). ``batch_max`` is
    the micro-batcher's largest batch; warmup compiles its bucket."""

    host: str = "127.0.0.1"
    port: int = 8080
    max_payload_size_mb: int = 10
    request_timeout_seconds: int = 30
    enable_cors: bool = True
    api_key: Optional[str] = None
    rate_limit_rpm: int = 1000
    batch_max: int = 64
    batch_window_ms: float = 2.0
    batch_inflight: int = 2
    batch_max_pending: int = 256


@dataclass
class SentenceSplittingConfig:
    enabled: bool = True
    min_sentence_length: int = 10
    max_sentence_length: int = 1000


@dataclass
class TextProcessingConfig:
    """Text processing section (same defaults as the JAX package)."""

    tokenizer_model_path: str = "./models/tokenizer.json"
    enable_case_folding: bool = True
    enable_unicode_normalization: bool = True
    preserve_legal_citations: bool = True
    max_text_length: int = 1_000_000
    remove_extra_whitespace: bool = True
    normalize_quotes: bool = True
    extract_citations: bool = True
    extract_entities: bool = True
    sentence_splitting: SentenceSplittingConfig = field(
        default_factory=SentenceSplittingConfig
    )


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
    #: build-time retrieval-quality gate ("off" | "warn" | "refuse")
    quality_gate: str = "warn"
    quality_gate_probes: int = 128
    quality_gate_sample_cases: int = 200
    quality_gate_margin: float = 0.8
    #: sentence pooling: "auto" | "mean" | "sif"
    pooling: str = "auto"
    sif_a: float = 0.1


@dataclass
class BackupConfig:
    enabled: bool = True
    backup_dir: str = "./backups"
    interval_hours: int = 24
    max_backups: int = 7


@dataclass
class StorageConfig:
    """Storage section (same defaults as the JAX package): sqlite, or
    ``"memory"`` for an in-process database."""

    db_type: str = "sqlite"
    db_path: str = "./data/legal_search.db"
    max_db_size_gb: int = 100
    enable_compression: bool = True
    backup: BackupConfig = field(default_factory=BackupConfig)


@dataclass
class SearchEngineConfig:
    """Search section (same defaults as the JAX package)."""

    default_max_results: int = 10
    search_timeout_ms: int = 5000
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
    enable_query_cache: bool = True
    query_cache_size: int = 10000
    query_cache_ttl_seconds: int = 3600
    min_query_length: int = 2
    max_query_length: int = 1000


@dataclass
class Config:
    """Top-level config: the sections the engine reads."""

    server: ServerConfig = field(default_factory=ServerConfig)
    text_processing: TextProcessingConfig = field(default_factory=TextProcessingConfig)
    trie: TrieConfig = field(default_factory=TrieConfig)
    vector: VectorConfig = field(default_factory=VectorConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    search: SearchEngineConfig = field(default_factory=SearchEngineConfig)

    @classmethod
    def from_file(cls, path: str | Path) -> "Config":
        """Load a TOML file, then the environment overrides, then validate.
        A missing file gives the defaults (with the overrides)."""
        path = Path(path)
        if not path.exists():
            cfg = cls()
        else:
            try:
                raw = tomllib.loads(path.read_bytes().decode("utf-8"))
            except OSError as e:
                raise ConfigError(f"Failed to read config file {path}: {e}") from e
            except (tomllib.TOMLDecodeError, UnicodeDecodeError) as e:
                raise ConfigError(f"Failed to parse config file {path}: {e}") from e
            cfg = cls.from_dict(raw)
        cfg.apply_env_overrides()
        cfg.validate()
        return cfg

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "Config":
        return _dataclass_from_dict(cls, raw)

    def apply_env_overrides(self) -> None:
        """``LEGAL_SEARCH_HOST/PORT/API_KEY/DB_PATH/MODEL_PATH``."""
        env = os.environ
        if "LEGAL_SEARCH_HOST" in env:
            self.server.host = env["LEGAL_SEARCH_HOST"]
        if "LEGAL_SEARCH_PORT" in env:
            try:
                self.server.port = int(env["LEGAL_SEARCH_PORT"])
            except ValueError:
                raise ConfigError("Invalid port number in LEGAL_SEARCH_PORT")
        if "LEGAL_SEARCH_API_KEY" in env:
            self.server.api_key = env["LEGAL_SEARCH_API_KEY"]
        if "LEGAL_SEARCH_DB_PATH" in env:
            self.storage.db_path = env["LEGAL_SEARCH_DB_PATH"]
        if "LEGAL_SEARCH_MODEL_PATH" in env:
            self.vector.model.model_path = env["LEGAL_SEARCH_MODEL_PATH"]

    def validate(self) -> None:
        """The JAX package's checks on the sections carried over."""
        checks = (
            (self.server.port == 0, "server.port", "Port cannot be zero"),
            (self.vector.dimension <= 0, "vector.dimension",
             "Vector dimension must be greater than zero"),
            (self.vector.hnsw.m <= 0, "vector.hnsw.m",
             "HNSW M parameter must be greater than zero"),
            (self.search.min_query_length > self.search.max_query_length,
             "search.min_query_length",
             "Minimum query length cannot be greater than maximum"),
            (self.vector.pooling not in ("auto", "mean", "sif"), "vector.pooling",
             f"Unsupported pooling '{self.vector.pooling}' (auto|mean|sif)"),
            (self.vector.quality_gate not in ("off", "warn", "refuse"),
             "vector.quality_gate",
             f"Unsupported quality_gate '{self.vector.quality_gate}' (off|warn|refuse)"),
            (self.search.fused_flat_escalate_eps < 0, "search.fused_flat_escalate_eps",
             "Escalation epsilon must be >= 0"),
        )
        for bad, name, reason in checks:
            if bad:
                raise ValidationFailed(field=name, reason=reason)
        if self.storage.db_type == "sled":  # the original service's config files
            self.storage.db_type = "sqlite"
        if self.storage.db_type not in ("sqlite", "memory"):
            raise ValidationFailed(
                field="storage.db_type",
                reason=f"Unsupported db_type '{self.storage.db_type}' (sqlite|memory)",
            )


def _dataclass_from_dict(cls: type, raw: dict[str, Any]) -> Any:
    """Nested dataclass from a parsed TOML table; unknown keys are ignored."""
    if not isinstance(raw, dict):
        raise ConfigError(f"Expected table for {cls.__name__}, got {type(raw).__name__}")
    hints = typing.get_type_hints(cls)
    names = {f.name for f in fields(cls)}
    kwargs: dict[str, Any] = {}
    for key, value in raw.items():
        if key not in names:
            continue
        ftype = hints.get(key)
        if is_dataclass(ftype) and isinstance(value, dict):
            kwargs[key] = _dataclass_from_dict(ftype, value)
        else:
            kwargs[key] = value
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise ConfigError(f"Bad config for {cls.__name__}: {e}") from e
