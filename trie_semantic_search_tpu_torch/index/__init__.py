"""Trie, partitioned ANN and vector index (build, load and serve)."""

from .ann import AnnStats, PartitionedANN
from .kmeans import assign_clusters, train_kmeans
from .trie import FrozenTrie, TrieBuilder, TrieIndex, TrieSearchResult
from .vector import VectorIndex, VectorIndexStats, VectorSearchResult

__all__ = [
    "AnnStats",
    "FrozenTrie",
    "PartitionedANN",
    "TrieBuilder",
    "TrieIndex",
    "TrieSearchResult",
    "VectorIndex",
    "VectorIndexStats",
    "VectorSearchResult",
    "assign_clusters",
    "train_kmeans",
]
