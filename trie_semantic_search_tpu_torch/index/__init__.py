"""Trie, partitioned ANN and vector index (load and serve)."""
