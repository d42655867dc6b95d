"""The benchmark of the PyTorch and CUDA port (``trie_semantic_search_tpu_torch``)."""
