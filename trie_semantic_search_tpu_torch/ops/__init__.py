"""Tensor operations of the serving path and the Hopper kernel wrappers.

The JAX package's names, with its Pallas kernel ``pallas_int8_topk``
exported as its CUDA counterpart ``int8_topk``: ``fused_int8_topk`` is
the scan with an exact top-k that keeps the ``[B, N]`` scores out of
device memory, ``xla_int8_topk`` the materialised-scores reference.
"""

from .scan_kernels import fused_int8_topk, int8_topk, xla_int8_topk
from .scoring import (
    brute_force_topk,
    cosine_scores,
    cosine_scores_int8,
    gather_rescore,
    l2_normalize,
    quantize_int8,
)
from .topk import chunked_topk, exact_topk, fast_topk, merge_topk, segment_max_dedup
from .trie_kernels import (
    batched_walk,
    gather_postings,
    gather_postings_ranked,
    gather_range_postings,
    gather_range_postings_ranked,
    walk_and_gather,
)

__all__ = [
    "batched_walk",
    "brute_force_topk",
    "chunked_topk",
    "cosine_scores",
    "cosine_scores_int8",
    "exact_topk",
    "fast_topk",
    "fused_int8_topk",
    "gather_postings",
    "gather_postings_ranked",
    "gather_range_postings",
    "gather_range_postings_ranked",
    "gather_rescore",
    "int8_topk",
    "l2_normalize",
    "merge_topk",
    "quantize_int8",
    "segment_max_dedup",
    "walk_and_gather",
    "xla_int8_topk",
]
