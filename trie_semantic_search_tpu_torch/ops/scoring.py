"""Dense similarity scoring helpers.

Port of ``trie_semantic_search_tpu/ops/scoring.py``: L2 normalisation,
per-row symmetric int8 quantisation (round half to even, as ``jnp.round``),
the ``[B, N]`` cosine products of the sharded exact scans
(:func:`cosine_scores`, :func:`cosine_scores_int8`) and the exact
gather-rescore that the rescore kernel
(:func:`.scan_kernels.gather_rescore_kernel`) is held against.

The products are plain matrix products outside any kernel, and
:func:`brute_force_topk` is one product and a top-k. There is no
int8 product on CUDA in ``torch.matmul``, so int8 values multiply as f32:
exact while ``127² · D < 2²⁴`` (``D <= 1040``) with TF32 off, hence equal
to the JAX package's int32 accumulation.
"""

from __future__ import annotations

import torch

from .scan_kernels import exact_float32
from .topk import exact_topk, fast_topk


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def quantize_int8(vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantisation ``v ≈ q * scale`` →
    ``(q int8 [N, D], scale f32 [N, 1])``."""
    v = vectors.to(torch.float32)
    absmax = v.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale


def cosine_scores(
    queries: torch.Tensor,  # [B, D] (assumed L2-normalised)
    corpus: torch.Tensor,  # [N, D] bf16/f32 (assumed L2-normalised)
) -> torch.Tensor:
    """``[B, N]`` cosine similarity: the queries cast to the corpus dtype,
    products and sums in f32."""
    exact_float32()
    q = queries.to(corpus.dtype).to(torch.float32)
    return q @ corpus.to(torch.float32).T


def cosine_scores_int8(
    queries: torch.Tensor,  # [B, D] f32, L2-normalised
    corpus_q: torch.Tensor,  # [N, D] int8
    corpus_scale: torch.Tensor,  # [N, 1] f32
) -> torch.Tensor:
    """``[B, N]`` approximate cosine from an int8 corpus: the queries
    quantised per row too, the int8 product exact, then both scales."""
    exact_float32()
    q = queries.to(torch.float32)
    q_abs = q.abs().amax(dim=-1, keepdim=True)
    q_scale = torch.clamp(q_abs, min=1e-12) / 127.0
    q_int = torch.clamp(torch.round(q / q_scale), -127, 127)
    acc = q_int @ corpus_q.to(torch.float32).T
    return acc * q_scale * corpus_scale.reshape(1, -1)


def brute_force_topk(
    queries: torch.Tensor,  # [B, D] (assumed L2-normalised)
    corpus: torch.Tensor,  # [N, D] bf16/f32 (assumed L2-normalised)
    k: int,
    recall_target: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force cosine top-k over the whole corpus:
    :func:`cosine_scores`, then :func:`.topk.exact_topk`, or
    :func:`.topk.fast_topk` when ``recall_target < 1`` (exact here too)."""
    scores = cosine_scores(queries, corpus)
    if recall_target >= 1.0:
        return exact_topk(scores, k)
    return fast_topk(scores, k, recall_target)


def as_segments(corpus) -> tuple[torch.Tensor, ...]:
    """A rescore corpus given as one ``[N, D]`` tensor or a tuple of row
    segments, always as a tuple."""
    return tuple(corpus) if isinstance(corpus, (tuple, list)) else (corpus,)


def gather_rescore(
    queries: torch.Tensor,  # [B, D] f32
    corpus,  # [N, D] bf16/f32 tensor or tuple of row segments
    candidate_idx: torch.Tensor,  # [B, C] int candidate rows
) -> torch.Tensor:
    """Re-score candidate rows in full precision → ``[B, C]`` f32: the query
    cast to the corpus dtype, products and sum in f32 (exact products for
    bf16). Out-of-range ids clamp into each segment, and a row takes the
    score of the segment that holds it (the first segment's otherwise),
    as the JAX function does."""
    out = None
    base = 0
    for seg in as_segments(corpus):
        n = seg.shape[0]
        local = candidate_idx.long() - base
        safe = torch.clamp(local, 0, n - 1)
        cand = seg[safe].to(torch.float32)  # [B, C, D]
        q = queries.to(seg.dtype).to(torch.float32)
        re = torch.einsum("bd,bcd->bc", q, cand)
        if out is None:
            out = re
        else:
            inseg = (local >= 0) & (local < n)
            out = torch.where(inseg, re, out)
        base += n
    return out
