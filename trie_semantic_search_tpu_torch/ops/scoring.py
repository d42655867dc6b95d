"""Dense similarity scoring helpers.

Port of ``trie_semantic_search_tpu/ops/scoring.py``: L2 normalisation,
per-row symmetric int8 quantisation (round half to even, as ``jnp.round``)
and the exact gather-rescore that the rescore kernel
(:func:`.scan_kernels.gather_rescore_kernel`) is held against.
"""

from __future__ import annotations

import torch


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
