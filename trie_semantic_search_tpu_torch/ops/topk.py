"""Top-k primitives with the JAX package's tie order.

Port of ``trie_semantic_search_tpu/ops/topk.py``. ``torch.topk`` promises
no order among equal values, so every selection here is a stable sort:

  * :func:`exact_topk` matches ``jax.lax.top_k``: values descending in
    IEEE total order (``+0.0`` ranks above ``-0.0``), ties to the lower
    position.
  * :func:`topk_by_score_then_row` matches the two-key ``lax.sort`` on
    ``(-value, row)``: ``-0.0`` and ``+0.0`` compare equal there, so a
    stable sort on row followed by a stable sort on ``-value`` reproduces
    it.
  * :func:`chunked_topk` (chunk-local top-k, then :func:`merge_topk`) and
    :func:`segment_max_dedup` (each case's best candidate, by a
    scatter-max into a dense ``[B, P]`` table) are plain torch ops too.
"""

from __future__ import annotations

import torch


def _total_order_key(values: torch.Tensor) -> torch.Tensor:
    """int32 key that orders float32 values as IEEE total order does
    (``-inf < ... < -0.0 < +0.0 < ... < inf``) — the order ``lax.top_k``
    ranks by."""
    bits = values.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def exact_topk(
    scores: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-row top-k along the last axis → ``(values, indices)``;
    ties break to the lower index (``lax.top_k``'s order)."""
    k = min(k, scores.shape[-1])
    _, pos = torch.sort(
        _total_order_key(scores), dim=-1, descending=True, stable=True
    )
    pos = pos[..., :k]
    return torch.gather(scores, -1, pos), pos


def fast_topk(
    scores: torch.Tensor, k: int, recall_target: float = 0.95
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``approx_max_k`` is exact off the TPU; the brute
    path here reaches it only when the fused-scan kernel does not apply
    (a corpus that is not tile-divisible), so it stays exact."""
    return exact_topk(scores, k)


def topk_by_score_then_row(
    values: torch.Tensor,  # [..., M] candidate scores
    rows: torch.Tensor,  # [..., M] global row id per candidate
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by score desc with ties broken to the LOWER row id,
    independent of candidate position (``lax.sort`` on ``(-v, row)``)."""
    k = min(k, values.shape[-1])
    rows_sorted, by_row = torch.sort(rows, dim=-1, stable=True)
    v_by_row = torch.gather(values, -1, by_row)
    neg_v, by_val = torch.sort(-v_by_row, dim=-1, stable=True)
    srt_rows = torch.gather(rows_sorted, -1, by_val)
    return -neg_v[..., :k], srt_rows[..., :k]


def merge_topk(
    values: torch.Tensor,  # [..., S, k] per-list top-k values
    indices: torch.Tensor,  # [..., S, k] global indices
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge S top-k lists into one (flatten, re-select; ties to the
    earlier list position like ``lax.top_k``)."""
    flat_v = values.reshape(*values.shape[:-2], -1)
    flat_i = indices.reshape(*indices.shape[:-2], -1)
    top_v, pos = exact_topk(flat_v, k)
    return top_v, torch.gather(flat_i, -1, pos)


def chunked_topk(
    scores: torch.Tensor, k: int, num_chunks: int = 8
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-stage exact top-k: chunk-local top-k, then :func:`merge_topk`;
    :func:`exact_topk` when ``N`` does not split into ``num_chunks`` chunks
    of at least ``k``. The same values and indices as :func:`exact_topk`."""
    B, N = scores.shape
    if N % num_chunks != 0 or N // num_chunks < k:
        return exact_topk(scores, k)
    C = N // num_chunks
    v, i = exact_topk(scores.reshape(B, num_chunks, C), k)  # [B, S, k] local
    offsets = (torch.arange(num_chunks, device=i.device, dtype=i.dtype) * C)[None, :, None]
    return merge_topk(v, i + offsets, k)


def segment_max_dedup(
    values: torch.Tensor,  # [B, M] candidate scores
    segment_ids: torch.Tensor,  # [B, M] int case id per candidate (-1 = invalid)
    num_segments_pad: int,
) -> torch.Tensor:
    """Keep only each segment's max-scoring candidate: ``values`` with
    non-max duplicates and invalid ids (negative) replaced by ``-inf``;
    among equal maxima the lowest candidate position stays. Ids must be
    below ``num_segments_pad``."""
    B, M = values.shape
    dev = values.device
    neg_inf = torch.tensor(float("-inf"), dtype=values.dtype, device=dev)
    valid = segment_ids >= 0
    safe = torch.where(valid, segment_ids, torch.zeros_like(segment_ids)).long()
    masked = torch.where(valid, values, neg_inf)
    # per-row segment max by a scatter-max into a dense [B, P] table
    seg_max = torch.full((B, num_segments_pad), float("-inf"), dtype=values.dtype, device=dev)
    seg_max = seg_max.scatter_reduce(1, safe, masked, "amax")
    is_seg_max = masked >= torch.gather(seg_max, 1, safe)
    # among equal-valued duplicates keep the lowest candidate position
    pos = torch.arange(M, device=dev).expand(B, M)
    pos_of_max = torch.where(is_seg_max & valid, pos, torch.full_like(pos, M))
    first_pos = torch.full((B, num_segments_pad), M, dtype=torch.int64, device=dev)
    first_pos = first_pos.scatter_reduce(1, safe, pos_of_max, "amin")
    keep = valid & is_seg_max & (pos == torch.gather(first_pos, 1, safe))
    return torch.where(keep, values, neg_inf)
