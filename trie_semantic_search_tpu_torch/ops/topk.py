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
