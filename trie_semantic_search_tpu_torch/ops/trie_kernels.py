"""Batched trie traversal over the frozen CSR arrays.

Port of ``trie_semantic_search_tpu/ops/trie_kernels.py`` (plain PyTorch;
the JAX package has no Pallas kernel here).

The JAX walk runs a fixed-iteration binary search for each query's token
inside its node's sorted edge span. The same lookup is done here with one
``torch.searchsorted`` per level over a global edge key
``source_node * K + token``: the CSR layout lists spans in node order and
sorts tokens within each span, so the keys are globally sorted and an edge
``(node, token)`` is found exactly when the bisection would find it. That
is a handful of launches per level instead of one per bisection step.
"""

from __future__ import annotations

import torch

#: state value for "walk failed" lanes
DEAD = -1


def edge_keys(edge_offsets: torch.Tensor, edge_tokens: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Sorted int64 key per edge (``source * K + token``) and the
    multiplier ``K`` (one more than the largest token id)."""
    n_nodes = edge_offsets.shape[0] - 1
    counts = (edge_offsets[1:] - edge_offsets[:-1]).to(torch.int64)
    src = torch.repeat_interleave(
        torch.arange(n_nodes, device=edge_offsets.device, dtype=torch.int64), counts
    )
    tok = edge_tokens[: src.shape[0]].to(torch.int64)
    K = int(tok.max().item()) + 1 if tok.numel() else 1
    return src * K + tok, K


def batched_walk(
    edge_keys_: torch.Tensor,  # [E] int64 sorted (edge_keys)
    key_mult: int,
    edge_targets: torch.Tensor,  # [E] int32
    token_ids: torch.Tensor,  # [B, L] int32, -1 pad, -2 unknown
) -> torch.Tensor:
    """Walk every query from the root → final node per lane (``[B]``
    int32), -1 where the walk failed. Padding (-1) keeps the node; unknown
    tokens (-2) and tokens past the vocabulary kill the lane."""
    B, L = token_ids.shape
    dev = token_ids.device
    state = torch.zeros(B, dtype=torch.int64, device=dev)
    E = edge_keys_.shape[0]
    for level in range(L):
        tok = token_ids[:, level].to(torch.int64)
        ok = (state >= 0) & (tok >= 0) & (tok < key_mult)
        key = torch.clamp(state, min=0) * key_mult + torch.clamp(tok, min=0)
        if E:
            pos = torch.searchsorted(edge_keys_, key)
            safe = torch.clamp(pos, max=E - 1)
            hit = ok & (pos < E) & (edge_keys_[safe] == key)
            nxt = torch.where(hit, edge_targets[safe].to(torch.int64), torch.full_like(state, DEAD))
        else:
            nxt = torch.full_like(state, DEAD)
        state = torch.where(tok == -1, state, nxt)
    return state.to(torch.int32)


def _span_gather(start, end, matched, post_rows, width):
    """Postings ``[start, end)`` of each matched lane, the first ``width``
    in DFS order → ``(idx, rows, valid)``, invalid slots -1."""
    offs = torch.arange(width, device=start.device, dtype=torch.int64)[None, :]
    idx = start[:, None].to(torch.int64) + offs
    valid = matched[:, None] & (idx < end[:, None])
    cl = torch.clamp(idx, max=post_rows.shape[0] - 1)
    rows = torch.where(valid, post_rows[cl], torch.full_like(cl, -1).to(post_rows.dtype))
    return cl, rows, valid


def gather_postings(
    post_offsets: torch.Tensor,  # [N+1] int32
    post_rows: torch.Tensor,  # [P] int32 case-row ids
    is_end: torch.Tensor,  # [N] bool
    nodes: torch.Tensor,  # [B] int32 final node per query (-1 = miss)
    max_postings: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width postings gather for matched lanes: the first
    ``max_postings`` postings of each final node in DFS order, only at
    ``is_end`` nodes → ``(rows [B, max_postings], valid)``, invalid slots
    -1."""
    safe = torch.clamp(nodes, min=0).long()
    matched = (nodes >= 0) & is_end[safe]
    _, rows, valid = _span_gather(post_offsets[safe], post_offsets[safe + 1], matched,
                                  post_rows, max_postings)
    return rows, valid


def gather_range_postings(
    post_offsets: torch.Tensor,  # [N+1] int32 (DFS-order postings)
    subtree_end: torch.Tensor,  # [N] int32: end of the node's subtree range
    post_rows: torch.Tensor,  # [P] int32 case-row ids
    nodes: torch.Tensor,  # [B] int32 final node per query (-1 = miss)
    max_postings: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Subtree (prefix-match) postings gather: the first ``max_postings``
    postings of ``[post_offsets[n], subtree_end[n])`` in DFS order, every
    posting whose inserted path starts with the query (no ``is_end``
    requirement)."""
    safe = torch.clamp(nodes, min=0).long()
    _, rows, valid = _span_gather(post_offsets[safe], subtree_end[safe], nodes >= 0,
                                  post_rows, max_postings)
    return rows, valid


def _rank_cap(rows: torch.Tensor, weight: torch.Tensor, max_postings: int):
    """Rank gathered postings by weight desc (ties to the lower gather
    offset, i.e. DFS order) and cap to ``max_postings``; invalid slots
    (weight -1) sort last."""
    neg_w, order = torch.sort(-weight, dim=-1, stable=True)
    top_rows = torch.gather(rows, 1, order[:, :max_postings])
    top_valid = neg_w[:, :max_postings] <= -1
    return torch.where(top_valid, top_rows, torch.full_like(top_rows, -1)), top_valid


def _ranked_gather(start, end, matched, post_rows, post_weight, max_postings, overcollect):
    cl, rows, valid = _span_gather(start, end, matched, post_rows,
                                   max_postings * max(1, overcollect))
    w = torch.where(valid, post_weight[cl], torch.full_like(cl, -1).to(post_weight.dtype))
    return _rank_cap(rows, w, max_postings)


def gather_postings_ranked(
    post_offsets: torch.Tensor,  # [N+1] int32
    post_rows: torch.Tensor,  # [P] int32
    post_weight: torch.Tensor,  # [P] int32
    is_end: torch.Tensor,  # [N] bool
    nodes: torch.Tensor,  # [B] int32 (-1 = miss)
    max_postings: int = 64,
    overcollect: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-match postings of each final node (only at ``is_end`` nodes),
    weight-ranked within an over-collection window and capped →
    ``(rows [B, max_postings], valid)``."""
    safe = torch.clamp(nodes, min=0).long()
    matched = (nodes >= 0) & is_end[safe]
    return _ranked_gather(
        post_offsets[safe], post_offsets[safe + 1], matched, post_rows,
        post_weight, max_postings, overcollect,
    )


def gather_range_postings_ranked(
    post_offsets: torch.Tensor,  # [N+1] int32 (DFS-order postings)
    subtree_end: torch.Tensor,  # [N] int32
    post_rows: torch.Tensor,  # [P] int32
    post_weight: torch.Tensor,  # [P] int32
    nodes: torch.Tensor,  # [B] int32 (-1 = miss)
    max_postings: int = 64,
    overcollect: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Subtree (prefix-match) postings of each final node, weight-ranked
    and capped → ``(rows [B, max_postings], valid)``."""
    safe = torch.clamp(nodes, min=0).long()
    return _ranked_gather(
        post_offsets[safe], subtree_end[safe], nodes >= 0, post_rows,
        post_weight, max_postings, overcollect,
    )


def walk_and_gather(
    edge_offsets: torch.Tensor | None,  # [N+1] int32 (None with ``keys``)
    edge_tokens: torch.Tensor | None,  # [E] int32 (None with ``keys``)
    edge_targets: torch.Tensor,  # [E] int32
    post_offsets: torch.Tensor,  # [N+1] int32
    post_rows: torch.Tensor,  # [P] int32
    is_end: torch.Tensor,  # [N] bool
    token_ids: torch.Tensor,  # [B, L] int32, -1 pad, -2 unknown
    max_postings: int = 64,
    *,
    keys: tuple[torch.Tensor, int] | None = None,
    post_weight: torch.Tensor | None = None,
    subtree_end: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused walk + postings gather → ``(nodes, rows, valid)``.

    By default the JAX function's semantics: exact-match postings in DFS
    order (:func:`gather_postings`). ``subtree_end`` gathers each node's
    subtree instead (:func:`gather_range_postings`), and ``post_weight``
    ranks an over-collected window by weight first (the serving gathers,
    :func:`gather_postings_ranked`). ``keys`` passes the edge keys of
    :func:`edge_keys` when the caller keeps them."""
    ek, mult = keys if keys is not None else edge_keys(edge_offsets, edge_tokens)
    nodes = batched_walk(ek, mult, edge_targets, token_ids)
    if subtree_end is not None:
        if post_weight is None:
            rows, valid = gather_range_postings(post_offsets, subtree_end, post_rows, nodes, max_postings)
        else:
            rows, valid = gather_range_postings_ranked(
                post_offsets, subtree_end, post_rows, post_weight, nodes, max_postings)
    elif post_weight is None:
        rows, valid = gather_postings(post_offsets, post_rows, is_end, nodes, max_postings)
    else:
        rows, valid = gather_postings_ranked(post_offsets, post_rows, post_weight, is_end, nodes,
                                             max_postings)
    return nodes, rows, valid
