"""Fused hybrid query step: semantic stage + filters + lexical boost +
dedup-by-case + top-k.

Port of ``trie_semantic_search_tpu/ops/hybrid.py``, function for function
and with the same arguments. The three semantic stages are

  * **brute**: :func:`fused_hybrid_topk` / :func:`fused_hybrid_topk_chunked`
    over an int8 copy of the corpus;
  * **stream**: :func:`fused_layout_brute_topk`, a slab walk over the
    partition layout, then a bf16 rescore;
  * **probe**: :func:`fused_partitioned_topk`, centroid probe, scan of the
    probed blocks, bf16 rescore;

and all three end in :func:`lexical_side_list` + :func:`merge_dedup_topk`.

Kernel choice is static and the same on every device: the fused-scan
kernel whenever ``recall_target < 1`` and the slab is tile-divisible
(:func:`use_scan_kernel`), the probe and rescore kernels per
:func:`resolve_probe_kernel`. The wrappers in :mod:`.scan_kernels` launch
the CUDA kernels for CUDA tensors and run their plain versions for CPU
tensors, so the CPU tests walk the same branches as the card.

Float multiply order is copied per site (``acc*q_scale*corpus_scale`` in
the slab scans, ``acc*scales*q_scale`` in the probe's gather branch) so the
int8 scores stay bitwise equal to the JAX package's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .scan_kernels import (
    TILE_N,
    court_word_bit,
    exact_float32,
    fused_scan_query_inputs,
    fused_scan_row_inputs,
    fused_scan_topk,
    gather_rescore_rows,
    pack_court_words,
    probe_candidates,
)
from .scoring import gather_rescore
from .topk import exact_topk, fast_topk, merge_topk, topk_by_score_then_row

#: result-source codes (MatchType provenance)
SRC_SEMANTIC = 0
SRC_CASE_NAME = 1
SRC_CITATION = 2
SRC_CONTENT = 3

_NEG_INF = -float("inf")


def use_scan_kernel(n_rows: int, recall_target: float) -> bool:
    """The fused-scan kernel serves whenever its lane approximation is
    permitted (``recall_target < 1``) and the rows divide into tiles (the
    JAX package's ``_use_pallas`` rule without its backend test)."""
    return recall_target < 1.0 and n_rows % TILE_N == 0


def quantize_queries(query_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query symmetric int8 quantisation ``[B, D] f32 → (int8, scale
    [B, 1])`` (round half to even)."""
    q = query_emb.to(torch.float32)
    q_abs = q.abs().amax(dim=-1, keepdim=True)
    q_scale = torch.clamp(q_abs, min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(q / q_scale), -127, 127).to(torch.int8)
    return q8, q_scale


def _take_columns(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=1)``: negative ids wrap, as in numpy
    indexing; ids past the end clamp (no caller produces them)."""
    V = table.shape[1]
    idx = idx.to(torch.int64)
    idx = torch.clamp(torch.where(idx < 0, idx + V, idx), 0, V - 1)
    return table[:, idx]


def lexical_side_list(
    trie_rows: torch.Tensor,  # [B, R] int32 lexical-hit case rows (-1 pad)
    trie_src: torch.Tensor,  # [B, R] int32 SRC_* per hit
    trie_chunk_of_case: torch.Tensor,  # [C] int32 representative chunk (-1 none)
    chunk_court: torch.Tensor,  # [N] int32
    chunk_date: torch.Tensor,  # [N] int32
    court_table: torch.Tensor,  # [B, V] bool
    date_lo: torch.Tensor,  # [B] int32
    date_hi: torch.Tensor,  # [B] int32
    exact_weight: torch.Tensor,  # [B] f32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Filter-checked lexical candidates → ``(values, chunks, src)`` each
    ``[B, R]``, invalid entries at ``-inf`` (threshold-exempt)."""
    C = trie_chunk_of_case.shape[0]
    safe_rows = torch.clamp(trie_rows.to(torch.int64), 0, max(C - 1, 0))
    hit_chunk = trie_chunk_of_case[safe_rows]
    safe_chunk = torch.clamp(hit_chunk, min=0)
    V = court_table.shape[1]
    hit_court = torch.clamp(chunk_court[safe_chunk.long()].to(torch.int64), 0, V - 1)
    hit_court_ok = torch.gather(court_table, 1, hit_court)
    hit_dates = chunk_date[safe_chunk.long()]
    hit_date_ok = (hit_dates >= date_lo[:, None]) & (hit_dates <= date_hi[:, None])
    valid = (trie_rows >= 0) & (hit_chunk >= 0) & hit_court_ok & hit_date_ok
    lex_v = torch.where(
        valid, exact_weight[:, None].to(torch.float32).expand_as(valid),
        torch.full(valid.shape, _NEG_INF, device=valid.device),
    )
    return lex_v, safe_chunk, trie_src


def merge_dedup_topk(
    sem_v: torch.Tensor,  # [B, Ks] semantic scores (-inf padded)
    sem_chunk: torch.Tensor,  # [B, Ks] chunk ids
    lex_v: torch.Tensor,  # [B, R]
    lex_chunk: torch.Tensor,  # [B, R]
    lex_src: torch.Tensor,  # [B, R] SRC_* codes
    chunk_case: torch.Tensor,  # [N] int32 chunk → case row
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge semantic + lexical candidates, dedup by case (each case keeps
    its best, ties to the earlier sorted position), final top-k →
    ``(scores, chunk_idx, case_rows, src)`` each ``[B, k]``."""
    i32 = torch.int32
    merged_v = torch.cat([sem_v.to(torch.float32), lex_v], dim=1)
    merged_i = torch.cat([sem_chunk.to(i32), lex_chunk.to(i32)], dim=1)
    merged_src = torch.cat(
        [torch.full_like(sem_chunk, SRC_SEMANTIC, dtype=i32), lex_src.to(i32)], dim=1
    )
    M = merged_v.shape[1]
    v_all, pos = exact_topk(merged_v, M)
    i_all = torch.gather(merged_i, 1, pos)
    src_all = torch.gather(merged_src, 1, pos)
    N = chunk_case.shape[0]
    cases_all = chunk_case[torch.clamp(i_all.long(), 0, N - 1)].to(i32)
    cases_all = torch.where(torch.isfinite(v_all), cases_all, torch.full_like(cases_all, -1))
    eq = (cases_all[:, :, None] == cases_all[:, None, :]) & (cases_all[:, None, :] >= 0)
    earlier = torch.tril(
        torch.ones((M, M), dtype=torch.bool, device=eq.device), diagonal=-1
    )[None]
    dup = (eq & earlier).any(dim=-1)
    v_dedup = torch.where(dup, torch.full_like(v_all, _NEG_INF), v_all)
    kk = min(k, M)
    top_v, fpos = exact_topk(v_dedup, kk)
    top_i = torch.gather(i_all, 1, fpos)
    top_src = torch.gather(src_all, 1, fpos)
    top_cases = torch.gather(cases_all, 1, fpos)
    dead = torch.isneginf(top_v)
    return (
        top_v,
        torch.where(dead, torch.full_like(top_i, -1), top_i),
        torch.where(dead, torch.full_like(top_cases, -1), top_cases),
        torch.where(dead, torch.full_like(top_src, SRC_SEMANTIC), top_src),
    )


def _masked_int8_scores(
    q8, q_scale, corpus_q, corpus_scale, chunk_court, chunk_date,
    court_table, date_lo, date_hi, min_similarity, use_court, use_date,
) -> torch.Tensor:
    """Exact masked ``[B, N]`` scores: int8 product (f32 of int8 values,
    exact), ``acc * q_scale * corpus_scale``, filters + threshold."""
    exact_float32()
    acc = q8.to(torch.float32) @ corpus_q.to(torch.float32).T
    scores = acc * q_scale * corpus_scale.reshape(1, -1)
    keep = scores >= min_similarity[:, None]
    if use_court:
        keep &= _take_columns(court_table, chunk_court)
    if use_date:
        keep &= (chunk_date[None, :] >= date_lo[:, None]) & (
            chunk_date[None, :] <= date_hi[:, None]
        )
    return torch.where(keep, scores, torch.full_like(scores, _NEG_INF))


def fused_hybrid_topk(
    query_emb, corpus_q, corpus_scale, chunk_case, chunk_court, chunk_date,
    court_table, date_lo, date_hi, trie_rows, trie_src, trie_chunk_of_case,
    min_similarity, exact_weight, k: int, overfetch: int = 4,
    recall_target: float = 1.0, use_court: bool = True, use_date: bool = True,
):
    """Brute-scan fused step → ``(scores, chunk_idx, case_rows, src)`` each
    ``[B, k]``: k distinct cases per query (-inf/-1 padded)."""
    q8, q_scale = quantize_queries(query_emb)
    N = corpus_q.shape[0]
    ksem = min(max(k * max(1, overfetch), k), N)
    if use_scan_kernel(N, recall_target):
        sem_v, sem_i = fused_scan_topk(
            q8, q_scale, corpus_q, corpus_scale, chunk_court, chunk_date,
            court_table, date_lo, date_hi, min_similarity, k=ksem,
            use_court=use_court, use_date=use_date,
        )
        sem_i = torch.clamp(sem_i, min=0)
    else:
        scores = _masked_int8_scores(
            q8, q_scale, corpus_q, corpus_scale, chunk_court, chunk_date,
            court_table, date_lo, date_hi, min_similarity, use_court, use_date,
        )
        if recall_target >= 1.0:
            sem_v, sem_i = exact_topk(scores, ksem)
        else:
            sem_v, sem_i = fast_topk(scores, ksem, recall_target)
    lex_v, lex_chunk, lex_src = lexical_side_list(
        trie_rows, trie_src, trie_chunk_of_case, chunk_court, chunk_date,
        court_table, date_lo, date_hi, exact_weight,
    )
    return merge_dedup_topk(sem_v, sem_i, lex_v, lex_chunk, lex_src, chunk_case, k)


def fused_hybrid_topk_chunked(
    query_emb, corpus_q, corpus_scale, chunk_case, chunk_court, chunk_date,
    court_table, date_lo, date_hi, trie_rows, trie_src, trie_chunk_of_case,
    min_similarity, exact_weight, k: int, overfetch: int = 4,
    num_chunks: int = 16, recall_target: float = 1.0, use_court: bool = True,
    use_date: bool = True,
):
    """Brute fused step over ``num_chunks`` corpus slabs with a running
    top-k merge (bounded working set); same contract as
    :func:`fused_hybrid_topk`."""
    N = corpus_q.shape[0]
    q8, q_scale = quantize_queries(query_emb)
    ksem = min(max(k * max(1, overfetch), k), N)
    if N % num_chunks or (N // num_chunks) < ksem:
        return fused_hybrid_topk(
            query_emb, corpus_q, corpus_scale, chunk_case, chunk_court,
            chunk_date, court_table, date_lo, date_hi, trie_rows, trie_src,
            trie_chunk_of_case, min_similarity, exact_weight, k=k,
            overfetch=overfetch, recall_target=recall_target,
            use_court=use_court, use_date=use_date,
        )
    sem_v, sem_i = _chunked_semantic_scan(
        q8, q_scale, corpus_q, corpus_scale, chunk_court, chunk_date,
        court_table, date_lo, date_hi, min_similarity, ksem=ksem,
        num_chunks=num_chunks, recall_target=recall_target,
        use_court=use_court, use_date=use_date,
    )
    sem_i = torch.clamp(sem_i, min=0)
    lex_v, lex_chunk, lex_src = lexical_side_list(
        trie_rows, trie_src, trie_chunk_of_case, chunk_court, chunk_date,
        court_table, date_lo, date_hi, exact_weight,
    )
    return merge_dedup_topk(sem_v, sem_i, lex_v, lex_chunk, lex_src, chunk_case, k)


def _chunked_semantic_scan(
    q8, q_scale, corpus_q, corpus_scale, chunk_court, chunk_date,
    court_table, date_lo, date_hi, min_similarity, ksem: int,
    num_chunks: int, recall_target: float, use_court: bool, use_date: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slab walk with a running ``[B, ksem]`` top-k merge: each slab is
    one fused-scan call when the kernel applies (the stream's result
    depends on running the lane selection PER SLAB), the exact masked
    product otherwise. Returns ``(values, indices)`` into ``corpus_q``'s
    row space; dead slots ``-inf``."""
    B = q8.shape[0]
    N = corpus_q.shape[0]
    S = N // num_chunks
    slab_kernel = use_scan_kernel(S, recall_target)
    dev = q8.device
    best_v = torch.full((B, ksem), _NEG_INF, device=dev)
    best_i = torch.full((B, ksem), -1, dtype=torch.int32, device=dev)
    scale = corpus_scale.reshape(N)
    if slab_kernel:
        # the kernel's inputs once per batch; each slab takes a row slice
        query_inp = fused_scan_query_inputs(q_scale, court_table, date_lo, date_hi, min_similarity)
        row_inp = fused_scan_row_inputs(chunk_court, chunk_date, scale)
    for c in range(num_chunks):
        lo, hi = c * S, (c + 1) * S
        if slab_kernel:
            prepared = {**query_inp, **{n: t[lo:hi] for n, t in row_inp.items()}}
            v, i = fused_scan_topk(
                q8, q_scale, corpus_q[lo:hi], scale[lo:hi], chunk_court[lo:hi],
                chunk_date[lo:hi], court_table, date_lo, date_hi,
                min_similarity, k=ksem, use_court=use_court, use_date=use_date,
                prepared=prepared,
            )
            i = torch.clamp(i, min=0)
            if v.shape[1] < ksem:
                pad = ksem - v.shape[1]
                v = torch.cat([v, torch.full((B, pad), _NEG_INF, device=dev)], 1)
                i = torch.cat([i, torch.zeros((B, pad), dtype=i.dtype, device=dev)], 1)
        else:
            scores = _masked_int8_scores(
                q8, q_scale, corpus_q[lo:hi], scale[lo:hi], chunk_court[lo:hi],
                chunk_date[lo:hi], court_table, date_lo, date_hi,
                min_similarity, use_court, use_date,
            )
            v, i = exact_topk(scores, ksem)
        gi = i.to(torch.int32) + lo
        best_v, best_i = merge_topk(
            torch.stack([best_v, v], dim=1), torch.stack([best_i, gi], dim=1), ksem
        )
    return best_v, best_i


def fused_layout_brute_topk(
    query_emb, part_rows, part_int8, part_scale, corpus_bf16, slot_court,
    slot_date, chunk_case, chunk_court, chunk_date, court_table, date_lo,
    date_hi, trie_rows, trie_src, trie_chunk_of_case, min_similarity,
    exact_weight, k: int, overfetch: int = 4, num_chunks: int = 16,
    recall_target: float = 1.0, use_court: bool = True, use_date: bool = True,
    use_gather_kernel: bool = False,
):
    """Large-batch serving mode (the stream): one slab walk over the
    ``[P, m, D]`` partition layout per batch, slot → row map, bf16 rescore,
    then the shared tail. Same contract as :func:`fused_partitioned_topk`."""
    qn = query_emb.to(torch.float32)
    P, m = part_int8.shape[0], part_int8.shape[1]
    ksem = min(max(k * max(1, overfetch), k), P * m)
    sem_v, sem_rows = layout_brute_semantic_topk(
        qn, part_rows, part_int8, part_scale, corpus_bf16, slot_court,
        slot_date, court_table, date_lo, date_hi, min_similarity, ksem=ksem,
        num_chunks=num_chunks, recall_target=recall_target,
        use_court=use_court, use_date=use_date,
        use_gather_kernel=use_gather_kernel,
    )
    sem_rows = torch.clamp(sem_rows, min=0)
    lex_v, lex_chunk, lex_src = lexical_side_list(
        trie_rows, trie_src, trie_chunk_of_case, chunk_court, chunk_date,
        court_table, date_lo, date_hi, exact_weight,
    )
    return merge_dedup_topk(sem_v, sem_rows, lex_v, lex_chunk, lex_src, chunk_case, k)


def layout_brute_semantic_topk(
    qn, part_rows, part_int8, part_scale, corpus_bf16, slot_court, slot_date,
    court_table, date_lo, date_hi, min_similarity, ksem: int,
    num_chunks: int = 0, recall_target: float = 1.0, use_court: bool = True,
    use_date: bool = True, use_gather_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stream semantic stage: slab walk → slot→row map (pad slots die,
    replicas collapse) → optional bf16 rescore → composite (score, row)
    top-``ksem``. Returns ``(values, rows)``, dead ``(-inf, row)``."""
    P, m, D = part_int8.shape
    N2 = P * m
    q8, q_scale = quantize_queries(qn)
    ksem = min(ksem, N2)
    nc = num_chunks or pick_num_chunks(N2, int(qn.shape[0]), ksem)
    if N2 % nc or N2 // nc < ksem:
        nc = 1
    sem_v, sem_slot = _chunked_semantic_scan(
        q8, q_scale, part_int8.reshape(N2, D), part_scale.reshape(N2, 1),
        slot_court.reshape(N2), slot_date.reshape(N2), court_table, date_lo,
        date_hi, min_similarity, ksem=ksem, num_chunks=nc,
        recall_target=recall_target, use_court=use_court, use_date=use_date,
    )
    rows = part_rows.reshape(N2)[torch.clamp(sem_slot, min=0).long()]
    sem_v = torch.where(
        (sem_slot >= 0) & (rows >= 0), sem_v, torch.full_like(sem_v, _NEG_INF)
    )
    if corpus_bf16 is not None:
        safe_rows = torch.clamp(rows, min=0)
        if use_gather_kernel:
            re = gather_rescore_rows(qn, corpus_bf16, safe_rows)
        else:
            exact_float32()
            re = gather_rescore(qn, corpus_bf16, safe_rows)
        sem_v = torch.where(
            torch.isfinite(sem_v) & (re >= min_similarity[:, None]), re,
            torch.full_like(re, _NEG_INF),
        )
    return topk_by_score_then_row(sem_v, rows.to(torch.int32), ksem)


#: brute-mode working-set bound for one [B, N] f32 score matrix
_CHUNKED_WORKSET_BYTES = 256 * 1024 * 1024
#: minimum corpus rows per slab
_SLAB_MIN_ROWS = 65_536


def pick_num_chunks(n_rows: int, batch: int, k_fetch: int) -> int:
    """Slab count: smallest power of two keeping one slab's ``[B, S]`` f32
    score matrix under the working-set bound (the JAX package's rule)."""
    num_chunks = 1
    if 4 * batch * n_rows > _CHUNKED_WORKSET_BYTES:
        while (
            n_rows % (num_chunks * 2) == 0
            and n_rows // (num_chunks * 2) >= max(_SLAB_MIN_ROWS, k_fetch)
            and 4 * batch * (n_rows // num_chunks) > _CHUNKED_WORKSET_BYTES
        ):
            num_chunks *= 2
    return num_chunks


def resolve_probe_kernel(
    recall_target: float, m: int, dim: int = 384
) -> tuple[bool, bool]:
    """``(use_probe_kernel, forced)``: the probe and rescore kernels serve
    at ``recall_target < 1`` when partitions are 128-slot aligned and the
    width is a multiple of 128; ``TSS_PROBE_INTERPRET=1`` (the JAX
    package's switch) lifts the width rule so small test widths walk the
    kernel branch too."""
    forced = os.environ.get("TSS_PROBE_INTERPRET") == "1"
    use = recall_target < 1.0 and m % 128 == 0 and (dim % 128 == 0 or forced)
    return use, forced


def fused_partitioned_topk(
    query_emb, centroids, part_rows, part_int8, part_scale, corpus_bf16,
    chunk_case, chunk_court, chunk_date, court_table, date_lo, date_hi,
    trie_rows, trie_src, trie_chunk_of_case, min_similarity, exact_weight,
    k: int, nprobe: int, overfetch: int = 4, rescore_factor: int = 4,
    recall_target: float = 1.0, part_cword=None, part_cbit=None,
    part_date=None, use_probe_kernel: Optional[bool] = None,
):
    """Partitioned fused step (the probe): centroid probe + filtered scan of
    the probed blocks + bf16 rescore + the shared tail →
    ``(scores, chunk_idx, case_rows, src)`` each ``[B, k]``."""
    qn = query_emb.to(torch.float32)
    m = part_rows.shape[1]
    np_eff = min(nprobe, centroids.shape[0])
    ksem = min(max(k * max(1, overfetch), k), np_eff * m)
    W = min(ksem * max(1, rescore_factor), np_eff * m)
    if use_probe_kernel is None:
        use_probe_kernel, _ = resolve_probe_kernel(
            recall_target, m, int(part_int8.shape[-1])
        )
    # the TPU kernel's SMEM demotion, kept so results stay equal
    if int(qn.shape[0]) * np_eff * 4 > 768 * 1024:
        use_probe_kernel = False
    sem_v, sem_chunk = partitioned_semantic_topk(
        qn, centroids, part_rows, part_int8, part_scale, corpus_bf16,
        chunk_court, chunk_date, court_table, date_lo, date_hi,
        min_similarity, ksem=min(ksem, W), W=W, np_eff=np_eff,
        use_probe_kernel=use_probe_kernel, part_cword=part_cword,
        part_cbit=part_cbit, part_date=part_date,
    )
    sem_chunk = torch.clamp(sem_chunk, min=0).to(torch.int32)
    lex_v, lex_chunk, lex_src = lexical_side_list(
        trie_rows, trie_src, trie_chunk_of_case, chunk_court, chunk_date,
        court_table, date_lo, date_hi, exact_weight,
    )
    return merge_dedup_topk(sem_v, sem_chunk, lex_v, lex_chunk, lex_src, chunk_case, k)


def partitioned_semantic_topk(
    qn, centroids, part_rows, part_int8, part_scale, corpus_bf16,
    chunk_court, chunk_date, court_table, date_lo, date_hi, min_similarity,
    ksem: int, W: int, np_eff: int, use_probe_kernel: bool,
    part_cword=None, part_cbit=None, part_date=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe semantic stage: probe → filtered scan of the probed blocks
    (kernel branch, or the exact per-probe gather branch) → bf16 rescore
    → top-``ksem``. Returns ``(values, rows)``, dead slots ``-inf``."""
    exact_float32()
    B = qn.shape[0]
    m = part_rows.shape[1]
    dev = qn.device
    cs = qn @ centroids.to(torch.float32).T
    _, top_p = exact_topk(cs, np_eff)
    q8, q_scale = quantize_queries(qn)
    if part_cword is None or part_cbit is None or part_date is None:
        safe = torch.clamp(part_rows, min=0).long()
        word, part_cbit = court_word_bit(chunk_court[safe])
        part_cword = torch.where(part_rows >= 0, word, torch.full_like(word, -1))
        part_date = torch.where(
            part_rows >= 0, chunk_date[safe].to(torch.int32),
            torch.full_like(part_rows, -(2**31)),
        )
    qwords = pack_court_words(court_table)

    if use_probe_kernel:
        kc_v, kc_s = probe_candidates(
            q8, q_scale, top_p, part_int8, part_scale, part_rows, part_cword,
            part_cbit, part_date, qwords, date_lo, date_hi, min_similarity,
        )
        lanes_n = kc_v.shape[1] // np_eff
        rows3 = part_rows[top_p[:, :, None], kc_s.reshape(B, np_eff, lanes_n).long()]
        cand_v, cand_rows = topk_by_score_then_row(
            kc_v, rows3.reshape(B, -1), min(W, kc_v.shape[1])
        )
    else:
        Wc = qwords.shape[1]
        cand_v = torch.full((B, W), _NEG_INF, device=dev)
        cand_rows = torch.full((B, W), -1, dtype=part_rows.dtype, device=dev)
        q8f = q8.to(torch.float32)
        for p in range(np_eff):
            col = top_p[:, p]
            rows = part_rows[col]
            acc = torch.einsum("bd,bmd->bm", q8f, part_int8[col].to(torch.float32))
            scores = acc * part_scale[col] * q_scale
            cw = part_cword[col].to(torch.int64)
            qw = torch.gather(qwords, 1, torch.clamp(cw, 0, Wc - 1))
            court_ok = ((qw & part_cbit[col]) != 0) & (cw >= 0)
            dts = part_date[col]
            date_ok = (dts >= date_lo[:, None]) & (dts <= date_hi[:, None])
            keep = (rows >= 0) & court_ok & date_ok & (scores >= min_similarity[:, None])
            scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
            v, i = exact_topk(scores, min(W, m))
            r = torch.gather(rows, 1, i)
            if v.shape[1] < W:
                pad = W - v.shape[1]
                v = torch.cat([v, torch.full((B, pad), _NEG_INF, device=dev)], 1)
                r = torch.cat([r, torch.full((B, pad), -1, dtype=r.dtype, device=dev)], 1)
            cand_v, cand_rows = merge_topk(
                torch.stack([cand_v, v], dim=1), torch.stack([cand_rows, r], dim=1), W
            )

    safe_rows = torch.clamp(cand_rows, min=0)
    if corpus_bf16 is not None:
        if use_probe_kernel:
            re = gather_rescore_rows(qn, corpus_bf16, safe_rows)
        else:
            re = gather_rescore(qn, corpus_bf16, safe_rows)
        re = torch.where(
            torch.isfinite(cand_v) & (re >= min_similarity[:, None]), re,
            torch.full_like(re, _NEG_INF),
        )
    else:
        re = cand_v
    return topk_by_score_then_row(re, cand_rows.to(torch.int32), min(ksem, W))
