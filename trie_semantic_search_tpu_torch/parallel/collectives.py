"""Sharded search: shard-local top-k on each shard's device, one merge.

Port of ``trie_semantic_search_tpu/parallel/collectives.py``. The JAX
package runs one ``shard_map`` program per call: every chip scores its
corpus shard, keeps a shard-local top-k, and an ``all_gather`` brings the
``S·k`` lists to every chip for the final merge. Here each process issues
the stages of the shards it owns on their devices, in shard order, then
copies each local shard's ``[B, k]`` lists to its first local device; on a
mesh across processes those lists are all-gathered over the job's process
group (:func:`.mesh.all_gather_shards`), so that every process merges the
same ``S·k`` lists in global shard order, and so returns bitwise what a
single-process mesh of the same shape returns. The results are wanted on
one device per process, since the caller copies them to the host.

Each stage is the port's single-device one (:mod:`..ops.hybrid`, the
kernel wrappers of :mod:`..ops.scan_kernels`) run on the shard's own rows,
whose ids it then offsets by ``shard * shard_rows``. Every shard's work is
issued before the first copy to the merge device, and the copies are
``non_blocking`` from each device's current stream, so shards on separate
cards do not wait on each other.

Semantics are the JAX package's: the same filters (on lexical hits too),
dedup by case on each shard and again after the merge, pad rows (from
:func:`.mesh.pad_corpus`) masked by global row id, and ties in shard order
(shard lists concatenate shard-major, the merge is a stable exact top-k).

Sharded inputs are a list of per-shard blocks (:func:`.mesh.shard_rows`,
:func:`.mesh.shard_leading`) or one tensor, which is split here;
replicated inputs are one tensor on any device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
from torch.profiler import record_function

from ..ops.hybrid import (
    SRC_SEMANTIC,
    _take_columns,
    layout_brute_semantic_topk,
    partitioned_semantic_topk,
    quantize_queries,
)
from ..ops.scan_kernels import TILE_N, exact_float32, fused_scan_topk
from ..ops.scoring import cosine_scores, cosine_scores_int8
from ..ops.topk import exact_topk, fast_topk, merge_topk
from .mesh import DATA_AXIS, Mesh, all_gather_shards, replicate, shard_leading, shard_rows

Sharded = Union[torch.Tensor, Sequence[torch.Tensor]]

_NEG_INF = -float("inf")


def resolve_scan_kernel(
    recall_target: float, shard_rows: int, device: torch.device,
    force_kernel: bool = False,
) -> tuple[str, bool]:
    """The per-shard brute scan of :func:`sharded_fused_topk` →
    ``(scan_mode, forced)``. ``"kernel"`` runs the fused-scan kernel
    (:func:`..ops.scan_kernels.fused_scan_topk`), as single-device serving
    does, when its lane approximation is allowed (``recall_target < 1``),
    the shard rows divide into tiles and the shards lie on CUDA;
    ``"matmul"`` materialises the shard's ``[B, n_local]`` scores and takes
    an exact top-k. ``force_kernel`` (for tests) lifts the CUDA rule, so
    that CPU shards walk the kernel route through its plain version."""
    use = (
        recall_target < 1.0
        and shard_rows % TILE_N == 0
        and (torch.device(device).type == "cuda" or force_kernel)
    )
    return ("kernel" if use else "matmul"), force_kernel


def _on(device: torch.device):
    """Make ``device`` current for the launches inside (a CUDA device's
    current stream is the one its kernels go to)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _shard(s: int, device: torch.device):
    """Shard ``s``'s stage: on its device, under the profiler range
    ``sharded shard <s>`` (so a trace splits device time by shard)."""
    with _on(device), record_function(f"sharded shard {s}"):
        yield


def _blocks(x: Sharded, mesh: Mesh, leading: bool = False) -> list[Optional[torch.Tensor]]:
    """A sharded input as its per-shard blocks (``None`` where another
    process owns the shard)."""
    if isinstance(x, torch.Tensor):
        return shard_leading(x, mesh) if leading else shard_rows(x, mesh)
    blocks = list(x)
    if len(blocks) != mesh.shape[DATA_AXIS]:
        raise ValueError(f"{len(blocks)} blocks for {mesh.shape[DATA_AXIS]} shards")
    return blocks


def _local_block(blocks: list, mesh: Mesh) -> torch.Tensor:
    """The block of this process's first shard (every shard's has the same
    shape)."""
    return blocks[mesh.local_data_rows[0]]


def _gather(mesh: Mesh, per_shard: list[tuple[torch.Tensor, ...]]) -> tuple[torch.Tensor, ...]:
    """The outputs of every shard (``per_shard``: this process's, in its
    shard order) on its first local device, stacked in global shard order
    (``[S, ...]`` each): the port's ``all_gather``. Called after every
    local shard's work is issued."""
    dst = mesh.first_device
    moved = []
    for s, outs in zip(mesh.local_data_rows, per_shard):
        with _on(mesh.data_devices[s]):
            moved.append(tuple(t.to(dst, non_blocking=True) for t in outs))
    return tuple(all_gather_shards(mesh, torch.stack(parts)) for parts in zip(*moved))


def _dedup_by_case_sorted(values: torch.Tensor, cases: torch.Tensor) -> torch.Tensor:
    """Mask later duplicates of an already-seen case in a score-sorted
    candidate list (``values/cases [B, M]``, sorted desc) to ``-inf``."""
    M = values.shape[1]
    eq = (cases[:, :, None] == cases[:, None, :]) & (cases[:, None, :] >= 0)
    earlier = torch.tril(torch.ones((M, M), dtype=torch.bool, device=values.device), diagonal=-1)
    dup = (eq & earlier[None]).any(dim=-1)
    return torch.where(dup, torch.full_like(values, _NEG_INF), values)


def _local_dedup_topk(
    v: torch.Tensor,  # [B, kf] shard-local candidate scores, sorted desc
    local_rows: torch.Tensor,  # [B, kf] shard-local row ids (valid where finite)
    sh_case: torch.Tensor,  # [n_local] shard-local chunk→case column
    shard: int,
    shard_rows: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shard-local dedup by case → the top-k distinct cases with GLOBAL
    row ids: ``(values, cases, global_rows)`` each ``[B, k]``. Exact for
    the global top-k distinct cases: a case's best chunk lives on one
    shard, where at most k-1 distinct cases can outrank it."""
    i32 = torch.int32
    dead = torch.isneginf(v)
    safe = torch.clamp(local_rows.long(), 0, sh_case.shape[0] - 1)
    cases = torch.where(dead, torch.full_like(safe, -1, dtype=i32), sh_case[safe].to(i32))
    rows = torch.where(dead, torch.full_like(cases, -1), local_rows.to(i32) + shard * shard_rows)
    v = _dedup_by_case_sorted(v, cases)
    v, pos = exact_topk(v, min(k, v.shape[1]))
    cases = torch.gather(cases, 1, pos)
    rows = torch.gather(rows, 1, pos)
    dead = torch.isneginf(v)
    return v, torch.where(dead, -1, cases), torch.where(dead, -1, rows)


def _gather_merge_lexical(
    v: torch.Tensor,  # [S, B, k] shard-local top-k (distinct cases)
    cases: torch.Tensor,  # [S, B, k] case rows (-1 dead)
    rows: torch.Tensor,  # [S, B, k] global chunk rows (-1 dead)
    lex: torch.Tensor,  # [B, R] lexical-hit case rows (-1 pad)
    lsrc: torch.Tensor,  # [B, R] SRC_* codes
    lchunk: torch.Tensor,  # [B, R] representative chunk row per hit
    c_court: torch.Tensor,  # [C] case-level court column
    c_date: torch.Tensor,  # [C] case-level date column
    ctable: torch.Tensor,  # [B, V] allowed-court table
    dlo: torch.Tensor,  # [B]
    dhi: torch.Tensor,  # [B]
    ew: torch.Tensor,  # [B] exact weight
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge of the gathered shard lists (``S·k`` per query, shard-major)
    with the filter-checked lexical boost list, global dedup by case,
    final top-k → ``(scores, chunk_rows, case_rows, src)`` each ``[B, k]``."""
    i32 = torch.int32
    B = v.shape[1]
    mv = v.permute(1, 0, 2).reshape(B, -1)  # [B, S*k]
    mc = cases.permute(1, 0, 2).reshape(B, -1)
    mr = rows.permute(1, 0, 2).reshape(B, -1)

    # lexical boost, filter-checked against the case-level columns
    safe_lex = torch.clamp(lex.long(), min=0)
    lex_court_ok = torch.gather(ctable, 1, c_court[safe_lex].long())
    lex_dates = c_date[safe_lex]
    lex_date_ok = (lex_dates >= dlo[:, None]) & (lex_dates <= dhi[:, None])
    lex_ok = (lex >= 0) & lex_court_ok & lex_date_ok
    lex_v = torch.where(lex_ok, ew[:, None].to(torch.float32).expand_as(lex_ok),
                        torch.full(lex_ok.shape, _NEG_INF, device=lex.device))

    merged_v = torch.cat([mv, lex_v], dim=1)  # [B, S*k+R]
    merged_c = torch.cat([mc, lex.to(i32)], dim=1)
    merged_r = torch.cat([mr, lchunk.to(i32)], dim=1)
    merged_src = torch.cat([torch.full_like(mc, SRC_SEMANTIC), lsrc.to(i32)], dim=1)
    M = merged_v.shape[1]
    v_all, pos = exact_topk(merged_v, M)
    c_all = torch.gather(merged_c, 1, pos)
    r_all = torch.gather(merged_r, 1, pos)
    s_all = torch.gather(merged_src, 1, pos)
    c_all = torch.where(torch.isfinite(v_all), c_all, -1)
    v_all = _dedup_by_case_sorted(v_all, c_all)
    fv, fpos = exact_topk(v_all, min(k, M))
    fc = torch.gather(c_all, 1, fpos)
    fr = torch.gather(r_all, 1, fpos)
    fs = torch.gather(s_all, 1, fpos)
    dead = torch.isneginf(fv)
    return fv, torch.where(dead, -1, fr), torch.where(dead, -1, fc), torch.where(dead, SRC_SEMANTIC, fs)


def _merge_on_first(mesh: Mesh, per_shard, lexical: tuple, k: int):
    """Gather the shards' ``(v, cases, rows)`` and merge them with the
    lexical list (``lexical``: the replicated arguments of
    :func:`_gather_merge_lexical` after ``rows``) on the first local
    device."""
    with record_function("sharded merge"):
        v, cases, rows = _gather(mesh, per_shard)
        dst = mesh.first_device
        return _gather_merge_lexical(v, cases, rows, *(t.to(dst) for t in lexical), k)


def sharded_fused_topk(
    mesh: Mesh,
    query_emb: torch.Tensor,  # [B, D] f32, replicated
    corpus_q: Sharded,  # [Npad, D] int8, row-sharded
    corpus_scale: Sharded,  # [Npad, 1] f32, row-sharded
    chunk_case: Sharded,  # [Npad] int32, row-sharded
    chunk_court: Sharded,  # [Npad] int32, row-sharded
    chunk_date: Sharded,  # [Npad] int32, row-sharded
    court_table: torch.Tensor,  # [B, V] bool
    date_lo: torch.Tensor,  # [B] int32
    date_hi: torch.Tensor,  # [B] int32
    lex_cases: torch.Tensor,  # [B, R] int32 lexical-hit case rows (-1 pad)
    lex_src: torch.Tensor,  # [B, R] int32 SRC_* code per lexical hit
    lex_chunk: torch.Tensor,  # [B, R] int32 representative chunk row per hit
    case_court: torch.Tensor,  # [C] int32 case-level court column
    case_date: torch.Tensor,  # [C] int32 case-level date column
    min_similarity: torch.Tensor,  # [B] f32
    exact_weight: torch.Tensor,  # [B] f32
    k: int,
    n_valid: Optional[int] = None,
    overfetch: int = 4,
    recall_target: float = 1.0,
    scan_mode: str = "matmul",  # "matmul" | "kernel" (resolve_scan_kernel)
    use_court: bool = True,
    use_date: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded brute serving step: each shard runs the filtered int8 scan
    over its rows (the fused-scan kernel with ``scan_mode="kernel"``, the
    masked product otherwise), dedups by case, and the shard lists merge
    with the lexical boost on the first device. Returns ``(scores [B, k],
    chunk_rows, case_rows, src)`` (-inf/-1 padded) on the mesh's first
    device: k distinct cases per query, the contract of
    :func:`..ops.hybrid.fused_hybrid_topk`. Rows at or past ``n_valid``
    (``pad_corpus`` pads) never surface."""
    S = mesh.shape[DATA_AXIS]
    cq = _blocks(corpus_q, mesh)
    cs, ccase, ccourt, cdate = (_blocks(x, mesh) for x in (corpus_scale, chunk_case,
                                                           chunk_court, chunk_date))
    shard_n = _local_block(cq, mesh).shape[0]
    n_real = shard_n * S if n_valid is None else int(n_valid)
    kf = min(max(k * max(1, overfetch), k), shard_n)
    reps = [replicate(t, mesh) for t in (query_emb, court_table, date_lo, date_hi, min_similarity)]
    per_shard = []
    for s in mesh.local_data_rows:
        dev = mesh.data_devices[s]
        q, ctable, dlo, dhi, msim = (r[s] for r in reps)
        with _shard(s, dev):
            q8, q_scale = quantize_queries(q)
            if scan_mode == "kernel":
                v, i = fused_scan_topk(
                    q8, q_scale, cq[s], cs[s].reshape(-1, 1), ccourt[s], cdate[s], ctable,
                    dlo, dhi, msim, k=kf, use_court=use_court, use_date=use_date,
                )
                # the kernel cannot know the real row count: pad rows die
                # by global row id (their zero scales already score 0)
                glob = i + s * shard_n
                v = torch.where((i >= 0) & (glob < n_real), v, torch.full_like(v, _NEG_INF))
                local_rows = torch.clamp(i, min=0)
            else:
                exact_float32()
                acc = q8.to(torch.float32) @ cq[s].to(torch.float32).T
                scores = acc * q_scale * cs[s].reshape(1, -1)
                glob = s * shard_n + torch.arange(shard_n, dtype=torch.int32, device=dev)
                keep = (glob < n_real)[None, :] & (scores >= msim[:, None])
                if use_court:
                    keep &= _take_columns(ctable, ccourt[s])
                if use_date:
                    keep &= (cdate[s][None, :] >= dlo[:, None]) & (cdate[s][None, :] <= dhi[:, None])
                scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
                if recall_target >= 1.0:
                    v, local_rows = exact_topk(scores, kf)
                else:
                    v, local_rows = fast_topk(scores, kf, recall_target)
            per_shard.append(_local_dedup_topk(v, local_rows, ccase[s], s, shard_n, k))
    return _merge_on_first(
        mesh, per_shard,
        (lex_cases, lex_src, lex_chunk, case_court, case_date, court_table, date_lo, date_hi,
         exact_weight), k,
    )


def sharded_partitioned_topk(
    mesh: Mesh,
    query_emb: torch.Tensor,  # [B, D] f32 (L2-normalised), replicated
    centroids: torch.Tensor,  # [P, D] f32 global k-means centroids, replicated
    part_rows: Sharded,  # [S, P, m] int32 SHARD-LOCAL row per slot (-1 pad)
    part_int8: Sharded,  # [S, P, m, D] int8
    part_scale: Sharded,  # [S, P, m] f32
    part_cword: Sharded,  # [S, P, m] int32 court word per slot
    part_cbit: Sharded,  # [S, P, m] int32 court bit pattern per slot
    part_date: Sharded,  # [S, P, m] int32 date per slot
    corpus_bf16: Sharded,  # [Npad, D] bf16 rescore copy, row-sharded
    chunk_case: Sharded,  # [Npad] int32, row-sharded
    court_table: torch.Tensor,  # [B, V] bool
    date_lo: torch.Tensor,  # [B] int32
    date_hi: torch.Tensor,  # [B] int32
    lex_cases: torch.Tensor,  # [B, R] int32
    lex_src: torch.Tensor,  # [B, R] int32
    lex_chunk: torch.Tensor,  # [B, R] int32
    case_court: torch.Tensor,  # [C] int32
    case_date: torch.Tensor,  # [C] int32
    min_similarity: torch.Tensor,  # [B] f32
    exact_weight: torch.Tensor,  # [B] f32
    k: int,
    nprobe: int,
    overfetch: int = 4,
    rescore_factor: int = 4,
    use_probe_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded partitioned step: the corpus is partitioned per shard
    against shared global centroids (:func:`..index.sharded.
    build_sharded_partitions`); each shard probes the same ``nprobe``
    centroids, scans its own probed blocks (the probe kernel with
    ``use_probe_kernel``, the exact per-probe gather otherwise), rescores
    its candidates in bf16 (the rescore kernel with ``use_probe_kernel``)
    and dedups by case; the shard lists merge on the first device.
    ``part_rows`` hold shard-local rows. Same output contract as
    :func:`sharded_fused_topk`.

    The JAX package demotes the probe kernel to its gather scan when
    ``B·nprobe·4`` bytes of probed ids outgrow the TPU's scalar memory; the
    CUDA probe has no such limit, so here ``use_probe_kernel`` (from
    :func:`..ops.hybrid.resolve_probe_kernel`) holds at every batch."""
    prows = _blocks(part_rows, mesh, leading=True)
    pint8, pscale, pcw, pcb, pdt = (_blocks(x, mesh, leading=True)
                                    for x in (part_int8, part_scale, part_cword, part_cbit, part_date))
    bf16, ccase = _blocks(corpus_bf16, mesh), _blocks(chunk_case, mesh)
    shard_n = _local_block(bf16, mesh).shape[0]
    m = _local_block(prows, mesh).shape[1]
    np_eff = min(nprobe, centroids.shape[0])
    ksem = min(max(k * max(1, overfetch), k), np_eff * m)
    W = min(ksem * max(1, rescore_factor), np_eff * m)
    reps = [replicate(t, mesh) for t in (query_emb, centroids, court_table, date_lo, date_hi,
                                          min_similarity)]
    per_shard = []
    for s in mesh.local_data_rows:
        dev = mesh.data_devices[s]
        q, cent, ctable, dlo, dhi, msim = (r[s] for r in reps)
        with _shard(s, dev):
            sem_v, local_rows = partitioned_semantic_topk(
                q.to(torch.float32), cent, prows[s], pint8[s], pscale[s], bf16[s], None, None,
                ctable, dlo, dhi, msim, ksem=ksem, W=W, np_eff=np_eff,
                use_probe_kernel=use_probe_kernel, part_cword=pcw[s], part_cbit=pcb[s],
                part_date=pdt[s],
            )
            per_shard.append(_local_dedup_topk(sem_v, local_rows, ccase[s], s, shard_n, k))
    return _merge_on_first(
        mesh, per_shard,
        (lex_cases, lex_src, lex_chunk, case_court, case_date, court_table, date_lo, date_hi,
         exact_weight), k,
    )


def sharded_layout_brute_topk(
    mesh: Mesh,
    query_emb: torch.Tensor,  # [B, D] f32 (L2-normalised), replicated
    part_rows: Sharded,  # [S, P, m] int32 SHARD-LOCAL row per slot (-1 pad)
    part_int8: Sharded,  # [S, P, m, D] int8
    part_scale: Sharded,  # [S, P, m] f32
    slot_court: Sharded,  # [S, P, m] int32 court id per slot (-1 pad)
    slot_date: Sharded,  # [S, P, m] int32 date per slot (INT32_MIN pad)
    corpus_bf16: Sharded,  # [Npad, D] bf16 rescore copy, row-sharded
    chunk_case: Sharded,  # [Npad] int32, row-sharded
    court_table: torch.Tensor,  # [B, V] bool
    date_lo: torch.Tensor,  # [B] int32
    date_hi: torch.Tensor,  # [B] int32
    lex_cases: torch.Tensor,  # [B, R] int32
    lex_src: torch.Tensor,  # [B, R] int32
    lex_chunk: torch.Tensor,  # [B, R] int32
    case_court: torch.Tensor,  # [C] int32
    case_date: torch.Tensor,  # [C] int32
    min_similarity: torch.Tensor,  # [B] f32
    exact_weight: torch.Tensor,  # [B] f32
    k: int,
    overfetch: int = 4,
    recall_target: float = 1.0,
    use_court: bool = True,
    use_date: bool = True,
    use_gather_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded large-batch step (the stream): each shard walks its own
    partition layout (the single-device
    :func:`..ops.hybrid.layout_brute_semantic_topk`: the fused-scan kernel
    per slab at ``recall_target < 1``, then the bf16 rescore), dedups by
    case, and the shard lists merge on the first device. Same output
    contract as :func:`sharded_partitioned_topk`."""
    prows = _blocks(part_rows, mesh, leading=True)
    pint8, pscale, scourt, sdate = (_blocks(x, mesh, leading=True)
                                    for x in (part_int8, part_scale, slot_court, slot_date))
    bf16, ccase = _blocks(corpus_bf16, mesh), _blocks(chunk_case, mesh)
    shard_n = _local_block(bf16, mesh).shape[0]
    P, m = _local_block(prows, mesh).shape
    ksem = min(max(k * max(1, overfetch), k), int(P) * int(m))
    reps = [replicate(t, mesh) for t in (query_emb, court_table, date_lo, date_hi, min_similarity)]
    per_shard = []
    for s in mesh.local_data_rows:
        dev = mesh.data_devices[s]
        q, ctable, dlo, dhi, msim = (r[s] for r in reps)
        with _shard(s, dev):
            sem_v, local_rows = layout_brute_semantic_topk(
                q.to(torch.float32), prows[s], pint8[s], pscale[s], bf16[s], scourt[s], sdate[s],
                ctable, dlo, dhi, msim, ksem=ksem, recall_target=recall_target,
                use_court=use_court, use_date=use_date, use_gather_kernel=use_gather_kernel,
            )
            per_shard.append(_local_dedup_topk(sem_v, local_rows, ccase[s], s, shard_n, k))
    return _merge_on_first(
        mesh, per_shard,
        (lex_cases, lex_src, lex_chunk, case_court, case_date, court_table, date_lo, date_hi,
         exact_weight), k,
    )


def _sharded_scan_topk(mesh: Mesh, queries, blocks: list, score, k: int,
                       n_valid: Optional[int], recall_target: float):
    """Each local shard's ``score(q, s)`` scores, pad rows masked, a
    shard-local top-k with global ids, then the exact merge of every
    shard's list on the first local device."""
    shard_n = _local_block(blocks, mesh).shape[0]
    n_real = shard_n * len(blocks) if n_valid is None else int(n_valid)
    qs = replicate(queries, mesh)
    per_shard = []
    for s in mesh.local_data_rows:
        dev = mesh.data_devices[s]
        with _shard(s, dev):
            scores = score(qs[s], s)
            glob = s * shard_n + torch.arange(shard_n, dtype=torch.int32, device=dev)
            scores = torch.where((glob < n_real)[None, :], scores, torch.full_like(scores, _NEG_INF))
            if recall_target >= 1.0:
                v, i = exact_topk(scores, k)
            else:
                v, i = fast_topk(scores, k, recall_target)
            gi = i.to(torch.int32) + s * shard_n
            per_shard.append((v, torch.where(torch.isneginf(v), -1, gi)))
    with record_function("sharded merge"):
        all_v, all_i = _gather(mesh, per_shard)  # [S, B, k']
        return merge_topk(all_v.permute(1, 0, 2), all_i.permute(1, 0, 2), k)


def sharded_brute_topk(
    mesh: Mesh,
    queries: torch.Tensor,  # [B, D], replicated
    corpus: Sharded,  # [N, D] row-sharded (N divisible by S)
    k: int,
    n_valid: Optional[int] = None,
    recall_target: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k over a row-sharded corpus → ``(values [B, k],
    global_indices [B, k])`` on the first device. Rows at or past
    ``n_valid`` (padding) score ``-inf``."""
    blocks = _blocks(corpus, mesh)
    return _sharded_scan_topk(mesh, queries, blocks, lambda q, s: cosine_scores(q, blocks[s]),
                              k, n_valid, recall_target)


def sharded_int8_topk(
    mesh: Mesh,
    queries: torch.Tensor,  # [B, D] f32, replicated
    corpus_q: Sharded,  # [N, D] int8, row-sharded
    corpus_scale: Sharded,  # [N, 1] f32, row-sharded
    k: int,
    n_valid: Optional[int] = None,
    recall_target: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sharded_brute_topk` over an int8-quantised corpus."""
    cq, cs = _blocks(corpus_q, mesh), _blocks(corpus_scale, mesh)
    return _sharded_scan_topk(
        mesh, queries, cq, lambda q, s: cosine_scores_int8(q, cq[s], cs[s]), k, n_valid,
        recall_target,
    )
