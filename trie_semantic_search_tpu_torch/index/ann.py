"""Partitioned ANN index: build, tune, save, load and serve.

Port of ``trie_semantic_search_tpu/index/ann.py`` (``build``, the layout
helpers, ``tune_nprobe``, ``save``, ``save_dir``, ``load``, ``load_dir``,
``default_nprobe``, ``search``, ``search_brute``). The frozen layout is the
JAX package's: ``[P, m, D]`` int8 partition blocks with per-slot scales, a
``[P, m]`` slot→row map (-1 pads), ``[P, D]`` centroids and a bf16 rescore
copy of the corpus held as a tuple of row segments. Both artifact formats
load and save here (``.npz`` with f16 rescore members, and the raw ``.npy``
directory with uint16 bf16 bit views), so either package reads what the
other wrote.

``build`` runs each step where the JAX package runs it: k-means and the
top-c centroid assignment on the index's device (:mod:`.kmeans`);
normalisation, the capacity cap, the overflow rebalance, the pad-replica
plan, the layout and the int8 quantisation in numpy on the host, so that
from fixed centroids the layout is bitwise the JAX package's. The memmap
emit of ``build_streaming`` comes with a later slice.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from numpy.lib import format as npformat

from ..core.config import AnnConfig
from ..core.errors import IndexCorrupted, VectorIndexConstructionFailed
from ..device import DeviceLike, resolve_device
from ..ops.scan_kernels import (
    exact_float32,
    gather_rescore_rows,
    probe_candidates,
    split_rescore_corpus,
)
from ..ops.scoring import gather_rescore, l2_normalize
from ..ops.topk import exact_topk, merge_topk, topk_by_score_then_row
from .kmeans import assign_clusters, assign_topc, train_kmeans

_log = logging.getLogger("tss_torch.ann")

#: host rows copied per step when moving a (memmapped) array to the device
_COPY_ROWS = 1 << 18


def to_device(arr: np.ndarray, device: torch.device, bf16_bits: bool = False) -> torch.Tensor:
    """Host array (possibly a memmap) → device tensor, copied in row slabs
    so the host never holds a second full copy. ``bf16_bits``: the array
    holds bf16 values as uint16 bit patterns."""
    src = arr.view(np.int16) if bf16_bits else arr
    if src.ndim == 0:
        return torch.as_tensor(np.array(src), device=device)
    dtype = torch.bfloat16 if bf16_bits else torch.from_numpy(np.zeros(0, src.dtype)).dtype
    out = torch.empty(src.shape, dtype=dtype, device=device)
    for lo in range(0, src.shape[0], _COPY_ROWS):
        part = torch.from_numpy(np.array(src[lo : lo + _COPY_ROWS]))
        if bf16_bits:
            part = part.view(torch.bfloat16)
        out[lo : lo + _COPY_ROWS].copy_(part)
    return out


# -- layout helpers (numpy, as in the JAX package) -----------------------------


def _aligned_capacity(fill_max: int, quantize: bool) -> int:
    """Partition slot capacity: 128-aligned (the probe kernel's block) when
    that costs at most 15% over the 8-aligned capacity, else 8-aligned."""
    m8 = max(8, -(-fill_max // 8) * 8)
    m128 = max(128, -(-fill_max // 128) * 128)
    if quantize and m128 <= 1.15 * m8:
        return m128
    return m8


def _capacity_cap(n: int, P: int, overalloc: float) -> int:
    """Per-partition slot cap, ``overalloc`` times the mean fill plus an
    ``8·sqrt(mean)`` slack, so one giant cluster cannot size every
    partition of the dense ``[P, m, D]`` layout."""
    mean = -(-n // max(P, 1))
    return max(8, int(overalloc * mean) + 8 * int(np.sqrt(mean)))


def _rebalance_overflow(
    assign: np.ndarray,  # [N] int32 partition per row (a changed copy is returned)
    cap: int,
    centroids: np.ndarray,  # [P, D] f32
    norm_rows: Callable[[np.ndarray], np.ndarray],  # rows -> [len(rows), D] normalised
    choices: int = 16,
    slab: int = 16_384,
) -> np.ndarray:
    """Each overfull partition keeps its ``cap`` closest members (ties:
    lower row id) and spills the rest to their best-scoring centroid with
    free space, walking up to ``choices`` candidates in score order (ties:
    lower partition id), else to the least-filled partition."""
    n = len(assign)
    P = centroids.shape[0]
    counts = np.bincount(assign, minlength=P)
    if not len(counts) or int(counts.max()) <= cap:
        return assign
    order = np.argsort(assign, kind="stable")  # partition-major, row asc
    offs = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    spilled: list[np.ndarray] = []
    for p in np.nonzero(counts > cap)[0]:
        rows_p = order[offs[p] : offs[p] + counts[p]]
        s = np.empty(len(rows_p), np.float32)
        for lo in range(0, len(rows_p), slab):
            s[lo : lo + slab] = norm_rows(rows_p[lo : lo + slab]) @ centroids[p]
        keep = np.argsort(-s, kind="stable")[:cap]
        mask = np.ones(len(rows_p), bool)
        mask[keep] = False
        spilled.append(rows_p[mask])
    overflow_rows = np.sort(np.concatenate(spilled))
    new_counts = np.minimum(counts, cap)
    assign = assign.copy()
    _log.info(
        "partition overflow: %d/%d rows beyond cap %d (max fill %d); "
        "reassigning to next-best centroids",
        len(overflow_rows), n, cap, int(counts.max()),
    )
    for lo in range(0, len(overflow_rows), slab):
        rows = overflow_rows[lo : lo + slab]
        s = norm_rows(rows) @ centroids.T  # [r, P]
        k = min(choices, P)
        idx = np.argpartition(-s, k - 1, axis=1)[:, :k]
        idx.sort(axis=1)  # ascending partition id → stable tie-break
        sv = np.take_along_axis(s, idx, 1)
        ord2 = np.argsort(-sv, axis=1, kind="stable")
        cand = np.take_along_axis(idx, ord2, 1)
        for i, row in enumerate(rows):
            for c in cand[i]:
                if new_counts[c] < cap:
                    break
            else:  # every candidate is full: the least-filled partition
                c = int(np.argmin(new_counts))
            assign[row] = c
            new_counts[c] += 1
    return assign


def _plan_pad_replicas(
    assign: np.ndarray,  # [N] final primary partition per row
    counts: np.ndarray,  # [P] primary fill per partition
    m: int,  # slot capacity
    choices: np.ndarray,  # [N, C] top-C centroid ids per row (col 0 nearest)
) -> tuple[np.ndarray, np.ndarray]:
    """Replicas into the layout's padding slots: first the rows the
    rebalance moved out of their nearest partition, then every other row
    into its next choice with space; one replica per row, never in its own
    partition, candidates in ascending row id per partition. Returns
    ``(rows, parts)`` sorted by ``(part, row)``."""
    n, C = choices.shape
    P = len(counts)
    free = (m - counts).astype(np.int64)
    placed = np.zeros(n, bool)
    out_r: list[np.ndarray] = []
    out_p: list[np.ndarray] = []
    scattered = choices[:, 0] != assign
    for prio_mask in (scattered, ~scattered):
        for col in range(C):
            cand = np.flatnonzero(prio_mask & ~placed)
            if not len(cand):
                break
            tgt = choices[cand, col]
            ok = tgt != assign[cand]
            cand, tgt = cand[ok], tgt[ok]
            if not len(cand):
                continue
            order = np.lexsort((cand, tgt))  # part-major, row asc
            cand, tgt = cand[order], tgt[order]
            starts = np.concatenate([[0], np.flatnonzero(np.diff(tgt)) + 1])
            reps = np.diff(np.concatenate([starts, [len(tgt)]]))
            rank = np.arange(len(tgt)) - np.repeat(starts, reps)
            take = rank < free[tgt]
            if not take.any():
                continue
            tr, tp = cand[take], tgt[take]
            free = free - np.bincount(tp, minlength=P)
            placed[tr] = True
            out_r.append(tr)
            out_p.append(tp)
    if not out_r:
        return np.empty(0, np.int64), np.empty(0, np.int32)
    rows = np.concatenate(out_r)
    parts = np.concatenate(out_p).astype(np.int32)
    order = np.lexsort((rows, parts))
    return rows[order], parts[order]


def _auto_partitions(n: int) -> int:
    """``max(sqrt(N), N/1024)`` partitions, a multiple of 8, at least 8."""
    p = max(8, int(np.sqrt(max(n, 1))), n // 1024)
    return -(-p // 8) * 8


def _fill_slots(part_rows: np.ndarray, base: np.ndarray, rows: np.ndarray, parts: np.ndarray) -> None:
    """Write ``rows`` into ``part_rows`` after ``base[p]`` slots of each
    partition, in order: the stable sort by partition gives each row the
    slot a row-by-row append would."""
    order = np.argsort(parts, kind="stable")
    rows, parts = rows[order], parts[order]
    starts = np.searchsorted(parts, parts, side="left")
    part_rows[parts, base[parts] + (np.arange(len(parts)) - starts)] = rows


#: rows normalised or quantised per host step (bounds the temporaries)
_HOST_SLAB = 1 << 18


@dataclass
class AnnStats:
    num_vectors: int = 0
    num_partitions: int = 0
    partition_capacity: int = 0
    nbytes_int8: int = 0
    nbytes_rescore: int = 0
    nbytes_total: int = 0


class PartitionedANN:
    """Partitioned cosine ANN over a frozen corpus, on ``device``."""

    def __init__(self, config: Optional[AnnConfig] = None, device: DeviceLike = None):
        self.config = config or AnnConfig()
        self.device = resolve_device(device)
        self.tuned_nprobe: int = 0
        self.centroids: Optional[torch.Tensor] = None  # [P, D] f32
        self.part_rows: Optional[torch.Tensor] = None  # [P, m] int32, -1 pad
        self.part_int8: Optional[torch.Tensor] = None  # [P, m, D] int8 (bf16 blocks when not quantised)
        self.part_scale: Optional[torch.Tensor] = None  # [P, m] f32
        self.corpus_bf16: Optional[tuple[torch.Tensor, ...]] = None
        self.num_vectors = 0
        #: some rows occupy two slots (pad replicas): serving fetches 2x
        self._replicated = False
        #: seconds of each stage of the last :meth:`build`
        self.build_seconds: dict[str, float] = {}

    # -- build ---------------------------------------------------------------

    def build(
        self,
        vectors: np.ndarray,
        seed: int = 0,
        reuse_centroids: Optional[np.ndarray] = None,
    ) -> None:
        """Freeze the index from ``[N, D]`` float vectors (normalised here).
        ``reuse_centroids`` skips k-means: the vectors are assigned to the
        given partitioning. Stage times land in :attr:`build_seconds` (the
        device is synchronised at each stage's end)."""
        if vectors.ndim != 2 or vectors.shape[0] == 0:
            raise VectorIndexConstructionFailed(f"need [N, D] vectors, got {vectors.shape}")
        n, d = vectors.shape
        cfg = self.config
        dev = self.device
        self._replicated = False
        stages: dict[str, float] = {}
        t_last = [time.perf_counter()]

        def lap(name: str) -> None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            stages[name] = now - t_last[0]
            t_last[0] = now

        v = np.asarray(vectors, np.float32)
        if not np.isfinite(v).all():
            bad = int((~np.isfinite(v)).any(axis=1).sum())
            _log.warning("%d/%d vectors contain non-finite values; zeroing them", bad, n)
            v = np.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
        vn = np.empty((n, d), np.float32)
        for lo in range(0, n, _HOST_SLAB):
            s = v[lo : lo + _HOST_SLAB]
            vn[lo : lo + _HOST_SLAB] = s / np.maximum(np.linalg.norm(s, axis=1, keepdims=True), 1e-12)
        v = vn
        lap("normalize")

        if reuse_centroids is not None:
            centroids = np.asarray(reuse_centroids, np.float32)
            P = centroids.shape[0]
        else:
            P = cfg.num_partitions or _auto_partitions(n)
            P = min(P, max(8, n))
            centroids = train_kmeans(
                v, P, iters=cfg.kmeans_iters, sample=cfg.kmeans_sample, seed=seed,
                dedup=cfg.kmeans_dedup, device=dev,
            )
        lap("kmeans")
        n_choices = max(2, cfg.replica_choices) if cfg.pad_replicas and P > 1 else 1
        if n_choices > 1:
            choices = assign_topc(v, centroids, n_choices, device=dev)
            assign = choices[:, 0].copy()
        else:
            choices = None
            assign = assign_clusters(v, centroids, device=dev)
        lap("assign")
        cap = _capacity_cap(n, P, cfg.partition_overalloc)
        assign = _rebalance_overflow(assign, cap, centroids, lambda rows: v[rows])
        lap("rebalance")

        counts = np.bincount(assign, minlength=P)
        fill_max = int(counts.max()) if counts.size else 1
        m = _aligned_capacity(fill_max, cfg.quantize_int8)
        part_rows = np.full((P, m), -1, np.int32)
        _fill_slots(part_rows, np.zeros(P, np.int64), np.arange(n, dtype=np.int32), assign)
        if choices is not None:
            rep_rows, rep_parts = _plan_pad_replicas(assign, counts, m, choices)
            _fill_slots(part_rows, counts, rep_rows.astype(np.int32), rep_parts)
            if len(rep_rows):
                _log.info(
                    "pad replicas: %d rows duplicated into free slots "
                    "(%.1f%% of %d slots were padding)",
                    len(rep_rows), 100.0 * (P * m - n) / max(P * m, 1), P * m,
                )
            self._replicated = bool(len(rep_rows))
        lap("layout")

        safe_rows = np.maximum(part_rows, 0)
        pad_mask = part_rows < 0
        if cfg.quantize_int8:
            scale = np.empty(n, np.float32)
            q = np.empty((n, d), np.int8)
            for lo in range(0, n, _HOST_SLAB):
                s = v[lo : lo + _HOST_SLAB]
                sc = np.maximum(np.max(np.abs(s), axis=1), 1e-12) / 127.0
                scale[lo : lo + _HOST_SLAB] = sc
                q[lo : lo + _HOST_SLAB] = np.clip(np.round(s / sc[:, None]), -127, 127).astype(np.int8)
            part_int8 = q[safe_rows]
            part_scale = scale[safe_rows].astype(np.float32)
            del q
        else:  # bf16 blocks with scale 1
            part_int8 = v[safe_rows].astype(np.float32)
            part_scale = np.ones((P, m), np.float32)
        part_int8[pad_mask] = 0
        part_scale[pad_mask] = 0.0

        self.centroids = torch.tensor(centroids, device=dev)
        self.part_rows = torch.as_tensor(part_rows, device=dev)
        blocks = torch.as_tensor(part_int8, device=dev)
        self.part_int8 = blocks if cfg.quantize_int8 else blocks.to(torch.bfloat16)
        self.part_scale = torch.as_tensor(part_scale, device=dev)
        del part_int8, blocks
        self.corpus_bf16 = split_rescore_corpus(
            v, to_device=lambda seg: torch.as_tensor(seg, device=dev).to(torch.bfloat16)
        )
        self.num_vectors = n
        lap("quantize_upload")
        self.build_seconds = stages

    # -- loading -------------------------------------------------------------

    @classmethod
    def load(
        cls, path: str | Path, config: Optional[AnnConfig] = None,
        device: DeviceLike = None,
    ) -> "PartitionedANN":
        """Load the ``.npz`` artifact (``PartitionedANN.save``)."""
        idx = cls(config, device)
        dev = idx.device
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
                idx.centroids = to_device(z["centroids"].astype(np.float32), dev)
                idx.part_rows = to_device(z["part_rows"].astype(np.int32), dev)
                blocks = z["part_int8"]
                if meta.get("int8_blocks", True):
                    idx.part_int8 = to_device(blocks.astype(np.int8), dev)
                else:  # bf16 blocks stored as f16
                    idx.part_int8 = to_device(blocks, dev).to(torch.bfloat16)
                idx.part_scale = to_device(z["part_scale"].astype(np.float32), dev)
                n_segs = int(meta.get("rescore_segments", 0))
                if n_segs:
                    idx.corpus_bf16 = tuple(
                        to_device(z[f"corpus_f16_{i}"], dev).to(torch.bfloat16)
                        for i in range(n_segs)
                    )
                else:  # legacy single member
                    idx.corpus_bf16 = split_rescore_corpus(
                        z["corpus_f16"],
                        to_device=lambda s: to_device(s, dev).to(torch.bfloat16),
                    )
                idx._adopt_meta(meta)
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            raise IndexCorrupted(index_type="ann", details=str(e)) from e
        return idx

    @classmethod
    def load_dir(
        cls, path: str | Path, config: Optional[AnnConfig] = None,
        device: DeviceLike = None,
    ) -> "PartitionedANN":
        """Load the raw-``.npy`` directory artifact (``save_dir``): arrays
        are memmapped and copied to the device slab by slab."""
        idx = cls(config, device)
        dev = idx.device
        path = Path(path)
        try:
            meta = json.loads((path / "meta.json").read_text())
            mm = lambda n: np.load(path / n, mmap_mode="r")  # noqa: E731
            idx.centroids = to_device(np.asarray(mm("centroids.npy"), np.float32), dev)
            idx.part_rows = to_device(mm("part_rows.npy"), dev)
            int8_blocks = meta.get("int8_blocks", True)
            idx.part_int8 = to_device(mm("part_int8.npy"), dev, bf16_bits=not int8_blocks)
            idx.part_scale = to_device(mm("part_scale.npy"), dev)
            idx.corpus_bf16 = tuple(
                to_device(mm(f"rescore_{i}.npy"), dev, bf16_bits=True)
                for i in range(int(meta.get("rescore_segments", 0)))
            )
            idx._adopt_meta(meta)
        except (KeyError, ValueError, OSError, json.JSONDecodeError) as e:
            raise IndexCorrupted(index_type="ann", details=str(e)) from e
        return idx

    def _adopt_meta(self, meta: dict) -> None:
        self.num_vectors = int(meta["num_vectors"])
        self._replicated = bool(meta.get("replicated", False))
        if not self.config.num_probes:
            self.tuned_nprobe = int(meta.get("num_probes", 0))

    def _require_built(self) -> None:
        if self.centroids is None:
            raise VectorIndexConstructionFailed("index not built/loaded")

    @property
    def default_nprobe(self) -> int:
        P = int(self.centroids.shape[0]) if self.centroids is not None else 8
        if self.tuned_nprobe:
            return min(self.tuned_nprobe, P)
        if self.config.num_probes:
            return min(self.config.num_probes, P)
        return min(max(8, P // 10, self.config.ef_search // 4), P)

    # -- search ----------------------------------------------------------------

    def search(
        self, queries, k: int, nprobe: Optional[int] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k ``(scores, rows)`` per query through the probe → int8 scan
        → bf16 rescore stages; rows -1 when fewer than k exist."""
        self._require_built()
        nprobe = nprobe or self.default_nprobe
        P, m = (int(s) for s in self.part_rows.shape)
        if nprobe * m >= self.num_vectors or nprobe >= P:
            return self.search_brute(queries, k)
        exact_float32()
        cfg = self.config
        rescore_k = min(
            k * max(1, cfg.rescore_factor) * (2 if self._replicated else 1),
            self.num_vectors,
        )
        quantize = bool(cfg.quantize_int8)
        D = int(self.part_int8.shape[-1])
        forced = os.environ.get("TSS_PROBE_INTERPRET") == "1"
        use_kernel = quantize and m % 128 == 0 and (D % 128 == 0 or forced)

        dev = self.device
        qn = l2_normalize(torch.as_tensor(np.asarray(queries), device=dev).to(torch.float32))
        B = qn.shape[0]
        cs = qn @ self.centroids.T
        _, top_p = exact_topk(cs, nprobe)
        q_abs = qn.abs().amax(dim=-1, keepdim=True)
        q_scale = torch.clamp(q_abs, min=1e-12) / 127.0
        q8 = torch.clamp(torch.round(qn / q_scale), -127, 127).to(torch.int8)
        rows_all = self.part_rows
        if use_kernel and B * nprobe * 4 <= 768 * 1024:
            i32 = torch.int32
            pcw = torch.where(rows_all >= 0, 0, -1).to(i32)
            kc_v, kc_s = probe_candidates(
                q8, q_scale, top_p, self.part_int8, self.part_scale, rows_all,
                pcw, torch.ones_like(pcw), torch.zeros_like(pcw),
                torch.ones((B, 1), dtype=i32, device=dev),
                torch.full((B,), -(2**31), dtype=i32, device=dev),
                torch.full((B,), 2**31 - 1, dtype=i32, device=dev),
                torch.full((B,), -float("inf"), device=dev),
            )
            rows3 = rows_all[top_p[:, :, None], kc_s.reshape(B, nprobe, -1).long()]
            flat_scores, flat_rows = kc_v, rows3.reshape(B, -1)
        else:
            scores = []
            for p in range(nprobe):
                col = top_p[:, p]
                blocks = self.part_int8[col].to(torch.float32)  # [B, m, D]
                if quantize:
                    acc = torch.einsum("bd,bmd->bm", q8.to(torch.float32), blocks)
                    scores.append(acc * self.part_scale[col] * q_scale)
                else:
                    qb = qn.to(torch.bfloat16).to(torch.float32)
                    scores.append(torch.einsum("bd,bmd->bm", qb, blocks) * self.part_scale[col])
            flat_scores = torch.stack(scores, dim=1).reshape(B, -1)
            flat_rows = rows_all[top_p].reshape(B, -1)
        flat_scores = torch.where(
            flat_rows >= 0, flat_scores, torch.full_like(flat_scores, -float("inf"))
        )
        cand_n = min(rescore_k, flat_scores.shape[-1])
        cand_v, cand_rows = topk_by_score_then_row(flat_scores, flat_rows, cand_n)
        # pad replicas: a row probed through both its partitions appears
        # twice with the same score, adjacent after the (score, row) sort
        dup = torch.cat([
            torch.zeros_like(cand_rows[:, :1], dtype=torch.bool),
            (cand_rows[:, 1:] == cand_rows[:, :-1]) & (cand_rows[:, 1:] >= 0),
        ], dim=1)
        cand_v = torch.where(dup, torch.full_like(cand_v, -float("inf")), cand_v)
        safe = torch.clamp(cand_rows, min=0)
        if use_kernel:
            re = gather_rescore_rows(qn, self.corpus_bf16, safe)
        else:
            re = gather_rescore(qn, self.corpus_bf16, safe)
        re = torch.where(torch.isfinite(cand_v), re, torch.full_like(re, -float("inf")))
        v, idx = topk_by_score_then_row(re, cand_rows, min(k, cand_n))
        idx = torch.where(torch.isneginf(v), torch.full_like(idx, -1), idx)
        return v.cpu().numpy(), idx.cpu().numpy()

    def search_brute(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact full scan of the bf16 corpus (the recall oracle): segment by
        segment, in row slabs, with a running exact top-k."""
        self._require_built()
        exact_float32()
        dev = self.device
        kk = min(k, self.num_vectors)
        qn = l2_normalize(torch.as_tensor(np.asarray(queries), device=dev).to(torch.float32))
        qb = qn.to(torch.bfloat16).to(torch.float32)
        B = qb.shape[0]
        best_v = torch.full((B, kk), -float("inf"), device=dev)
        best_i = torch.full((B, kk), -1, dtype=torch.int64, device=dev)
        base = 0
        for seg in self.corpus_bf16:
            for lo in range(0, seg.shape[0], _COPY_ROWS):
                rows = seg[lo : lo + _COPY_ROWS]
                scores = qb @ rows.to(torch.float32).T
                gid = torch.arange(rows.shape[0], device=dev) + base + lo
                scores = torch.where(
                    (gid < self.num_vectors)[None, :], scores,
                    torch.full_like(scores, -float("inf")),
                )
                v, i = exact_topk(scores, min(kk, rows.shape[0]))
                i = i + base + lo
                if v.shape[1] < kk:
                    pad = kk - v.shape[1]
                    v = torch.cat([v, torch.full((B, pad), -float("inf"), device=dev)], 1)
                    i = torch.cat([i, torch.full((B, pad), -1, dtype=i.dtype, device=dev)], 1)
                best_v, best_i = merge_topk(
                    torch.stack([best_v, v], 1), torch.stack([best_i, i], 1), kk
                )
            base += seg.shape[0]
        return best_v.cpu().numpy(), best_i.to(torch.int32).cpu().numpy()

    def tune_nprobe(
        self, sample_queries: np.ndarray, k: int = 10, target_recall: float = 0.95,
    ) -> int:
        """The smallest ``nprobe`` (power-of-two sweep, then one midpoint)
        whose tie-aware recall@k against :meth:`search_brute` reaches
        ``target_recall`` on ``sample_queries``: a hit is any result scoring
        at least the exact scan's k-th score minus 1e-5. Kept as the
        instance's :attr:`tuned_nprobe`."""
        self._require_built()
        ov, _ = self.search_brute(sample_queries, k)
        thresh = np.asarray(ov)[:, k - 1 : k] - 1e-5

        def recall_at(nprobe: int) -> float:
            gv, _ = self.search(sample_queries, k, nprobe=nprobe)
            return float(np.mean(np.asarray(gv) >= thresh))

        P = int(self.centroids.shape[0])
        start = max(1, self.default_nprobe // 2)
        n = 1 << (start - 1).bit_length()  # next power of two >= start
        if recall_at(n) >= target_recall:
            hi = n
            while hi > 1:  # descend while the target still holds
                half = hi // 2
                if recall_at(half) < target_recall:
                    break
                hi = half
        else:
            lo = n
            while True:
                n *= 2
                if n >= P:
                    hi = P
                    break
                if recall_at(n) >= target_recall:
                    hi = n
                    break
                lo = n
            if hi < P and hi - lo > 1:  # one midpoint refine
                mid = (lo + hi) // 2
                if recall_at(mid) >= target_recall:
                    hi = mid
        self.tuned_nprobe = hi
        return hi

    def _meta(self) -> dict:
        return {
            "num_vectors": self.num_vectors,
            "int8_blocks": self.part_int8.dtype == torch.int8,
            "rescore_segments": len(self.corpus_bf16),
            "num_probes": int(self.tuned_nprobe or self.config.num_probes),
            "replicated": bool(self._replicated),
        }

    def save(self, path: str | Path) -> None:
        """Persist as an ``np.load``-compatible npz zip: bf16 blocks and
        rescore segments as f16, one rescore segment per member, written
        one at a time."""
        self._require_built()
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = self._meta()
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, allowZip64=True) as zf:
            def put(name: str, arr: np.ndarray) -> None:
                with zf.open(name + ".npy", "w", force_zip64=True) as f:
                    npformat.write_array(f, np.asanyarray(arr), allow_pickle=False)

            put("centroids", self.centroids.cpu().numpy())
            put("part_rows", self.part_rows.cpu().numpy())
            if meta["int8_blocks"]:
                put("part_int8", self.part_int8.cpu().numpy())
            else:
                put("part_int8", self.part_int8.float().cpu().numpy().astype(np.float16))
            put("part_scale", self.part_scale.cpu().numpy())
            put("meta", np.array(json.dumps(meta)))
            for i, s in enumerate(self.corpus_bf16):
                put(f"corpus_f16_{i}", s.float().cpu().numpy().astype(np.float16))

    def save_dir(self, path: str | Path) -> None:
        """Persist as a directory of raw ``.npy`` files plus ``meta.json``
        (bf16 arrays as uint16 bit views), written to ``<path>.tmp`` and
        renamed over ``path``."""
        self._require_built()
        path = Path(path)
        tmp = path.with_name(path.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = self._meta()
        bf16_bits = lambda t: t.view(torch.int16).cpu().numpy().view(np.uint16)  # noqa: E731
        np.save(tmp / "part_int8.npy",
                self.part_int8.cpu().numpy() if meta["int8_blocks"] else bf16_bits(self.part_int8))
        np.save(tmp / "centroids.npy", self.centroids.cpu().numpy())
        np.save(tmp / "part_rows.npy", self.part_rows.cpu().numpy())
        np.save(tmp / "part_scale.npy", self.part_scale.cpu().numpy())
        for i, s in enumerate(self.corpus_bf16):
            np.save(tmp / f"rescore_{i}.npy", bf16_bits(s))
        (tmp / "meta.json").write_text(json.dumps(meta))
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)

    def get_stats(self) -> AnnStats:
        if self.centroids is None:
            return AnnStats()
        int8_b = self.part_int8.numel() * self.part_int8.element_size() + 4 * self.part_scale.numel()
        res_b = 2 * sum(s.numel() for s in self.corpus_bf16)
        total = int8_b + res_b + 4 * self.part_rows.numel() + 4 * self.centroids.numel()
        return AnnStats(
            num_vectors=self.num_vectors,
            num_partitions=int(self.centroids.shape[0]),
            partition_capacity=int(self.part_rows.shape[1]),
            nbytes_int8=int8_b,
            nbytes_rescore=res_b,
            nbytes_total=total,
        )
