"""Fused hybrid search: one device step per query batch.

Port of ``trie_semantic_search_tpu/search/fused.py`` for one device. It
binds the frozen artifacts (chunk embeddings or partition blocks, metadata
columns, chunk→case map, trie) to the steps of :mod:`..ops.hybrid`:

  * ``brute``: int8 scan over an int8 copy of the whole corpus (below
    ``PARTITIONED_MIN_VECTORS`` chunks in ``auto`` mode);
  * ``partitioned``: per batch, the probe (:func:`fused_partitioned_topk`)
    for small batches and the stream (:func:`fused_layout_brute_topk`) once
    ``B·nprobe >= P·ceil(B/TILE_B)``, with flat-boundary escalation of
    probe results through the stream.

With a ``mesh`` whose data axis is > 1 the corpus is sharded row-wise over
the mesh's devices and the modes are

  * ``sharded``: each shard's int8 scan (the fused-scan kernel at
    ``recall_target < 1``) through :func:`..parallel.collectives.
    sharded_fused_topk`;
  * ``sharded-partitioned``: per-shard partition blocks against shared
    global centroids (:func:`..index.sharded.build_sharded_partitions`),
    the probe through :func:`..parallel.collectives.sharded_partitioned_topk`
    and, past the same break-even, the stream through
    :func:`..parallel.collectives.sharded_layout_brute_topk`;

the shard-local lists merge on the mesh's first device. On a mesh across
processes (:func:`..parallel.mesh.make_distributed_mesh`) every process
builds from the same host rows, keeps its own shards' blocks, and merges
the all-gathered lists, so each returns the same answers.

Every threshold keeps its JAX value (``PARTITIONED_MIN_VECTORS``, the
break-even rule, ``TILE_B``, ``ESCALATE_BUCKET``, ``pick_num_chunks``), so
both packages pick the same stage for the same batch.
"""

from __future__ import annotations

import datetime as _dt
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.metrics import metrics
from ..index.ann import PartitionedANN, _auto_partitions
from ..index.kmeans import train_kmeans
from ..index.sharded import build_sharded_partitions, slot_court_ids
from ..index.trie import TrieIndex
from ..index.vector import VectorIndex, _mesh_data_size
from ..ops.hybrid import (
    SRC_CASE_NAME,
    SRC_CITATION,
    SRC_CONTENT,
    fused_hybrid_topk,
    fused_hybrid_topk_chunked,
    fused_layout_brute_topk,
    fused_partitioned_topk,
    pick_num_chunks,
    resolve_probe_kernel,
)
from ..ops.scan_kernels import TILE_B, TILE_N, pad_align_for
from ..ops.scoring import quantize_int8
from ..parallel.collectives import (
    resolve_scan_kernel,
    sharded_fused_topk,
    sharded_layout_brute_topk,
    sharded_partitioned_topk,
)
from ..parallel.mesh import DATA_AXIS, pad_corpus, shard_block, shard_leading, shard_rows
from ..storage.columns import MetadataColumns
from ..utils import batch_bucket

#: corpus size above which ``auto`` serves the partitioned modes
PARTITIONED_MIN_VECTORS = 50_000

#: batch size of flat-boundary escalation re-dispatches through the stream
ESCALATE_BUCKET = 8


def _host(out: tuple) -> tuple[np.ndarray, ...]:
    return tuple(t.cpu().numpy() for t in out)


class FusedHybridSearch:
    """Device-resident state for the fused hybrid query step (on the
    vector index's device)."""

    def __init__(
        self,
        trie_index: TrieIndex,
        vector_index: VectorIndex,
        columns: MetadataColumns,
        ann_mode: str = "auto",  # "auto" | "brute" | "partitioned"
        mesh=None,  # parallel.mesh.Mesh; data axis > 1 → the sharded modes
        flat_escalate_eps: float = 0.0,  # 0 disables escalation
    ):
        if vector_index.vectors is None or not len(vector_index.vectors):
            raise ValueError("vector index has no frozen vectors")
        self.trie_index = trie_index
        self.vector_index = vector_index
        self.columns = columns
        self.mesh = None
        self.device = dev = vector_index.device
        self.num_vectors = len(vector_index.vectors)
        self.flat_escalate_eps = float(flat_escalate_eps)
        #: total queries escalated (under a lock: the server runs batches
        #: from two threads)
        self.escalated = 0
        self._escalated_lock = threading.Lock()

        t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
        refs = np.asarray(vector_index.refs, np.int32)
        chunk_case = refs[:, 0]
        #: paragraph of each chunk (host): the engine anchors snippets on it
        self.chunk_para = refs[:, 1]
        # representative chunk per case: the FIRST chunk in ref order
        rep = np.full(len(columns), -1, np.int32)
        rep[chunk_case[::-1]] = np.arange(len(chunk_case) - 1, -1, -1, dtype=np.int32)
        self._rep_np = rep
        self.num_courts = max(len(columns.court_vocab), 1)

        if mesh is not None and _mesh_data_size(mesh) > 1:
            self._init_sharded(mesh, chunk_case, ann_mode)
            return
        self.trie_chunk_of_case = t(rep)
        ann = vector_index.ann
        if ann_mode == "auto":
            ann_mode = (
                "partitioned"
                if isinstance(ann, PartitionedANN)
                and ann.num_vectors >= PARTITIONED_MIN_VECTORS
                else "brute"
            )
        if ann_mode == "partitioned" and not isinstance(ann, PartitionedANN):
            raise ValueError(f"partitioned fused mode needs a PartitionedANN, got {type(ann)}")
        self.ann_mode = ann_mode
        if ann_mode == "partitioned":
            ann._require_built()
            ann._ensure_device()  # a streamed index's arrays may still be on the host
            self.ann = ann
            self.corpus_q = self.corpus_scale = None
            from ..ops.scan_kernels import partition_filter_columns

            rows_np = ann.part_rows.cpu().numpy()
            self._part_cols = tuple(t(a) for a in partition_filter_columns(
                rows_np, columns.court_ids[chunk_case], columns.dates[chunk_case]
            ))
            # raw slot court ids for the stream (pad slots -1)
            safe_slot = np.maximum(rows_np, 0)
            self._slot_court = t(np.where(
                rows_np >= 0,
                columns.court_ids[chunk_case[safe_slot]].astype(np.int32), -1,
            ))
        else:
            self.ann = None
            v = self._norm_corpus()
            n = v.shape[0]
            align = pad_align_for(n)
            npad = -(-n // align) * align
            if npad != n:
                v = np.concatenate([v, np.zeros((npad - n, v.shape[1]), v.dtype)])
                chunk_case = np.concatenate([chunk_case, np.full(npad - n, -1, np.int32)])
            self.corpus_q, self.corpus_scale = quantize_int8(t(v))
            if npad != n:
                self.corpus_scale[n:] = 0.0
        safe_case = np.maximum(chunk_case, 0)
        pad_row = chunk_case < 0
        court_col = columns.court_ids[safe_case].copy()
        date_col = columns.dates[safe_case].copy()
        if pad_row.any():
            court_col[pad_row] = 0
            date_col[pad_row] = np.iinfo(np.int32).min
        self.chunk_case = t(chunk_case.astype(np.int32))
        self.chunk_court = t(court_col.astype(np.int32))
        self.chunk_date = t(date_col.astype(np.int32))

    def _norm_corpus(self) -> np.ndarray:
        """The vector store as f32, L2-normalised (an O(corpus) host copy,
        made only where a mode needs the raw rows)."""
        v = np.asarray(self.vector_index.vectors, np.float32)
        return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)

    def _init_sharded(self, mesh, chunk_case: np.ndarray, ann_mode: str = "auto") -> None:
        """Lay the corpus and the chunk columns out row-sharded over the
        mesh's data axis, padded to a per-shard ``TILE_N`` multiple so that
        the fused-scan kernel applies on every shard. ``auto`` picks the
        sharded-partitioned mode from ``PARTITIONED_MIN_VECTORS`` chunks,
        the sharded brute scan below."""
        self.mesh = mesh
        self.device = dev = mesh.first_device
        self.ann = None
        if ann_mode == "auto":
            ann_mode = "partitioned" if self.num_vectors >= PARTITIONED_MIN_VECTORS else "brute"
        self.ann_mode = "sharded-partitioned" if ann_mode == "partitioned" else "sharded"
        padded, n = pad_corpus(self._norm_corpus(), mesh, TILE_N)
        S = int(mesh.shape[DATA_AXIS])
        shard_n = padded.shape[0] // S

        def pad_col(col: np.ndarray, fill: int) -> np.ndarray:
            out = np.full(padded.shape[0], fill, np.int32)
            out[:n] = col
            return out

        court_col = pad_col(self.columns.court_ids[chunk_case], 0)
        date_col = pad_col(self.columns.dates[chunk_case], np.iinfo(np.int32).min)
        self.chunk_case = shard_rows(pad_col(chunk_case, -1), mesh)
        self.chunk_court = shard_rows(court_col, mesh)
        self.chunk_date = shard_rows(date_col, mesh)
        # case-level columns for the lexical filter check, on the merge device
        self.case_court = torch.tensor(np.asarray(self.columns.court_ids, np.int32), device=dev)
        self.case_date = torch.tensor(np.asarray(self.columns.dates, np.int32), device=dev)

        if self.ann_mode == "sharded":
            self.corpus_q, self.corpus_scale = [None] * S, [None] * S
            for s in mesh.local_data_rows:
                q, scale = quantize_int8(shard_block(padded, mesh, s))
                scale[max(0, n - s * shard_n):] = 0.0  # pad rows score 0 (n_valid masks them too)
                self.corpus_q[s], self.corpus_scale[s] = q, scale
            return

        # per-shard partition blocks against global centroids (the ANN's,
        # when the vector index holds a built PartitionedANN)
        self.corpus_q = self.corpus_scale = None
        acfg = self.vector_index.config.hnsw
        ann = self.vector_index.ann
        if isinstance(ann, PartitionedANN) and ann.centroids is not None:
            cent = ann.centroids
            centroids = np.asarray(cent.cpu() if isinstance(cent, torch.Tensor) else cent, np.float32)
        else:
            P = acfg.num_partitions or _auto_partitions(n)
            P = min(P, max(8, n))
            centroids = train_kmeans(padded[:n], P, iters=acfg.kmeans_iters,
                                     sample=acfg.kmeans_sample, seed=0, device=dev)
        parts = build_sharded_partitions(padded, n, S, centroids, court_col, date_col,
                                         overalloc=acfg.partition_overalloc, device=dev)
        self.sp_centroids = torch.tensor(centroids, dtype=torch.float32, device=dev)
        self.sp_rows = shard_leading(parts["part_rows"], mesh)
        self.sp_int8 = shard_leading(parts.pop("part_int8"), mesh)
        self.sp_scale = shard_leading(parts["part_scale"], mesh)
        self.sp_cword = shard_leading(parts["part_cword"], mesh)
        self.sp_cbit = shard_leading(parts["part_cbit"].view(np.int32), mesh)
        self.sp_date = shard_leading(parts["part_date"], mesh)
        # raw slot court ids for the stream's court-table lookup
        self.sp_court = shard_leading(
            slot_court_ids(parts["part_rows"], parts["part_cword"], parts["part_cbit"]), mesh)
        self.sp_bf16 = shard_rows(padded, mesh, torch.bfloat16)
        self.sp_m = int(parts["m"])
        self.sp_dim = int(padded.shape[1])
        #: seconds of the per-shard layout build by stage
        self.sp_build_seconds = dict(parts["seconds"])
        P = centroids.shape[0]
        # the artifact's tuned nprobe wins, then the user config (the
        # precedence of PartitionedANN.default_nprobe)
        nprobe_cfg = getattr(ann, "tuned_nprobe", 0) or acfg.num_probes
        if nprobe_cfg:
            self.sp_nprobe = min(nprobe_cfg, P)
        else:
            self.sp_nprobe = min(max(8, P // 10, acfg.ef_search // 4), P)
        self.sp_rescore = max(1, acfg.rescore_factor)

    def _layout_brute_batch(self, batch: int) -> bool:
        """Stream the batch when the probe would read at least as many rows:
        ``B·nprobe >= P·ceil(B/TILE_B)`` (the JAX package's break-even; per
        shard in the sharded-partitioned mode, where both sides divide by
        the shard count)."""
        if self.ann is not None:
            P = int(self.ann.centroids.shape[0])
            nprobe = int(self.ann.default_nprobe)
        elif self.ann_mode == "sharded-partitioned":
            P = int(self.sp_centroids.shape[0])
            nprobe = int(self.sp_nprobe)
        else:
            return False
        return batch * nprobe >= P * (-(-batch // TILE_B))

    def _sharded_shared(self, court_table, lo, hi, trie_rows, trie_src, min_sim, exact_w) -> tuple:
        """The replicated arguments of the sharded steps, on the merge
        device; lexical hits whose case has no chunk are dropped."""
        t = lambda a: torch.tensor(np.asarray(a), device=self.device)  # noqa: E731
        lex_chunk = self._rep_np[np.maximum(trie_rows, 0)]
        trie_rows = np.where(lex_chunk >= 0, trie_rows, -1)
        return (
            t(court_table), t(lo), t(hi), t(trie_rows), t(np.ascontiguousarray(trie_src)),
            t(np.maximum(lex_chunk, 0)), self.case_court, self.case_date,
            t(np.asarray(min_sim, np.float32)), t(np.asarray(exact_w, np.float32)),
        )

    def _dispatch_stream(
        self, q_np, court_table, lo, hi, trie_rows, trie_src, min_sim, exact_w,
        use_filters: bool, k: int, overfetch: int, recall_target: float,
    ) -> tuple[np.ndarray, ...]:
        """One stream of the partition layout over an already padded host
        batch (large-batch pick and escalation share it)."""
        dev = self.device
        t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
        if self.ann_mode == "sharded-partitioned":
            upk, _ = resolve_probe_kernel(recall_target, self.sp_m, self.sp_dim)
            out = sharded_layout_brute_topk(
                self.mesh, t(np.asarray(q_np, np.float32)), self.sp_rows, self.sp_int8,
                self.sp_scale, self.sp_court, self.sp_date, self.sp_bf16, self.chunk_case,
                *self._sharded_shared(court_table, lo, hi, trie_rows, trie_src, min_sim, exact_w),
                k=k, overfetch=overfetch * 2,  # replica and overalloc slot headroom
                recall_target=recall_target, use_court=use_filters, use_date=use_filters,
                use_gather_kernel=upk,
            )
            return _host(out)
        upk, _ = resolve_probe_kernel(
            recall_target, int(self.ann.part_rows.shape[1]),
            int(self.ann.part_int8.shape[-1]),
        )
        _, _, pdt = self._part_cols
        of = overfetch * (2 if self.ann._replicated else 1)
        P, m = self.ann.part_rows.shape
        out = fused_layout_brute_topk(
            t(np.asarray(q_np, np.float32)), self.ann.part_rows,
            self.ann.part_int8, self.ann.part_scale, self.ann.corpus_bf16,
            self._slot_court, pdt, self.chunk_case, self.chunk_court,
            self.chunk_date, t(court_table), t(lo), t(hi), t(trie_rows),
            t(trie_src), self.trie_chunk_of_case, t(min_sim), t(exact_w),
            k=k, overfetch=of,
            num_chunks=pick_num_chunks(int(P) * int(m), int(q_np.shape[0]), k * max(1, of)),
            recall_target=recall_target, use_court=use_filters,
            use_date=use_filters, use_gather_kernel=upk,
        )
        return _host(out)

    def _stream_subset(
        self, hostq: dict, sel: np.ndarray, use_filters: bool, k: int,
        overfetch: int, recall_target: float,
    ) -> tuple[np.ndarray, ...]:
        """Stream the ``sel`` rows of a padded host batch, padded to
        ``ESCALATE_BUCKET`` with inert rows."""
        n, Bp = int(sel.size), ESCALATE_BUCKET

        def pad(a: np.ndarray, fill) -> np.ndarray:
            out = np.full((Bp,) + a.shape[1:], fill, a.dtype)
            out[:n] = a[sel]
            return out

        return self._dispatch_stream(
            pad(hostq["q"], 0), pad(hostq["court_table"], True),
            pad(hostq["lo"], np.iinfo(np.int32).min),
            pad(hostq["hi"], np.iinfo(np.int32).max),
            pad(hostq["trie_rows"], -1), pad(hostq["trie_src"], SRC_CASE_NAME),
            pad(hostq["min_sim"], np.float32(np.inf)),
            pad(hostq["exact_w"], np.float32(0.0)),
            use_filters, k, overfetch, recall_target,
        )

    def _escalate_flat(
        self, hostq: dict, use_filters: bool, k: int, overfetch: int,
        recall_target: float, v, i, cases, src, B0: int,
    ) -> tuple[np.ndarray, ...]:
        """Re-run probe results whose full top-k boundary is flat (spread
        ``<= eps·|top1| + 1e-6``) through the stream and splice them back."""
        eps = self.flat_escalate_eps
        if eps <= 0.0 or k < 2:
            return v, i, cases, src
        vv, cc = v[:B0], cases[:B0]
        full = (np.isfinite(vv) & (cc >= 0)).all(axis=1)
        with np.errstate(invalid="ignore"):
            spread = vv[:, 0] - vv[:, -1]
            flagged = np.nonzero(full & (spread <= eps * np.abs(vv[:, 0]) + 1e-6))[0]
        if flagged.size == 0:
            return v, i, cases, src
        with self._escalated_lock:
            self.escalated += int(flagged.size)
        out = tuple(np.array(a) for a in (v, i, cases, src))
        for g0 in range(0, int(flagged.size), ESCALATE_BUCKET):
            sel = flagged[g0 : g0 + ESCALATE_BUCKET]
            sub = self._stream_subset(hostq, sel, use_filters, k, overfetch, recall_target)
            for dst, s in zip(out, sub):
                dst[sel] = s[: sel.size]
        return out

    def warm_escalation(self, k: int, overfetch: int, recall_target: float) -> None:
        """Run the two escalation streams (unfiltered and filtered, at
        ``ESCALATE_BUCKET``) once with an inert query, as the JAX package's
        warmup does to compile them; a no-op without escalation or outside
        the partitioned mode."""
        if self.flat_escalate_eps <= 0.0 or self.ann_mode not in (
            "partitioned", "sharded-partitioned",
        ):
            return
        if self.ann_mode == "partitioned":
            D = int(self.ann.part_int8.shape[-1])
        else:
            D = self.sp_dim
        W = self.trie_index.search_batch_rows(["__warmup__"])[0].shape[1]
        hostq = dict(
            q=np.zeros((1, D), np.float32),
            court_table=np.ones((1, self.num_courts), bool),
            lo=np.full(1, np.iinfo(np.int32).min, np.int32),
            hi=np.full(1, np.iinfo(np.int32).max, np.int32),
            trie_rows=np.full((1, W), -1, np.int32),
            trie_src=np.ascontiguousarray(self._trie_src(W)[None, :]),
            min_sim=np.full(1, np.inf, np.float32),
            exact_w=np.zeros(1, np.float32),
        )
        for filtered in (False, True):
            self._stream_subset(hostq, np.array([0]), filtered, k, overfetch, recall_target)

    @staticmethod
    def _trie_src(width: int) -> np.ndarray:
        """Column → SRC_* code of ``search_batch_rows`` output (three equal
        spans: name | citation | content)."""
        span = max(width // 3, 1)
        codes = (SRC_CASE_NAME, SRC_CITATION, SRC_CONTENT)
        return np.asarray([codes[min(c // span, 2)] for c in range(width)], np.int32)

    def query_batch(
        self,
        query_embs: np.ndarray,  # [B, D]
        queries_text: Sequence[str],
        court_filters: Sequence[Optional[Sequence[str]]],
        date_ranges: Sequence[Optional[tuple[Optional[_dt.date], Optional[_dt.date]]]],
        min_similarity: Sequence[float],
        exact_weight: Sequence[float],
        k: int = 40,
        overfetch: int = 4,
        recall_target: float = 1.0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Run the fused step → ``(scores, chunk_idx, case_rows, src)`` each
        ``[B, k]`` (-inf/-1 padded): k distinct cases per query, filtered
        and boosted, with MatchType provenance. The batch pads to the
        serving ladder with inert queries (+inf threshold, no hits).

        Unsharded, it spans ``step.trie_walk``, ``step.inputs`` (padding,
        the court table, the date codes, the host→device tensors),
        ``step.run`` (the stage's call until its results are on the host)
        and, after the probe, ``step.escalate``."""
        B0 = B = len(queries_text)
        Bp = batch_bucket(B)
        with metrics.leaf("step.trie_walk"):
            trie_rows, trie_valid = self.trie_index.search_batch_rows(list(queries_text))
            trie_rows = np.where(trie_valid, trie_rows, -1).astype(np.int32)
        sharded = self.ann_mode in ("sharded", "sharded-partitioned")
        with metrics.leaf("step.inputs"):
            if Bp != B:
                pad = Bp - B
                query_embs = np.concatenate(
                    [query_embs, np.zeros((pad, query_embs.shape[1]), query_embs.dtype)]
                )
                trie_rows = np.concatenate(
                    [trie_rows, np.full((pad, trie_rows.shape[1]), -1, np.int32)]
                )
                court_filters = list(court_filters) + [None] * pad
                date_ranges = list(date_ranges) + [None] * pad
                min_similarity = list(min_similarity) + [np.float32(np.inf)] * pad
                exact_weight = list(exact_weight) + [0.0] * pad
                B = Bp
            trie_src = np.ascontiguousarray(
                np.broadcast_to(self._trie_src(trie_rows.shape[1]), trie_rows.shape)
            )
            V = self.num_courts
            court_table = np.ones((B, V), bool)
            for b, courts in enumerate(court_filters):
                if courts:
                    allowed = {self.columns.court_vocab.get(c.strip(), -1) for c in courts}
                    court_table[b] = False
                    for cid in allowed:
                        if 0 <= cid < V:
                            court_table[b, cid] = True
            lo = np.empty(B, np.int32)
            hi = np.empty(B, np.int32)
            for b, dr in enumerate(date_ranges):
                lo[b], hi[b] = self.columns.encode_date_range(dr)
            use_filters = any(bool(c) for c in court_filters) or any(bool(dr) for dr in date_ranges)
            hostq = dict(
                q=np.asarray(query_embs, np.float32), court_table=court_table,
                lo=lo, hi=hi, trie_rows=trie_rows, trie_src=trie_src,
                min_sim=np.asarray(min_similarity, np.float32),
                exact_w=np.asarray(exact_weight, np.float32),
            )
            if not sharded:
                dev = self.device
                t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
                common = dict(
                    court_table=t(court_table), date_lo=t(lo), date_hi=t(hi),
                    trie_rows=t(trie_rows), trie_src=t(trie_src),
                    trie_chunk_of_case=self.trie_chunk_of_case,
                    min_similarity=t(hostq["min_sim"]), exact_weight=t(hostq["exact_w"]),
                    k=k, overfetch=overfetch,
                )
                q = t(hostq["q"])
        if sharded:
            return self._query_sharded(hostq, use_filters, k, overfetch, recall_target, B, B0)
        if self.ann_mode == "partitioned":
            if self._layout_brute_batch(B):
                with metrics.leaf("step.run"):
                    v, i, cases, src = self._dispatch_stream(
                        hostq["q"], court_table, lo, hi, trie_rows, trie_src,
                        hostq["min_sim"], hostq["exact_w"], use_filters, k,
                        overfetch, recall_target,
                    )
                return v[:B0], i[:B0], cases[:B0], src[:B0]
            with metrics.leaf("step.run"):
                pcw, pcb, pdt = self._part_cols
                upk, _ = resolve_probe_kernel(
                    recall_target, int(self.ann.part_rows.shape[1]),
                    int(self.ann.part_int8.shape[-1]),
                )
                out = _host(fused_partitioned_topk(
                    q, self.ann.centroids, self.ann.part_rows, self.ann.part_int8,
                    self.ann.part_scale, self.ann.corpus_bf16, self.chunk_case,
                    self.chunk_court, self.chunk_date,
                    nprobe=self.ann.default_nprobe,
                    rescore_factor=max(1, self.ann.config.rescore_factor),
                    recall_target=recall_target, part_cword=pcw, part_cbit=pcb,
                    part_date=pdt, use_probe_kernel=upk, **common,
                ))
            with metrics.leaf("step.escalate"):
                v, i, cases, src = self._escalate_flat(
                    hostq, use_filters, k, overfetch, recall_target, *out, B0,
                )
            return v[:B0], i[:B0], cases[:B0], src[:B0]
        with metrics.leaf("step.run"):
            N = int(self.corpus_q.shape[0])
            num_chunks = pick_num_chunks(N, B, k * max(1, overfetch))
            args = (q, self.corpus_q, self.corpus_scale, self.chunk_case,
                    self.chunk_court, self.chunk_date)
            kw = dict(recall_target=recall_target, use_court=use_filters,
                      use_date=use_filters, **common)
            if num_chunks > 1:
                out = fused_hybrid_topk_chunked(*args, num_chunks=num_chunks, **kw)
            else:
                out = fused_hybrid_topk(*args, **kw)
            v, i, cases, src = _host(out)
        return v[:B0], i[:B0], cases[:B0], src[:B0]

    def _query_sharded(
        self, hostq: dict, use_filters: bool, k: int, overfetch: int,
        recall_target: float, B: int, B0: int,
    ) -> tuple[np.ndarray, ...]:
        """The sharded modes of :meth:`query_batch` over its padded host
        batch: the stream past the break-even, else the probe (with
        flat-boundary escalation through the sharded stream), or the
        sharded brute scan."""
        names = ("court_table", "lo", "hi", "trie_rows", "trie_src", "min_sim", "exact_w")
        if self.ann_mode == "sharded-partitioned" and self._layout_brute_batch(B):
            v, i, cases, src = self._dispatch_stream(
                hostq["q"], *(hostq[n] for n in names), use_filters, k, overfetch, recall_target,
            )
            return v[:B0], i[:B0], cases[:B0], src[:B0]
        q = torch.tensor(hostq["q"], device=self.device)
        shared = self._sharded_shared(*(hostq[n] for n in names))
        if self.ann_mode == "sharded-partitioned":
            upk, _ = resolve_probe_kernel(recall_target, self.sp_m, self.sp_dim)
            out = sharded_partitioned_topk(
                self.mesh, q, self.sp_centroids, self.sp_rows, self.sp_int8, self.sp_scale,
                self.sp_cword, self.sp_cbit, self.sp_date, self.sp_bf16, self.chunk_case,
                *shared, k=k, nprobe=self.sp_nprobe, overfetch=overfetch,
                rescore_factor=self.sp_rescore, use_probe_kernel=upk,
            )
            v, i, cases, src = self._escalate_flat(
                hostq, use_filters, k, overfetch, recall_target, *_host(out), B0,
            )
            return v[:B0], i[:B0], cases[:B0], src[:B0]
        first = self.corpus_q[self.mesh.local_data_rows[0]]
        scan_mode, _ = resolve_scan_kernel(recall_target, int(first.shape[0]), first.device)
        out = sharded_fused_topk(
            self.mesh, q, self.corpus_q, self.corpus_scale, self.chunk_case,
            self.chunk_court, self.chunk_date, *shared, k=k, n_valid=self.num_vectors,
            overfetch=overfetch, recall_target=recall_target, scan_mode=scan_mode,
            use_court=use_filters, use_date=use_filters,
        )
        v, i, cases, src = _host(out)
        return v[:B0], i[:B0], cases[:B0], src[:B0]
