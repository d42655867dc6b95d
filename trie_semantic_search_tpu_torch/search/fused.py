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

Every threshold keeps its JAX value (``PARTITIONED_MIN_VECTORS``, the
break-even rule, ``TILE_B``, ``ESCALATE_BUCKET``, ``pick_num_chunks``), so
both packages pick the same stage for the same batch. The sharded modes
come with the multi-GPU slice.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional, Sequence

import numpy as np
import torch

from ..index.ann import PartitionedANN
from ..index.trie import TrieIndex
from ..index.vector import VectorIndex
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
from ..ops.scan_kernels import TILE_B, pad_align_for
from ..ops.scoring import quantize_int8
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
        flat_escalate_eps: float = 0.0,  # 0 disables escalation
    ):
        if vector_index.vectors is None or not len(vector_index.vectors):
            raise ValueError("vector index has no frozen vectors")
        self.trie_index = trie_index
        self.vector_index = vector_index
        self.columns = columns
        self.device = dev = vector_index.device
        self.flat_escalate_eps = float(flat_escalate_eps)
        #: total queries escalated
        self.escalated = 0

        t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
        refs = np.asarray(vector_index.refs, np.int32)
        chunk_case = refs[:, 0]
        #: paragraph of each chunk (host): the engine anchors snippets on it
        self.chunk_para = refs[:, 1]
        # representative chunk per case: the FIRST chunk in ref order
        rep = np.full(len(columns), -1, np.int32)
        rep[chunk_case[::-1]] = np.arange(len(chunk_case) - 1, -1, -1, dtype=np.int32)
        self.trie_chunk_of_case = t(rep)
        self.num_courts = max(len(columns.court_vocab), 1)

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
            v = np.asarray(vector_index.vectors, np.float32)
            v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
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

    def _layout_brute_batch(self, batch: int) -> bool:
        """Stream the batch when the probe would read at least as many rows:
        ``B·nprobe >= P·ceil(B/TILE_B)`` (the JAX package's break-even)."""
        if self.ann is None:
            return False
        P = int(self.ann.centroids.shape[0])
        nprobe = int(self.ann.default_nprobe)
        return batch * nprobe >= P * (-(-batch // TILE_B))

    def _dispatch_stream(
        self, q_np, court_table, lo, hi, trie_rows, trie_src, min_sim, exact_w,
        use_filters: bool, k: int, overfetch: int, recall_target: float,
    ) -> tuple[np.ndarray, ...]:
        """One stream of the partition layout over an already padded host
        batch (large-batch pick and escalation share it)."""
        dev = self.device
        t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
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
        if self.flat_escalate_eps <= 0.0 or self.ann_mode != "partitioned":
            return
        D = int(self.ann.part_int8.shape[-1])
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
        serving ladder with inert queries (+inf threshold, no hits)."""
        B0 = B = len(queries_text)
        Bp = batch_bucket(B)
        trie_rows, trie_valid = self.trie_index.search_batch_rows(list(queries_text))
        trie_rows = np.where(trie_valid, trie_rows, -1).astype(np.int32)
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
        if self.ann_mode == "partitioned":
            if self._layout_brute_batch(B):
                v, i, cases, src = self._dispatch_stream(
                    hostq["q"], court_table, lo, hi, trie_rows, trie_src,
                    hostq["min_sim"], hostq["exact_w"], use_filters, k,
                    overfetch, recall_target,
                )
                return v[:B0], i[:B0], cases[:B0], src[:B0]
            pcw, pcb, pdt = self._part_cols
            upk, _ = resolve_probe_kernel(
                recall_target, int(self.ann.part_rows.shape[1]),
                int(self.ann.part_int8.shape[-1]),
            )
            out = fused_partitioned_topk(
                q, self.ann.centroids, self.ann.part_rows, self.ann.part_int8,
                self.ann.part_scale, self.ann.corpus_bf16, self.chunk_case,
                self.chunk_court, self.chunk_date,
                nprobe=self.ann.default_nprobe,
                rescore_factor=max(1, self.ann.config.rescore_factor),
                recall_target=recall_target, part_cword=pcw, part_cbit=pcb,
                part_date=pdt, use_probe_kernel=upk, **common,
            )
            v, i, cases, src = self._escalate_flat(
                hostq, use_filters, k, overfetch, recall_target, *_host(out), B0,
            )
            return v[:B0], i[:B0], cases[:B0], src[:B0]
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
