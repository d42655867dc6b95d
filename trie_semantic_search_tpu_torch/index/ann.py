"""Partitioned ANN index: load and serve.

Port of ``trie_semantic_search_tpu/index/ann.py`` (state, ``load``,
``load_dir``, ``default_nprobe``, ``search``, ``search_brute``). The frozen
layout is the JAX package's: ``[P, m, D]`` int8 partition blocks with
per-slot scales, a ``[P, m]`` slot→row map (-1 pads), ``[P, D]`` centroids
and a bf16 rescore copy of the corpus held as a tuple of row segments.
Both artifact formats the JAX package saves load here (``.npz`` with f16
rescore members, and the raw ``.npy`` directory with uint16 bf16 bit
views). Building (k-means, layout, replicas) comes with the build slice.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

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
