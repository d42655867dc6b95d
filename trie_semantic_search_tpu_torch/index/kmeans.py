"""Spherical k-means partitioner and centroid assignment, on the device.

Port of ``trie_semantic_search_tpu/index/kmeans.py``. What the JAX package
runs as jitted XLA (the Lloyd steps, ``_assign``, ``_topc``) runs here as
torch on the caller's device; the host sampling stays numpy, so both
packages train on the same sample from the same seed.

Numerics follow the JAX code: f32 products with TF32 off
(:func:`~..ops.scan_kernels.exact_float32`), centroid sums as the one-hot
product (a matmul, not ``index_add_``, whose CUDA atomics would make two
builds with the same seed differ), argmax ties to the lower centroid id,
and ``assign_topc`` as ``c`` rounds of argmax-then-mask, so equal scores
come out in ascending centroid id (``torch.topk`` has no tie order).

Identical centroid rows must score identically for those ties to hold, and
a GEMM need not give them the same f32 bits: torch's CPU GEMM can round a
tail column differently from its twin. Every argmax here reads
:func:`_scores`, which copies each duplicate's column from the lowest id
holding the same row, so a duplicate always ties and the lower id wins;
the products of distinct centroids are the GEMM's own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.scan_kernels import exact_float32

#: rows per device block in the Lloyd and assignment steps: bounds the
#: ``[block, P]`` similarity tile (1.3 GB f32 at P=5,120)
_LLOYD_BLOCK = 65_536


def _renormalised(sums: torch.Tensor, counts: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Mean of each cluster (the old centroid where it is empty), L2
    normalised."""
    counts = counts[:, None]
    new_c = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), c)
    norms = torch.linalg.vector_norm(new_c, dim=1, keepdim=True)
    return new_c / torch.clamp(norms, min=1e-12)


def _one_hot(a: torch.Tensor, num_clusters: int, w: torch.Tensor) -> torch.Tensor:
    """``[n, P]`` f32 rows holding ``w`` at column ``a`` and 0 elsewhere."""
    out = torch.zeros((a.shape[0], num_clusters), dtype=torch.float32, device=a.device)
    return out.scatter_(1, a[:, None], w[:, None])


def _first_copy(cent: torch.Tensor) -> torch.Tensor | None:
    """For each centroid the lowest id holding the same row, or ``None``
    when every row is distinct."""
    P = cent.shape[0]
    _, inverse = torch.unique(cent, dim=0, return_inverse=True)
    if int(inverse.max()) + 1 == P:
        return None
    ids = torch.arange(P, device=cent.device)
    first = torch.full((P,), P, dtype=ids.dtype, device=cent.device)
    return first.scatter_reduce_(0, inverse, ids, "amin")[inverse]


def _scores(v: torch.Tensor, cent: torch.Tensor, first: torch.Tensor | None) -> torch.Tensor:
    """``[n, P]`` f32 scores ``v @ cent.T``, each duplicate centroid's
    column a copy of its first copy's (``first`` from :func:`_first_copy`)."""
    sims = v @ cent.T
    return sims if first is None else sims[:, first]


def _nearest(v: torch.Tensor, cent: torch.Tensor, first: torch.Tensor | None) -> torch.Tensor:
    """Nearest centroid per row, ties to the lower id."""
    return torch.argmax(_scores(v, cent, first), dim=1)


def _lloyd(x: torch.Tensor, init: torch.Tensor, num_clusters: int, iters: int) -> torch.Tensor:
    """``iters`` Lloyd steps over the whole ``[S, D]`` sample at once."""
    c = init
    for _ in range(iters):
        assign = _nearest(x, c, _first_copy(c))
        one_hot = _one_hot(assign, num_clusters, torch.ones_like(x[:, 0]))  # [S, P]
        c = _renormalised(one_hot.T @ x, one_hot.sum(dim=0), c)
    return c


def _lloyd_blocked(
    xb: torch.Tensor,  # [B, block, D] normalised sample, zero-padded
    valid: torch.Tensor,  # [B, block] f32: 1.0 for real rows, 0.0 for padding
    init: torch.Tensor,
    num_clusters: int,
    iters: int,
) -> torch.Tensor:
    """The same Lloyd steps blocked over the sample axis: assignments are
    per row, so blocking only permutes the f32 order of the centroid sums;
    padding rows carry weight 0."""
    c = init
    d = xb.shape[-1]
    for _ in range(iters):
        sums = torch.zeros((num_clusters, d), dtype=torch.float32, device=xb.device)
        counts = torch.zeros((num_clusters,), dtype=torch.float32, device=xb.device)
        first = _first_copy(c)
        for v, w in zip(xb, valid):
            a = _nearest(v, c, first)
            oh = _one_hot(a, num_clusters, w)
            sums = sums + oh.T @ v
            counts = counts + oh.sum(dim=0)
        c = _renormalised(sums, counts, c)
    return c


def train_kmeans(
    vectors: np.ndarray,  # [N, D] L2-normalised
    num_clusters: int,
    iters: int = 20,
    sample: int = 200_000,
    seed: int = 0,
    dedup: bool = False,
    device: DeviceLike = None,
) -> np.ndarray:
    """Train centroids on (a sample of) the corpus; ``[P, D]`` f32. The
    sample, the optional exact-duplicate drop and the initial centroids are
    drawn on the host exactly as the JAX package draws them; the Lloyd
    steps run on ``device``."""
    dev = resolve_device(device)
    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    if n > sample:
        idx = rng.choice(n, size=sample, replace=False)
        x = vectors[idx]
    else:
        x = vectors
    if dedup and x.shape[0] > 1:
        xc = np.ascontiguousarray(x, np.float32)
        flat = xc.view([("", xc.dtype)] * xc.shape[1]).ravel()
        _, uniq_idx = np.unique(flat, return_index=True)
        if len(uniq_idx) >= min(num_clusters, 8):
            x = xc[np.sort(uniq_idx)]
    init_idx = rng.choice(x.shape[0], size=min(num_clusters, x.shape[0]), replace=False)
    init = x[init_idx]
    if init.shape[0] < num_clusters:  # tiny corpora: tile + jitter
        reps = -(-num_clusters // init.shape[0])
        init = np.tile(init, (reps, 1))[:num_clusters]
        init = init + rng.normal(0, 1e-3, init.shape).astype(init.dtype)
        init = init / np.maximum(np.linalg.norm(init, axis=1, keepdims=True), 1e-12)
    exact_float32()
    init_t = torch.as_tensor(np.ascontiguousarray(init, np.float32), device=dev)
    if x.shape[0] <= _LLOYD_BLOCK:
        xt = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
        c = _lloyd(xt, init_t, num_clusters, iters)
    else:
        nb = -(-x.shape[0] // _LLOYD_BLOCK)
        xp = torch.zeros((nb * _LLOYD_BLOCK, x.shape[1]), dtype=torch.float32, device=dev)
        xp[: x.shape[0]] = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
        valid = torch.zeros(nb * _LLOYD_BLOCK, dtype=torch.float32, device=dev)
        valid[: x.shape[0]] = 1.0
        c = _lloyd_blocked(
            xp.reshape(nb, _LLOYD_BLOCK, -1), valid.reshape(nb, _LLOYD_BLOCK),
            init_t, num_clusters, iters,
        )
    return c.cpu().numpy()


def _blocks(vectors: np.ndarray, block: int, dev: torch.device):
    """``(start, [rows, D] f32 block on dev)`` over the host rows."""
    for s in range(0, vectors.shape[0], block):
        yield s, torch.as_tensor(np.ascontiguousarray(vectors[s : s + block], np.float32), device=dev)


def assign_clusters(
    vectors: np.ndarray, centroids: np.ndarray, block: int = _LLOYD_BLOCK,
    device: DeviceLike = None,
) -> np.ndarray:
    """Nearest centroid per row (ties to the lower id), blocked; ``[N]``
    int32 on the host."""
    dev = resolve_device(device)
    exact_float32()
    cent = torch.tensor(np.asarray(centroids, np.float32), device=dev)
    first = _first_copy(cent)
    out = np.empty((vectors.shape[0],), np.int32)
    for s, v in _blocks(vectors, block, dev):
        out[s : s + v.shape[0]] = _nearest(v, cent, first).to(torch.int32).cpu().numpy()
    return out


def _topc(v: torch.Tensor, cent: torch.Tensor, first: torch.Tensor | None, k: int) -> torch.Tensor:
    """Top-``k`` centroid ids per row by ``k`` rounds of argmax-then-mask:
    each round removes exactly its pick, so equal scores come out in
    ascending centroid id."""
    sims = _scores(v, cent, first)
    picks = []
    for _ in range(k):
        a = torch.argmax(sims, dim=1, keepdim=True)
        sims.scatter_(1, a, -float("inf"))
        picks.append(a)
    return torch.cat(picks, dim=1).to(torch.int32)


def assign_topc(
    vectors: np.ndarray, centroids: np.ndarray, c: int, block: int = _LLOYD_BLOCK,
    device: DeviceLike = None,
) -> np.ndarray:
    """Top-``c`` nearest centroids per row, blocked; ``[N, min(c, P)]``
    int32 on the host. Column 0 equals :func:`assign_clusters`."""
    dev = resolve_device(device)
    exact_float32()
    cent = torch.tensor(np.asarray(centroids, np.float32), device=dev)
    first = _first_copy(cent)
    cc = min(c, centroids.shape[0])
    out = np.empty((vectors.shape[0], cc), np.int32)
    for s, v in _blocks(vectors, block, dev):
        out[s : s + v.shape[0]] = _topc(v, cent, first, cc).cpu().numpy()
    return out
