#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

What it does, in order (any failure exits non-zero before the last line):

1. Device: requires CUDA (no CPU path); prints the card's name and power
   limit (``nvidia-smi``), ``torch.version.cuda`` and the kernel build time.
2. Kernels: builds the three CUDA kernels from ``csrc/`` and holds each
   against its plain PyTorch version on the card at the main path's shapes
   (bitwise for the two int8 kernels, 1e-5 for the bf16 rescore), timing
   kernel and plain version with CUDA events beside the least time the
   card could take (bytes over 3.35 TB/s or operations over the peak rate
   of their type).
3. Small-input reference: the same small partitioned index served on the
   CPU (plain versions) and on the card (kernels) must agree.
4. Slice: a 5,242,880-chunk partition-major corpus (P=5120, m=1024,
   D=384, int8 blocks + bf16 rescore segments; clustered, 10% duplicates)
   generated on the card from ``--seed``, court/date columns, a trie over
   synthetic case names, and the MiniLM-L6 encoder at full width with
   seeded weights.
5. Serve: encoded text batches through ``FusedHybridSearch.query_batch``
   with the engine's settings (k=32 and the search config's defaults:
   overfetch 4, recall target 0.97, flat escalation 0.01): B=8 and B=64
   (probe), B=256 (stream) and a filtered B=64 batch. Every kernel's launch
   counter must be above 0 after this run; recall@10 is reported against
   the port's own exact stream (recall target 1.0).
6. Profile: each unfiltered batch once more under ``torch.profiler``:
   device time by kernel and the device's busy share.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import datetime as dt
import functools
import json
import subprocess
import sys
import time
import traceback
import uuid
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, int8 op/s, bf16 flop/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12

P_PARTS, M_SLOTS, DIM = 5120, 1024, 384
#: the engine's fused k for any max_results <= 24 (its warmed k bucket)
K = 32


@functools.lru_cache(maxsize=1)
def serving_settings() -> tuple[int, float, float]:
    """(overfetch, recall target, escalation eps): the search defaults."""
    from trie_semantic_search_tpu_torch.core.config import SearchEngineConfig

    c = SearchEngineConfig()
    return c.fused_overfetch, c.fused_recall_target, c.fused_flat_escalate_eps


def log(*a) -> None:
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


def make_corpus(torch, P: int, m: int, D: int, seed: int, device, gen_device=None):
    """Clustered partition-major corpus like the JAX package's bench: each
    64-partition slab draws its centroids around 8 shared super-topics,
    rows scatter around their centroid, 10% of rows copy their in-partition
    neighbour. Returns centroids, int8 blocks, scales and bf16 rescore
    segments (the saved artifact geometry). The random numbers come from a
    generator on ``gen_device`` (default ``device``)."""
    from trie_semantic_search_tpu_torch.ops.scan_kernels import (
        GATHER_ROW_ALIGN_LCM,
        GATHER_SEG_BYTES,
    )

    gdev = torch.device(gen_device or device)
    g = torch.Generator(device=gdev).manual_seed(seed)
    N = P * m
    slab = min(64, P)
    L = GATHER_ROW_ALIGN_LCM
    seg_rows = max(L, (GATHER_SEG_BYTES // (D * 2)) // L * L)
    segs, lo = [], 0
    while lo < N:
        n = min(seg_rows, N - lo)
        segs.append(torch.zeros((-(-n // L) * L, D), dtype=torch.bfloat16, device=device))
        lo += n
    cents = torch.empty((P, D), device=device)
    part_int8 = torch.empty((P, m, D), dtype=torch.int8, device=device)
    part_scale = torch.empty((P, m), device=device)
    G = 8
    for p0 in range(0, P, slab):
        sup = torch.randn((G, D), generator=g, device=gdev)
        sup /= sup.norm(dim=-1, keepdim=True)
        c = sup[torch.arange(slab, device=gdev) // (slab // G)]
        c = c + 0.25 * torch.randn((slab, D), generator=g, device=gdev) / D**0.5
        c /= c.norm(dim=-1, keepdim=True)
        v = c[:, None, :] + 0.35 * torch.randn((slab, m, D), generator=g, device=gdev) / D**0.5
        v /= v.norm(dim=-1, keepdim=True)
        dup = torch.rand((slab, m), generator=g, device=gdev) < 0.10
        v = torch.where(dup[..., None], torch.roll(v, 1, dims=1), v).to(device)
        scale = v.abs().amax(dim=-1) / 127.0
        cents[p0 : p0 + slab] = c.to(device)
        part_int8[p0 : p0 + slab] = torch.clamp(torch.round(v / scale[..., None]), -127, 127).to(torch.int8)
        part_scale[p0 : p0 + slab] = scale
        flat = v.reshape(-1, D).to(torch.bfloat16)
        r0 = p0 * m
        off = 0
        while off < flat.shape[0]:
            si, so = divmod(r0 + off, seg_rows)
            take = min(flat.shape[0] - off, seg_rows - so)
            segs[si][so : so + take] = flat[off : off + take]
            off += take
    return cents, part_int8, part_scale, tuple(segs)


def build_search(torch, np, device, P, m, D, seed, n_names, num_probes, gen_device=None,
                 ann_mode="auto"):
    """The port's serving state on ``device``: ANN, vector index, columns,
    trie, embedder (MiniLM at full width, seeded) and FusedHybridSearch."""
    from trie_semantic_search_tpu_torch.core.config import AnnConfig, VectorConfig
    from trie_semantic_search_tpu_torch.index.ann import PartitionedANN
    from trie_semantic_search_tpu_torch.index.trie import TrieIndex
    from trie_semantic_search_tpu_torch.index.vector import VectorIndex
    from trie_semantic_search_tpu_torch.models.embedder import Embedder
    from trie_semantic_search_tpu_torch.models.minilm import MiniLM, MiniLMConfig
    from trie_semantic_search_tpu_torch.models.tokenizer import (
        WordPieceTokenizer,
        train_wordpiece_vocab,
    )
    from trie_semantic_search_tpu_torch.search.fused import FusedHybridSearch
    from trie_semantic_search_tpu_torch.storage.columns import MetadataColumns

    N = P * m
    cents, part_int8, part_scale, segs = make_corpus(torch, P, m, D, seed, device, gen_device)
    cfg = VectorConfig()
    cfg.hnsw = AnnConfig(num_probes=num_probes)
    ann = PartitionedANN(cfg.hnsw, device=device)
    ann.centroids, ann.part_int8, ann.part_scale, ann.corpus_bf16 = cents, part_int8, part_scale, segs
    ann.part_rows = torch.arange(N, dtype=torch.int32, device=device).reshape(P, m)
    ann.num_vectors = N

    n_cases = N // 4  # four chunks per case
    rows = np.arange(N, dtype=np.int32)
    refs = np.stack([rows // 4, rows % 4], axis=1)
    courts = ["", *[f"Court {i}" for i in range(15)]]
    case = np.arange(n_cases, dtype=np.int64)
    columns = MetadataColumns(
        case_ids=[uuid.UUID(int=int(i) + 1) for i in case],
        court_ids=(case % 16).astype(np.int32),
        dates=(-7305 + (case * 7919) % 25000).astype(np.int32),
        court_vocab={c: i for i, c in enumerate(courts)},
    )
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(500)] + ["state", "united", "people", "ohio"]
    named = rng.choice(n_cases, min(n_names, n_cases), replace=False)
    names = {int(c): f"{rng.choice(words)} {rng.choice(words)} v. {rng.choice(words)} {c}"
             for c in named}
    trie = TrieIndex(device=device)
    for c, name in names.items():
        trie.insert_case_name(name, c)
        trie.insert_citation(f"{c % 900} U.S. {c % 7000} ({1950 + c % 70})", c)
        trie.insert_content(name.split()[:3] + ["held", "that"], c, 0)
    trie.freeze()
    vocab = train_wordpiece_vocab(list(names.values()) + words, vocab_size=4096, min_frequency=1)
    model = MiniLM(MiniLMConfig(), device=device, seed=seed)
    emb = Embedder(tokenizer=WordPieceTokenizer(vocab), model=model, device=device)
    vi = VectorIndex(cfg, embedder=emb, device=device)
    # only the vectors' length is read in the partitioned mode: a
    # zero-stride view stands for the 8 GB f32 store
    vi.set_frozen(refs, np.broadcast_to(np.zeros((1, D), np.float32), (N, D)), ann)
    fused = FusedHybridSearch(trie, vi, columns, ann_mode=ann_mode, flat_escalate_eps=serving_settings()[2])
    return fused, vi, names, words, courts


def texts_for(rng, names, words, B):
    named = list(names.values())
    out = []
    for i in range(B):
        if i % 3 == 0:
            out.append(named[rng.integers(len(named))])
        else:
            out.append(" ".join(rng.choice(words, rng.integers(3, 9))))
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def kernel_phases(torch, np, fused, vi, report):
    """Each kernel against its plain version on the card at the main path's
    shapes; times kernel, plain version and bound."""
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
    from trie_semantic_search_tpu_torch.ops.hybrid import pick_num_chunks, quantize_queries
    from trie_semantic_search_tpu_torch.ops.topk import exact_topk

    dev = vi.device
    ann = vi.ann
    P, m, D = ann.part_int8.shape
    N = P * m
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((256, D), generator=g, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    flat_q = ann.part_int8.reshape(N, D)
    flat_s = ann.part_scale.reshape(N)
    nc = pick_num_chunks(N, 256, K * serving_settings()[0])
    S = N // nc
    q8, qs = quantize_queries(q)
    n_keep = sk.fused_scan_n_keep(K * serving_settings()[0], sk.auto_tile_n(S))
    out = {}

    # 1. fused scan: one slab of the B=256 stream, filtered and unfiltered
    V = fused.num_courts
    table = torch.rand((256, V), generator=g, device=dev) < 0.6
    lo = torch.full((256,), -(2**31), dtype=torch.int32, device=dev)
    hi = torch.full((256,), 2**31 - 1, dtype=torch.int32, device=dev)
    lo[::2], hi[::2] = 0, 15000
    slab_court = fused._slot_court.reshape(N)[:S]
    slab_date = fused._part_cols[2].reshape(N)[:S]
    mins = torch.full((256,), 0.0, device=dev)
    err = 0.0
    for use_f in (True, False):
        inp = sk.fused_scan_inputs(qs, slab_court, slab_date, table, lo, hi, mins, flat_s[:S])
        kw = dict(corpus_q=flat_q[:S], n_keep=n_keep, use_court=use_f, use_date=use_f, **inp)
        kv, ki = sk.fused_scan_cuda(q8, **kw)
        pv, pi = sk.fused_scan_plain(q8, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)):
            bad = (kv != pv) | (ki != pi)
            raise AssertionError(f"fused scan differs from plain (filters={use_f}): {int(bad.sum())} entries")
        fin = torch.isfinite(pv)
        err = max(err, float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0)
    ms = cuda_ms(torch, lambda: sk.fused_scan_cuda(q8, **kw), 20)
    plain_ms = cuda_ms(torch, lambda: sk.fused_scan_plain(q8, **kw), 2)
    nbytes = S * D + S * 4 + 256 * (D + 16) + 256 * n_keep * 128 * 8
    b_ms, b_by = bound(nbytes, 2.0 * 256 * S * D, INT8_OPS)
    out["fused_scan"] = dict(
        name="fused_scan", route="cuda", source="trie_semantic_search_tpu_torch/csrc/fused_scan.cu",
        replaces="trie_semantic_search_tpu/ops/pallas_scan.py:393", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B=256 slab={S}x{D} T={n_keep} (unfiltered timed)",
    )
    report(out["fused_scan"])

    # 2. probe: B=64 queries x nprobe probes, the serving columns
    B = 64
    NP = int(ann.default_nprobe)
    qb = q[:B]
    _, top_p = exact_topk(qb @ ann.centroids.T, NP)
    q8b, qsb = quantize_queries(qb)
    pcw, pcb, pdt = fused._part_cols
    qwords = sk.pack_court_words(table[:B])
    args = (q8b, qsb.reshape(B), top_p.to(torch.int32), ann.part_int8, ann.part_scale,
            ann.part_rows, pcw, pcb, pdt, qwords, lo[:B], hi[:B], mins[:B])
    kv, ks = sk.probe_candidates_cuda(*args)
    pv, ps = sk.probe_candidates_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ks, ps)):
        raise AssertionError("probe kernel differs from plain")
    fin = torch.isfinite(pv)
    err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
    ms = cuda_ms(torch, lambda: sk.probe_candidates_cuda(*args), 20)
    plain_ms = cuda_ms(torch, lambda: sk.probe_candidates_plain(*args), 2)
    uniq = int(torch.unique(top_p).numel())
    nbytes = uniq * m * (D + 4 * 5) + B * (D + 16 + 4 * NP) + B * NP * 256 * 8
    b_ms, b_by = bound(nbytes, 2.0 * B * NP * m * D, INT8_OPS)
    out["probe_candidates"] = dict(
        name="probe_candidates", route="cuda", source="trie_semantic_search_tpu_torch/csrc/probe.cu",
        replaces="trie_semantic_search_tpu/ops/pallas_scan.py:601", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={B} nprobe={NP} block={m}x{D} unique_partitions={uniq}",
    )
    report(out["probe_candidates"])

    # 3. gather rescore: B=64 x C=512 candidates (the probe's), in the
    # bf16 segments; rows drawn from the probed partitions
    C = K * serving_settings()[0] * 4
    slots = torch.randint(0, m, (B, C), generator=g, device=dev)
    idx = ann.part_rows[top_p[:, torch.arange(C, device=dev) % NP], slots].to(torch.int32)
    idx = idx.contiguous()
    kr = sk.gather_rescore_cuda(qb.contiguous(), ann.corpus_bf16, idx)
    pr = sk.gather_rescore_plain(qb, ann.corpus_bf16, idx)
    torch.cuda.synchronize()
    err = float((kr - pr).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"gather rescore differs from plain by {err}")
    ms = cuda_ms(torch, lambda: sk.gather_rescore_cuda(qb.contiguous(), ann.corpus_bf16, idx), 20)
    plain_ms = cuda_ms(torch, lambda: sk.gather_rescore_plain(qb, ann.corpus_bf16, idx), 2)
    uniq = int(torch.unique(idx).numel())
    nbytes = uniq * D * 2 + B * D * 4 + B * C * 8
    b_ms, b_by = bound(nbytes, 2.0 * B * C * D, BF16_FLOPS)
    out["gather_rescore"] = dict(
        name="gather_rescore", route="cuda", source="trie_semantic_search_tpu_torch/csrc/gather_rescore.cu",
        replaces="trie_semantic_search_tpu/ops/pallas_scan.py:796", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={B} C={C} D={D} segments={len(ann.corpus_bf16)} unique_rows={uniq}",
    )
    report(out["gather_rescore"])
    return out


def small_reference(torch, np, seed, devices=("cpu", "cuda")):
    """The same small partitioned index (data drawn on the CPU) served on
    the CPU (plain versions) and on the card (kernels): the encoders agree
    to a bf16 cosine and, fed the same embeddings, the two serve the same
    rows, sources and dead slots with scores within 1e-5. One query probes,
    a bucket of 8 streams (P=16, nprobe=3)."""
    built = {
        d: build_search(torch, np, torch.device(d), 16, 128, DIM, seed, 300, 3, "cpu",
                        "partitioned")
        for d in devices
    }
    (fc, vc, names, words, courts), (fg, vg, *_) = built[devices[0]], built[devices[1]]
    rng = np.random.default_rng(5)
    worst = 0.0
    for B in (1, 8):
        texts = texts_for(rng, names, words, B)
        q = vc.generate_embeddings(texts)
        cos = float((q * vg.generate_embeddings(texts)).sum(axis=1).min())
        if cos < 0.999:
            raise AssertionError(f"encoder CPU vs card cosine {cos}")
        cf = [[courts[3], courts[5]] if i % 2 else None for i in range(B)]
        a, b = (
            f.query_batch(q, texts, cf, [None] * B, [0.0] * B, [2.0] * B,
                          k=K, overfetch=serving_settings()[0], recall_target=serving_settings()[1])
            for f in (fc, fg)
        )
        for x, y in zip(a[1:], b[1:]):
            if not np.array_equal(x, y):
                raise AssertionError(f"B={B}: card and CPU serve different rows")
        fin = np.isfinite(a[0])
        if not np.array_equal(fin, np.isfinite(b[0])):
            raise AssertionError("card and CPU disagree on dead slots")
        if fin.any():
            worst = max(worst, float(np.abs(a[0][fin] - b[0][fin]).max()))
    if worst > 1e-5:
        raise AssertionError(f"small-input scores differ by {worst}")
    return worst


def serve(torch, np, fused, vi, names, words, courts, seed):
    """The main path: encoded batches through query_batch; returns the
    per-batch records and the launch counts of exactly this run."""
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk

    rng = np.random.default_rng(seed + 1)
    batches = []
    for B, filtered in ((8, False), (64, False), (256, False), (64, True)):
        texts = texts_for(rng, names, words, B)
        cf = [[courts[1 + i % 15], courts[2 + (i + 3) % 14]] if filtered and i % 2 == 0 else None
              for i in range(B)]
        dr = [(dt.date(1960, 1, 1), dt.date(1990, 12, 31)) if filtered and i % 3 != 1 else None
              for i in range(B)]
        batches.append((B, filtered, texts, cf, dr))
    sk.reset_launch_counts()
    records = []
    for B, filtered, texts, cf, dr in batches:
        mode = "stream" if fused._layout_brute_batch(B) else "probe"
        times = []
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = vi.embedder.embed(texts).embedding
            t1 = time.perf_counter()
            res = fused.query_batch(q, texts, cf, dr, [0.0] * B, [2.0] * B, k=K,
                                    overfetch=serving_settings()[0], recall_target=serving_settings()[1])
            torch.cuda.synchronize()
            times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        records.append(dict(B=B, filtered=filtered, mode=mode, texts=texts, cf=cf, dr=dr,
                            q=q, res=res, encode_ms=[t[0] for t in times],
                            query_ms=[t[1] for t in times]))
    return records, dict(sk.LAUNCHES)


def profile_batches(torch, fused, vi, records, out_dir: Path) -> list[dict]:
    """One more run of each unfiltered batch under ``torch.profiler``:
    device time by kernel (``chiprun_out/profile_B<B>.txt``) and the
    device's busy share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for rec in records:
        if rec["filtered"]:
            continue
        B = rec["B"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = vi.embedder.embed(rec["texts"]).embedding
            fused.query_batch(q, rec["texts"], rec["cf"], rec["dr"], [0.0] * B, [2.0] * B,
                              k=K, overfetch=serving_settings()[0], recall_target=serving_settings()[1])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(  # noqa: E731
            e, "self_cuda_time_total", 0)
        # the device-side events themselves (kernels, copies, memsets): an
        # operator's device time repeats theirs, so only these are summed
        on_dev = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
        device_ms = sum(dev_us(e) for e in on_dev) / 1e3
        top = sorted(on_dev, key=dev_us, reverse=True)[:8]
        (out_dir / f"profile_B{B}.txt").write_text(
            events.table(sort_by="self_cuda_time_total", row_limit=25)
        )
        rows.append(dict(B=B, mode=rec["mode"], wall_ms=wall_ms, device_ms=device_ms,
                         busy_share=device_ms / wall_ms,
                         top=[(e.key[:60], dev_us(e) / 1e3, e.count) for e in top]))
    return rows


def check_and_recall(np, fused, rec):
    """Shape/range checks, then recall@10 vs the exact stream."""
    v, i, cases, src = rec["res"]
    B = rec["B"]
    n_cases = len(fused.columns)
    if not (v.shape == i.shape == cases.shape == src.shape == (B, K)):
        raise AssertionError(f"bad result shape {v.shape}")
    live = cases >= 0
    if not live.any():
        raise AssertionError("batch served nothing")
    if not (np.isfinite(v[live]).all() and (cases[live] < n_cases).all()
            and (i[live] >= 0).all() and np.isin(src, [0, 1, 2, 3]).all()):
        raise AssertionError("malformed live results")
    if not (np.isneginf(v[~live]).all() and (i[~live] == -1).all()):
        raise AssertionError("malformed dead slots")
    exact_pick = fused._layout_brute_batch
    fused._layout_brute_batch = lambda batch: True
    try:
        ev, ei, ec, es = fused.query_batch(
            rec["q"], rec["texts"], rec["cf"], rec["dr"], [0.0] * B, [2.0] * B,
            k=K, overfetch=serving_settings()[0], recall_target=1.0,
        )
    finally:
        fused._layout_brute_batch = exact_pick
    hits = []
    for b in range(B):
        want = {int(c) for c in ec[b, :10] if c >= 0}
        got = {int(c) for c in cases[b, :10] if c >= 0}
        if want:
            hits.append(len(want & got) / len(want))
    return float(np.mean(hits)) if hits else 1.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import numpy as np

    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    sk.exact_float32()
    lib = sk.load_library()
    log(f"kernel library: {lib.path.name} built in {lib.build_seconds:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    detail = {"gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_seconds": lib.build_seconds, "build_log": lib.log}

    log("phase: small-input reference (CPU plain versions vs card kernels)")
    detail["small_reference_max_score_diff"] = small_reference(torch, np, args.seed)
    log(f"  agree; max score difference {detail['small_reference_max_score_diff']:.3g}")

    log(f"phase: build state on the card (P={P_PARTS} m={M_SLOTS} D={DIM})")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    fused, vi, names, words, courts = build_search(
        torch, np, dev, P_PARTS, M_SLOTS, DIM, args.seed, 20_000, 64
    )
    if fused.ann_mode != "partitioned":
        raise AssertionError(f"auto mode picked {fused.ann_mode} at {vi.ann.num_vectors} chunks")
    torch.cuda.synchronize()
    detail["build_state_s"] = time.perf_counter() - t0
    log(f"  {vi.ann.num_vectors} chunks, mode {fused.ann_mode}, nprobe {vi.ann.default_nprobe}, "
        f"{len(vi.ann.corpus_bf16)} rescore segments, {detail['build_state_s']:.1f} s")

    log("phase: kernels vs plain versions at the main path's shapes")
    kernels = kernel_phases(torch, np, fused, vi, lambda r: log(
        f"  {r['name']}: {r['shape']} max_abs_err={r['max_abs_err']:.3g} "
        f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
    ))

    log("phase: serve (counts reset just before, read just after)")
    records, launches = serve(torch, np, fused, vi, names, words, courts, args.seed)
    log(f"  launches on the main path: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for k, n in launches.items():
        kernels[k]["launches"] = n

    log("phase: checks and recall@10 vs the exact stream")
    detail["batches"] = []
    for rec in records:
        r10 = check_and_recall(np, fused, rec)
        row = dict(B=rec["B"], filtered=rec["filtered"], mode=rec["mode"],
                   encode_ms=rec["encode_ms"], query_ms=rec["query_ms"], recall_at_10=r10)
        detail["batches"].append(row)
        log(f"  B={rec['B']} {rec['mode']} filtered={rec['filtered']}: encode ms {rec['encode_ms']} "
            f"query ms {rec['query_ms']} recall@10 vs exact {r10:.4f}")
    detail["escalated"] = fused.escalated
    detail["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    detail["kernels"] = kernels
    out_dir = Path.cwd() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log("phase: profile (device time by kernel)")
    detail["profile"] = profile_batches(torch, fused, vi, records, out_dir)
    for row in detail["profile"]:
        log(f"  B={row['B']} {row['mode']}: wall {row['wall_ms']:.2f} ms, device "
            f"{row['device_ms']:.2f} ms (busy {row['busy_share']:.3f})")
        for name, ms, count in row["top"]:
            log(f"    {ms:9.3f} ms  x{count:<5} {name}")
    detail["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    log(f"escalated {fused.escalated}; peak memory {detail['peak_mem_gb']:.1f} GiB; "
        f"{detail['seconds']:.1f} s")
    log(f"gpu: {card}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys} for n in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
