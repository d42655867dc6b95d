#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's index build and serving path on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

What it does, in order (any failure exits non-zero before the last line):

1. Device: requires CUDA (no CPU path); prints the card's name and power
   limit (``nvidia-smi``), ``torch.version.cuda`` and the kernel build time.
   A child process starts writing the case store (phase 9) at once.
2. Small-input reference: the same small partitioned index served on the
   CPU (plain versions) and on the card (kernels) must agree.
3. Slice: a 5,242,880-chunk partition-major corpus (P=5120, m=1024,
   D=384, int8 blocks + bf16 rescore segments; clustered, 10% duplicates)
   generated on the card from ``--seed``, court/date columns, a trie over
   synthetic case names, and the MiniLM-L6 encoder at full width with
   seeded weights.
4. Kernels: builds the CUDA kernels from ``csrc/`` and holds each
   against its plain PyTorch version on the card at the main path's shapes
   (bitwise for the int8 kernels, 1e-5 for the bf16 rescore). Each kernel
   gets two times: its device time (``device_ms``, also ``ms``: the CUDA
   time of the kernels its C entry point launched, summed by
   ``torch.profiler`` over many calls and divided by their number, so no
   Python is in it) and its call time (``call_ms``: CUDA events around
   back-to-back calls of the wrapper, what a caller pays); beside them the
   plain version's time (events) and the least time the card could take
   (bytes over 3.35 TB/s or operations over the peak rate of their type).
   The probe is held bitwise at B = 8, 64 and 256, at B=64 with court and
   date filters, with all 64 queries sharing one probe list, with
   duplicated partition ids in a row and with min_sim cutting live slots;
   the rescore at B=8 and 64 with a row every query asks for and rows on
   both sides of a segment boundary. The fused scan's tensor-core variant runs at T = 2, 3,
   5 and its dp4a variant at T = 17, each at B = 8, 100
   and 256, 16 and 40 courts, filters on and off, on one slab of the
   B=256 stream, plus lane ties, a short last step and D=80; then the dp4a
   variant once through its own path, ``fused_scan_topk`` at T=17;
   ``torch._int_mm`` of the slab's int8 product is timed beside it. The
   int8 top-k's two variants (``int8_topk``: wgmma, D % 32 == 0;
   ``int8_topk_dp4a``: the rest) run first at small shapes (k up to 128,
   ragged N, part query tiles, +-0 ties, duplicates across 64- and 128-row
   edges; D=48 on the dp4a variant), then over the whole corpus viewed
   flat at B=256, k=32 (both variants), B=256, k=128 and B=64, k=32, with
   ``torch._int_mm`` of the same int8 product beside them, then once
   through each variant's path, the public op ``fused_int8_topk`` at
   D=384 and at D=48. Launch counts are reset just before each path.
5. Build, ANN at full size: the corpus rows of phase 3, in generation
   order, as f32 on the host, through ``PartitionedANN(AnnConfig(),
   device="cuda").build`` (P=5120 by ``_auto_partitions``; k-means on a
   200,000-row sample, blocked, and the top-8 centroid assignment on the
   card; rebalance, pad replicas, layout and int8 quantisation on the
   host). Prints each stage's time, the slot capacity m, the rows moved by
   the overflow rebalance, the pad replicas and the index's bytes. Checks:
   on one 65,536-row block the card's nearest centroid equals the CPU's
   except on rows whose top-two scores lie within 1e-5; with a copy of
   one centroid as the last id, assignment, top-3 and the Lloyd steps'
   pick keep the lower id first and the copy right behind; a 524,288-row
   subset (every tenth row) built twice from the same centroids is
   bitwise the same;
   ``tune_nprobe`` on 64 rows at target 0.95 picks an nprobe under P, at
   which ``search`` on 256 fresh queries (rows plus noise) reaches
   tie-aware recall@10 >= 0.95 against ``search_brute`` through the probe
   and rescore kernels (counts reset just before, read just after: the
   ``build`` path); recall at nprobe 64 is printed too; ``save_dir`` then
   ``load_dir`` serves bitwise the same. The index is freed after.
6. Build, pipeline end to end: a sqlite store of 32,768 cases with the
   fixture's texts (131,072 chunks), ``build_indexes(storage, cfg,
   device="cuda")`` with mean pooling and no embedder (a corpus vocab and
   the seeded MiniLM-L6 at full width), ``save_artifacts``,
   ``load_artifacts(cfg, device="cuda")``, ``SearchEngine.search_batch`` at
   B=8 and 64: the loaded engine must return what an engine over the
   in-memory indexes returns, name queries led by a case-name or exact
   hit. Prints each stage's time (vocab, text processing and trie inserts,
   embedding in chunks/s, trie freeze, ANN build, save, load).
7. Serve: encoded text batches through ``FusedHybridSearch.query_batch``
   with the engine's settings (k=32 and the search config's defaults:
   overfetch 4, recall target 0.97, flat escalation 0.01): B=8 and B=64
   (probe), B=256 (stream) and a filtered B=64 batch. Every serving
   kernel's launch counter must be above 0 after this run; recall@10 is
   reported against the port's own exact stream (recall target 1.0), and
   for each probe batch the distinct partitions its queries probe.
8. Profile: each unfiltered batch once more under ``torch.profiler``:
   device time by kernel and the device's busy share.
9. Engine: the 1,310,720 cases (names, citations, courts and dates of the
   trie and columns; one sentence per chunk) written by the child process
   into a sqlite store in the port store's schema and rows, one
   transaction per batch (on 1,000 cases its tables must equal
   ``store_cases_batch``'s row for row; ``store_cases_batch``'s own path,
   a commit per row, is timed on 16,384 cases);
   ``SearchEngine(..., device="cuda")`` over the same state, ``warmup``
   (must leave ``is_warm``), then ``search_batch`` at B=8, 64, 256 and a
   court + date filtered 64 on the fused path, B=8 (probe) and a partly
   filtered B=64 (exact scan) on the staged path, and B=8 again from the
   query cache. Each result must be hydrated, with a snippet, inside its
   filters; name queries lead with a case-name or exact hit. Launch counts
   are reset just before these batches and read just after.

The line before the last is a JSON object with one entry per kernel:
``launches`` counts the kernel on the path that reaches it (the
``query_batch`` run for the three serving kernels, ``fused_int8_topk`` for
the int8 top-k (at D=48 for its dp4a variant), ``fused_scan_topk`` at T=17 for the fused scan's dp4a
variant, which the serving paths must not launch) and ``launches_by_path``
on each path (``build``: phase 5's recall search). The last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --only kernels`` runs phases 1, 2 and 4 (and the
card state of 3) and skips the builds, serving, the profile, the store and
the engine: about a minute, for iterating on a kernel. Its serving kernels
print ``"launches": null``. ``--only int8-ablations`` builds the ablation
variants of the int8 top-k's wgmma kernel (``TSS_INT8_TOPK_ABLATE``) and
prints the device time of each at B=256, k=32 over the corpus of phase 3.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime as dt
import functools
import json
import logging
import math
import multiprocessing
import shutil
import subprocess
import sys
import tempfile
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
#: chunks per case; case names in the trie
CHUNKS_PER_CASE, N_NAMES = 4, 20_000
COURTS = ["", *[f"Court {i}" for i in range(15)]]
WORDS = [f"w{i}" for i in range(500)] + ["state", "united", "people", "ohio"]
EPOCH = dt.date(1970, 1, 1)
#: the kernels of the serving paths (query_batch and SearchEngine)
SERVING_KERNELS = ("fused_scan", "probe_candidates", "gather_rescore")


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
    """What a caller pays for one call of ``fn``: CUDA events around
    ``reps`` back-to-back calls, the wrapper's Python included."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


#: a fragment of the name of every CUDA kernel each wrapper's C entry
#: point launches (the kernel rows of the ``kernels`` line)
KERNEL_SYMBOLS = {"fused_scan": ("fused_scan_wgmma",), "fused_scan_dp4a": ("fused_scan_dp4a",),
                  "probe_candidates": ("probe_",), "gather_rescore": ("gather_rescore",),
                  "int8_topk": ("int8_topk_clear", "int8_topk_wgmma", "int8_topk_merge"),
                  "int8_topk_dp4a": ("int8_topk_dp4a", "int8_topk_merge")}


def dev_us(e) -> float:
    """Self device time (µs) of a profiler event, across torch versions."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def on_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def device_ms(torch, fn, reps: int, name: str) -> tuple[float, dict]:
    """The kernel's own time for one call of ``fn``: under
    ``torch.profiler``, the device time of every kernel that ``reps`` calls
    launched, summed and divided by ``reps``. Python, the wrapper and the
    launch path are not in it. Every device event of the window must be a
    kernel whose name holds one of ``KERNEL_SYMBOLS[name]``. Returns the ms and,
    per kernel, its launches and ms per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, kernels = 0.0, {}
    for e in prof.key_averages():
        if not on_device(e):
            continue
        if not any(f in e.key for f in KERNEL_SYMBOLS[name]):
            raise AssertionError(f"{name}: device event {e.key!r} in its timing window")
        total += dev_us(e)
        kernels[e.key[:80]] = dict(per_call=e.count / reps, ms=dev_us(e) / 1e3 / reps)
    if not kernels or total <= 0:
        raise AssertionError(f"{name}: the profiler recorded no device time")
    return total / 1e3 / reps, kernels


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


def corpus_slabs(torch, P: int, m: int, D: int, seed: int, gen_device):
    """The clustered corpus in generation order, one 64-partition slab at a
    time: ``(first partition, centroids [slab, D], L2-normalised rows
    [slab, m, D])``. Each slab draws its centroids around 8 shared
    super-topics, rows scatter around their centroid, and 10% of rows copy
    their in-partition neighbour. Random numbers come from a generator on
    ``gen_device``."""
    gdev = torch.device(gen_device)
    g = torch.Generator(device=gdev).manual_seed(seed)
    slab = min(64, P)
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
        yield p0, c, torch.where(dup[..., None], torch.roll(v, 1, dims=1), v)


def make_corpus(torch, P: int, m: int, D: int, seed: int, device, gen_device=None):
    """The clustered corpus of :func:`corpus_slabs` (the shape of the JAX
    package's bench corpus) laid out partition-major as a built index would
    hold it: centroids, int8 blocks, scales and bf16 rescore segments (the
    saved artifact geometry), row ``p * m + j`` in slot ``j`` of partition
    ``p``. The random numbers come from a generator on ``gen_device``
    (default ``device``)."""
    from trie_semantic_search_tpu_torch.ops.scan_kernels import (
        GATHER_ROW_ALIGN_LCM,
        GATHER_SEG_BYTES,
    )

    N = P * m
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
    for p0, c, v in corpus_slabs(torch, P, m, D, seed, gen_device or device):
        slab = c.shape[0]
        v = v.to(device)
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

    n_cases = N // CHUNKS_PER_CASE
    rows = np.arange(N, dtype=np.int32)
    refs = np.stack([rows // CHUNKS_PER_CASE, rows % CHUNKS_PER_CASE], axis=1)
    court_ids, dates = case_columns(np, n_cases)
    columns = MetadataColumns(
        case_ids=[uuid.UUID(int=i + 1) for i in range(n_cases)],
        court_ids=court_ids,
        dates=dates,
        court_vocab={c: i for i, c in enumerate(COURTS)},
    )
    names = case_names(np, n_cases, n_names, seed)
    trie = TrieIndex(device=device)
    for c, name in names.items():
        trie.insert_case_name(name, c)
        trie.insert_citation(citation(c), c)
        trie.insert_content(name.split()[:3] + ["held", "that"], c, 0)
    trie.freeze()
    vocab = train_wordpiece_vocab(list(names.values()) + WORDS, vocab_size=4096, min_frequency=1)
    model = MiniLM(MiniLMConfig(), device=device, seed=seed)
    emb = Embedder(tokenizer=WordPieceTokenizer(vocab), model=model, device=device)
    vi = VectorIndex(cfg, embedder=emb, device=device)
    # only the vectors' length is read in the partitioned mode: a
    # zero-stride view stands for the 8 GB f32 store
    vi.set_frozen(refs, np.broadcast_to(np.zeros((1, D), np.float32), (N, D)), ann)
    fused = FusedHybridSearch(trie, vi, columns, ann_mode=ann_mode, flat_escalate_eps=serving_settings()[2])
    return fused, vi, names, WORDS, COURTS


def case_columns(np, n_cases: int):
    """Court id (into ``COURTS``; 0 = no court) and decision date (days
    since 1970-01-01, over 68 years) of each case row."""
    case = np.arange(n_cases, dtype=np.int64)
    return (case % len(COURTS)).astype(np.int32), (-7305 + (case * 7919) % 25000).astype(np.int32)


def case_names(np, n_cases: int, n_names: int, seed: int) -> dict[int, str]:
    """Case row → name, for the ``n_names`` cases the trie indexes."""
    rng = np.random.default_rng(seed)
    named = rng.choice(n_cases, min(n_names, n_cases), replace=False)
    return {int(c): f"{rng.choice(WORDS)} {rng.choice(WORDS)} v. {rng.choice(WORDS)} {c}"
            for c in named}


def citation(c: int) -> str:
    return f"{c % 900} U.S. {c % 7000} ({1950 + c % 70})"


def case_text(c: int) -> str:
    """One sentence per chunk, so a semantic hit on chunk j anchors its
    snippet on sentence j."""
    return " ".join(
        f"In part {j} of case {c} the court held that w{(c * 7 + j) % 500} governs "
        f"the w{(c + 13 * j) % 500} claim." for j in range(CHUNKS_PER_CASE)
    )


def case_meta(CaseMetadata, c: int, names: dict, court_ids, dates):
    """The metadata of case row ``c``, consistent with the trie and the
    columns of :func:`build_search`."""
    name = names.get(c)
    return CaseMetadata(
        id=uuid.UUID(int=c + 1), name=name or f"Unindexed case {c}",
        citation=citation(c) if name else "", court=COURTS[court_ids[c]],
        decision_date=EPOCH + dt.timedelta(days=int(dates[c])),
        word_count=len(case_text(c).split()),
    )


def fixture_cases(np, CaseMetadata, rows, n_cases: int, n_names: int, seed: int):
    """``(metadata, text)`` of each case row in ``rows``, out of
    ``n_cases`` of which ``n_names`` have names."""
    names = case_names(np, n_cases, n_names, seed)
    court_ids, dates = case_columns(np, n_cases)
    for c in rows:
        yield case_meta(CaseMetadata, c, names, court_ids, dates), case_text(c)


def write_cases_fast(db_path: str, cases, batch: int = 1 << 14) -> None:
    """``(metadata, text)`` pairs into a new sqlite store in one transaction
    per batch. The schema, the statements and the rows are the port
    store's (``metadata_row``, ``text_row``); ``store_cases_batch`` writes
    the same rows but commits each one."""
    import itertools
    import sqlite3

    from trie_semantic_search_tpu_torch.core.config import StorageConfig
    from trie_semantic_search_tpu_torch.storage import store as st

    config = StorageConfig(db_path=db_path)
    st.StorageManager(config).close()
    conn = sqlite3.connect(db_path)
    it = iter(cases)
    while chunk := list(itertools.islice(it, batch)):
        with conn:
            conn.executemany(st.UPSERT_METADATA, [st.metadata_row(meta) for meta, _ in chunk])
            conn.executemany(st.UPSERT_TEXT, [st.text_row(meta.id, text, config.enable_compression)
                                              for meta, text in chunk])
    conn.close()


def store_rows(db_path: str) -> tuple[list, list]:
    """Every row of both tables in rowid order, the texts decompressed."""
    import gzip
    import sqlite3

    conn = sqlite3.connect(db_path)
    meta = conn.execute("SELECT rowid, * FROM case_metadata ORDER BY rowid").fetchall()
    text = [(r, cid, comp, gzip.decompress(blob) if comp else blob) for r, cid, comp, blob in
            conn.execute("SELECT rowid, * FROM case_text ORDER BY rowid").fetchall()]
    conn.close()
    return meta, text


#: cases of the check that the fast writer's rows are ``store_cases_batch``'s,
#: and of the sample that times ``store_cases_batch``'s own per-row path
STORE_CHECK_CASES, STORE_TIMED_CASES = 1000, 16_384


def build_store(db_path: str, n_cases: int, n_names: int, seed: int) -> None:
    """The engine phase's sqlite store of every case (metadata and text),
    consistent with the trie and the columns of :func:`build_search`,
    written by :func:`write_cases_fast`. First, on ``STORE_CHECK_CASES``
    cases, the fast writer's tables must equal ``store_cases_batch``'s row
    for row; then ``store_cases_batch`` alone writes ``STORE_TIMED_CASES``
    cases, timed. The seconds go to ``<db_path>.json``. Runs in a child
    process beside the card phases."""
    sys.path.insert(0, str(HERE))
    import numpy as np

    from trie_semantic_search_tpu_torch.core.config import StorageConfig
    from trie_semantic_search_tpu_torch.core.types import CaseMetadata
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    out = {}
    check = list(fixture_cases(np, CaseMetadata, range(STORE_CHECK_CASES), n_cases, n_names, seed))
    per_row, fast = db_path + ".per_row", db_path + ".fast"
    store = StorageManager(StorageConfig(db_path=per_row))
    if store.store_cases_batch(check) != (len(check), []):
        raise RuntimeError("store_cases_batch did not store every check case")
    store.close()
    write_cases_fast(fast, check)
    if store_rows(fast) != store_rows(per_row):
        raise RuntimeError("the fast writer's rows differ from store_cases_batch's")
    timed = list(fixture_cases(np, CaseMetadata, range(STORE_TIMED_CASES), n_cases, n_names, seed))
    t0 = time.perf_counter()
    store = StorageManager(StorageConfig(db_path=db_path + ".timed"))
    if store.store_cases_batch(timed) != (len(timed), []):
        raise RuntimeError("store_cases_batch did not store every timed case")
    store.close()
    out["store_cases_batch_s"] = time.perf_counter() - t0
    for f in (per_row, fast, db_path + ".timed"):
        for suffix in ("", "-wal", "-shm"):
            Path(f + suffix).unlink(missing_ok=True)
    t0 = time.perf_counter()
    write_cases_fast(db_path, fixture_cases(np, CaseMetadata, range(n_cases), n_cases, n_names, seed))
    out["fast_s"] = time.perf_counter() - t0
    Path(db_path + ".json").write_text(json.dumps(out))


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


#: fused-scan check cases: lane list lengths (the engine's k buckets x
#: overfetch 4 give T = 2, 3, 5; T = 17 is past the tensor-core lists and
#: runs the dp4a variant), batch sizes (100: a ragged query tile), court
#: counts (16 and 40: W = 1 and 2 words), filters on and off
FUSED_T, FUSED_B, FUSED_COURTS = (2, 3, 5, 17), (8, 100, 256), (16, 40)
#: the dp4a variant's own path: fused_scan_topk at this k and tile (T = 17)
DP4A_K, DP4A_TILE = 128 * 16, 8192


def fused_scan_phase(torch, np, fused, vi, report):
    """The fused scan's two variants against its plain version, bitwise, on
    one slab of the B=256 stream: every case of ``FUSED_T`` x ``FUSED_B`` x
    ``FUSED_COURTS`` x filters on/off, plus equal rows in every lane (ties
    the list update must resolve as the TPU kernel does), a slab of 1,021
    tiles (a short last step of 8 tiles) and D=80 (a half-empty last
    k-step). Times both variants, their plain version
    and ``torch._int_mm`` of the same int8 product (a yardstick of the
    tensor-core mainloop, not the same function); then the dp4a variant's
    own path, ``fused_scan_topk`` at T=17, with the counts set to 0 just
    before."""
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
    from trie_semantic_search_tpu_torch.ops.hybrid import pick_num_chunks, quantize_queries

    dev = vi.device
    ann = vi.ann
    P, m, D = ann.part_int8.shape
    N = P * m
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((256, D), generator=g, device=dev)
    q8, qs = quantize_queries(q / q.norm(dim=-1, keepdim=True))
    S = N // pick_num_chunks(N, 256, K * serving_settings()[0])
    slab = ann.part_int8.reshape(N, D)[:S]
    slab_scale = ann.part_scale.reshape(N)[:S]
    columns = {16: fused._slot_court.reshape(N)[:S],  # the serving columns
               40: torch.randint(-2, 70, (S,), generator=g, device=dev, dtype=torch.int32)}
    slab_date = fused._part_cols[2].reshape(N)[:S]
    lo = torch.full((256,), -(2**31), dtype=torch.int32, device=dev)
    hi = torch.full((256,), 2**31 - 1, dtype=torch.int32, device=dev)
    lo[::2], hi[::2] = 0, 15000
    mins = torch.zeros(256, device=dev)
    mins[1::3], mins[2::3] = -1.0, 0.05
    tables = {V: torch.rand((256, V), generator=g, device=dev) < 0.6 for V in FUSED_COURTS}

    def args(B, V, corpus, scale, court, date, T, filt, qq=None):
        qq = q8[:B] if qq is None else qq
        inp = sk.fused_scan_inputs(qs[:B], court, date, tables[V][:B], lo[:B], hi[:B], mins[:B], scale)
        return qq, dict(corpus_q=corpus, n_keep=T, use_court=filt, use_date=filt, **inp)

    def check(what, qq, kw):
        kv, ki = sk.fused_scan_cuda(qq, **kw)
        pv, pi = sk.fused_scan_plain(qq, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)):
            bad = (kv.view(torch.int32) != pv.view(torch.int32)) | (ki != pi)
            raise AssertionError(f"fused scan differs from plain ({what}): {int(bad.sum())} entries")
        fin = torch.isfinite(pv)
        return float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0

    err = {"wgmma": 0.0, "dp4a": 0.0}
    cases = 0
    for T in FUSED_T:
        variant = sk.fused_scan_variant(D, T)
        for B in FUSED_B:
            for V in FUSED_COURTS:
                for filt in (True, False):
                    qq, kw = args(B, V, slab, slab_scale, columns[V], slab_date, T, filt)
                    e = check(f"T={T} B={B} courts={V} filters={filt}", qq, kw)
                    err[variant] = max(err[variant], e)
                    cases += 1
    # equal rows in every lane: tiles 5, 10, ... copy tile 0
    tied = slab.clone().view(-1, 128, D)
    tied[5::5] = tied[0]
    tied_scale = slab_scale.clone().view(-1, 128)
    tied_scale[5::5] = tied_scale[0]
    for T in (2, 5):
        qq, kw = args(256, 40, tied.view(S, D), tied_scale.view(S), columns[40], slab_date, T, True)
        err["wgmma"] = max(err["wgmma"], check(f"lane ties T={T}", qq, kw))
    # 1,021 tiles: the last step holds 5 of its 8 tiles
    n_odd = 1021 * 128
    qq, kw = args(256, 40, slab[:n_odd], slab_scale[:n_odd], columns[40][:n_odd], slab_date[:n_odd], 2, True)
    err["wgmma"] = max(err["wgmma"], check("1,021 tiles", qq, kw))
    # D=80: the third k32 step is half past the row
    qq, kw = args(100, 16, slab[:37 * 128, :80].contiguous(), slab_scale[:37 * 128], columns[16][:37 * 128],
                  slab_date[:37 * 128], 3, True, qq=q8[:100, :80].contiguous())
    err["wgmma"] = max(err["wgmma"], check("D=80", qq, kw))
    log(f"  fused scan: {cases + 4} cases bitwise equal to the plain version")
    # the corpus's equal rows are neighbours, in different lanes, so on it
    # the sequential lane update keeps each lane's (score desc, row asc)
    # top-T, which a range split with an in-order merge also returns: the
    # stream serves the same rows either way
    qq, kw = args(256, 16, slab, slab_scale, columns[16], slab_date, 2, False)
    pv, pi = sk.fused_scan_plain(qq, **kw)
    s = (qq.float() @ slab.float().T) * kw["q_scale"][:, None] * slab_scale[None, :]
    s = torch.where(s >= kw["mins"][:, None], s, torch.full_like(s, -float("inf")))
    neg, order = torch.sort(-s.view(256, S // 128, 128), dim=1, stable=True)
    rows = order[:, :2] * 128 + torch.arange(128, device=dev)
    rows = torch.where(torch.isneginf(neg[:, :2]), torch.full_like(rows, -1), rows)
    if not torch.equal(pi, rows.reshape(256, -1).to(torch.int32)):
        raise AssertionError("the lane update and the (score, row) top-T differ on the slab")
    log("  on the B=256 slab the lane update equals each lane's (score desc, row asc) top-2")

    out = {}
    for name, T in (("fused_scan", 2), ("fused_scan_dp4a", 17)):
        qq, kw = args(256, 16, slab, slab_scale, columns[16], slab_date, T, False)
        reps = 20 if T <= 16 else 3
        dev, kernels = device_ms(torch, lambda: sk.fused_scan_cuda(qq, **kw), reps, name)
        call = cuda_ms(torch, lambda: sk.fused_scan_cuda(qq, **kw), reps)
        plain_ms = cuda_ms(torch, lambda: sk.fused_scan_plain(qq, **kw), 1)
        nbytes = S * D + S * 4 + 256 * (D + 12) + 256 * T * 128 * 8
        b_ms, b_by = bound(nbytes, 2.0 * 256 * S * D, INT8_OPS)
        out[name] = dict(
            name=name, route="cuda", source="trie_semantic_search_tpu_torch/csrc/fused_scan.cu",
            replaces="trie_semantic_search_tpu/ops/pallas_scan.py:393",
            max_abs_err=err["wgmma" if T <= 16 else "dp4a"], ms=dev, device_ms=dev, call_ms=call,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_kernels=kernels, shape=f"B=256 slab={S}x{D} T={T} (unfiltered timed)",
        )
    out["fused_scan"]["device_ms_by_T"] = {}
    for T in (3, 5):
        qq, kw = args(256, 16, slab, slab_scale, columns[16], slab_date, T, False)
        out["fused_scan"]["device_ms_by_T"][T] = device_ms(
            torch, lambda: sk.fused_scan_cuda(qq, **kw), 20, "fused_scan")[0]
    slab_t = slab.t()
    out["fused_scan"]["int_mm_ms"] = cuda_ms(torch, lambda: torch._int_mm(q8, slab_t), 20)
    report(out["fused_scan"])
    by_t = out["fused_scan"]["device_ms_by_T"]
    log(f"    device ms T=3 {by_t[3]:.4f}, T=5 {by_t[5]:.4f}; torch._int_mm of the same "
        f"[256, {D}] x [{D}, {S}] product {out['fused_scan']['int_mm_ms']:.4f} ms (events)")
    report(out["fused_scan_dp4a"])

    sk.reset_launch_counts()
    v, i = sk.fused_scan_topk(q8, qs, slab, slab_scale, columns[16], slab_date, tables[16], lo, hi, mins,
                              k=DP4A_K, tile_n=DP4A_TILE)
    torch.cuda.synchronize()
    launches = dict(sk.LAUNCHES)
    if launches["fused_scan_dp4a"] <= 0 or launches["fused_scan"]:
        raise AssertionError(f"fused_scan_topk at T=17 did not run the dp4a variant alone: {launches}")
    if not (v.shape == (256, DP4A_K) and torch.isfinite(v[:, 0]).any()):
        raise AssertionError("fused_scan_topk at T=17 returned no live row")
    out["fused_scan_dp4a"]["launches"] = launches["fused_scan_dp4a"]
    return out, launches


#: probe check cases: (name, B, filtered, how top_p / min_sim are changed)
PROBE_CASES = (("B=8", 8, False, None), ("B=64", 64, False, None), ("B=256", 256, False, None),
               ("B=64 court + date filters", 64, True, None),
               ("B=64 all queries share query 0's probe list", 64, True, "shared"),
               ("B=64 rows with a duplicated partition id", 64, True, "duplicate"),
               ("B=64 min_sim at each query's median live score", 64, False, "min_sim"))
#: the probe case that is timed (the filtered B=64 batch)
PROBE_TIMED = "B=64 court + date filters"


def kernel_phases(torch, np, fused, vi, report):
    """The probe and rescore kernels against their plain versions on the
    card at the main path's shapes (the probe bitwise in every case of
    ``PROBE_CASES``, the rescore within 1e-5 at B=8 and B=64); times kernel
    (device and call), plain version and bound."""
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
    from trie_semantic_search_tpu_torch.ops.hybrid import quantize_queries
    from trie_semantic_search_tpu_torch.ops.topk import exact_topk

    dev = vi.device
    ann = vi.ann
    P, m, D = ann.part_int8.shape
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((256, D), generator=g, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    V = fused.num_courts
    table = torch.rand((256, V), generator=g, device=dev) < 0.6
    lo = torch.full((256,), -(2**31), dtype=torch.int32, device=dev)
    hi = torch.full((256,), 2**31 - 1, dtype=torch.int32, device=dev)
    lo[::2], hi[::2] = 0, 15000
    mins = torch.full((256,), 0.0, device=dev)
    everything = dict(qwords=sk.pack_court_words(torch.ones_like(table)),
                      lo=torch.full_like(lo, -(2**31)), hi=torch.full_like(hi, 2**31 - 1),
                      mins=torch.full_like(mins, -1.0))
    filtered = dict(qwords=sk.pack_court_words(table), lo=lo, hi=hi, mins=mins)
    NP = int(ann.default_nprobe)
    _, top_all = exact_topk(q @ ann.centroids.T, NP)
    top_all = top_all.to(torch.int32)
    q8, qs = quantize_queries(q)
    pcw, pcb, pdt = fused._part_cols
    out = {}

    def probe_args(B, filt, top_p, mins_b=None):
        f = filtered if filt else everything
        return (q8[:B], qs[:B].reshape(B), top_p.contiguous(), ann.part_int8, ann.part_scale,
                ann.part_rows, pcw, pcb, pdt, f["qwords"][:B], f["lo"][:B], f["hi"][:B],
                f["mins"][:B] if mins_b is None else mins_b)

    def check_probe(what, args, want=None):
        """The kernel against ``want`` (default: the plain version on the
        same inputs), bitwise: values as int32 bits, and slots. Returns the
        plain values and the largest difference of the live ones."""
        kv, ks = sk.probe_candidates_cuda(*args)
        pv, ps = want if want is not None else sk.probe_candidates_plain(*args)
        torch.cuda.synchronize()
        kv, ks = kv.view(pv.shape), ks.view(ps.shape)
        bad = (kv.view(torch.int32) != pv.view(torch.int32)) | (ks != ps)
        if bad.any():
            raise AssertionError(f"probe kernel differs from plain ({what}): {int(bad.sum())} entries")
        fin = torch.isfinite(pv)
        return pv, float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0

    # 2. probe: every case of PROBE_CASES, timed by device time
    err, timed, by_case = 0.0, None, {}
    for what, B, filt, change in PROBE_CASES:
        top_p = top_all[:B].clone()
        mins_b, extra = None, ""
        if change == "shared":
            top_p[:] = top_p[0]
        elif change == "duplicate":
            top_p[3, 1] = top_p[3, 0]
            top_p[5, NP - 1] = top_p[5, 0]
            top_p[7, 2:6] = top_p[7, 2]
        elif change == "min_sim":
            pv, _ = sk.probe_candidates_plain(*probe_args(B, filt, top_p))
            live = torch.isfinite(pv)
            mins_b = torch.where(live, pv, torch.full_like(pv, float("nan"))).nanmedian(dim=1).values
            before = int(live.sum())
        args = probe_args(B, filt, top_p, mins_b)
        pv, e = check_probe(what, args)
        err = max(err, e)
        live = int(torch.isfinite(pv).sum())
        if change == "min_sim":
            if not 0 < live < before:
                raise AssertionError(f"min_sim left {live} of {before} live entries")
            extra = f", min_sim kept {live} of {before}"
        uniq = int(torch.unique(top_p).numel())
        by_case[what] = device_ms(torch, lambda: sk.probe_candidates_cuda(*args), 10, "probe_candidates")[0]
        log(f"  probe {what}: bitwise equal to the plain version ({uniq} distinct partitions, "
            f"{live} live entries{extra}); device {by_case[what]:.4f} ms")
        if what == PROBE_TIMED:
            timed = (B, args, uniq)

    # the most pairs the serving paths let through (B=3072 at nprobe 64):
    # 12 copies of the B=256 batch, each held against the B=256 plain result
    args = probe_args(256, False, top_all[:256])
    pv, ps = sk.probe_candidates_plain(*args)
    per_query = (0, 1, 2, 9, 10, 11, 12)
    big = tuple(a.repeat(12, *[1] * (a.dim() - 1)).contiguous() if i in per_query else a
                for i, a in enumerate(args))
    extra_cases = [("B=3072 (12 copies of the B=256 batch)", big,
                    (pv.expand(12, *pv.shape), ps.expand(12, *ps.shape)))]
    # rows of 80 bytes (one part-filled TMA box) and 400 bytes (four boxes,
    # the last part-filled, and three stages) over 256 partitions
    P2 = 256
    for D2 in (80, 400):
        cut = lambda a: (a[..., :D2] if D2 <= D else torch.cat([a, a[..., :D2 - D]], -1)).contiguous()  # noqa: E731
        a2 = (cut(q8[:64]), qs[:64].reshape(64), (top_all[:64] % P2).to(torch.int32).contiguous(),
              cut(ann.part_int8[:P2]), ann.part_scale[:P2], ann.part_rows[:P2], pcw[:P2], pcb[:P2],
              pdt[:P2], filtered["qwords"][:64], lo[:64], hi[:64], mins[:64])
        extra_cases.append((f"D={D2}, B=64 over {P2} partitions", a2, None))

    # 16,384 partitions of 128 slots (one sub-block each; the plan then
    # keeps its counts in device memory), D=32, random rows and probes
    g3 = torch.Generator(device=dev).manual_seed(12)
    P3, m3, D3 = 16384, 128, 32
    rows3 = torch.arange(P3 * m3, dtype=torch.int32, device=dev).reshape(P3, m3)
    a3 = (torch.randint(-127, 128, (64, D3), generator=g3, device=dev, dtype=torch.int8),
          qs[:64].reshape(64), torch.randint(0, P3, (64, NP), generator=g3, device=dev, dtype=torch.int32),
          torch.randint(-127, 128, (P3, m3, D3), generator=g3, device=dev, dtype=torch.int8),
          torch.rand((P3, m3), generator=g3, device=dev) * 0.01 + 1e-3, rows3,
          torch.zeros_like(rows3), torch.ones_like(rows3), torch.zeros_like(rows3),
          everything["qwords"][:64], everything["lo"][:64], everything["hi"][:64], everything["mins"][:64])
    extra_cases.append((f"P={P3} m={m3} D={D3}, B=64", a3, None))
    for what, a, want in extra_cases:
        err = max(err, check_probe(what, a, want)[1])
        log(f"  probe {what}: bitwise equal to the plain version")

    B, args, uniq = timed
    dev_t, kernels = device_ms(torch, lambda: sk.probe_candidates_cuda(*args), 20, "probe_candidates")
    call = cuda_ms(torch, lambda: sk.probe_candidates_cuda(*args), 20)
    plain_ms = cuda_ms(torch, lambda: sk.probe_candidates_plain(*args), 2)
    nbytes = uniq * m * (D + 4 * 5) + B * (D + 16 + 4 * NP) + B * NP * 256 * 8
    b_ms, b_by = bound(nbytes, 2.0 * B * NP * m * D, INT8_OPS)
    out["probe_candidates"] = dict(
        name="probe_candidates", route="cuda", source="trie_semantic_search_tpu_torch/csrc/probe.cu",
        replaces="trie_semantic_search_tpu/ops/pallas_scan.py:601", max_abs_err=err,
        ms=dev_t, device_ms=dev_t, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, device_kernels=kernels, device_ms_by_case=by_case,
        shape=f"B={B} nprobe={NP} block={m}x{D} unique_partitions={uniq} (court + date filters)",
    )
    report(out["probe_candidates"])

    # 3. gather rescore: B x C=512 candidates (the probe's), in the bf16
    # segments; rows drawn from the probed partitions, plus one row every
    # query asks for and the rows on both sides of the first segment's end
    C = K * serving_settings()[0] * 4
    seg0 = int(ann.corpus_bf16[0].shape[0])
    err = 0.0
    for B in (8, 64):
        slots = torch.randint(0, m, (B, C), generator=g, device=dev)
        idx = ann.part_rows[top_all[:B, torch.arange(C, device=dev) % NP].long(), slots].to(torch.int32)
        idx[:, 0] = idx[0, 1]
        if len(ann.corpus_bf16) > 1:
            idx[::2, 2], idx[::2, 3] = seg0 - 1, seg0
        idx = idx.contiguous()
        qb = q[:B].contiguous()
        kr = sk.gather_rescore_cuda(qb, ann.corpus_bf16, idx)
        pr = sk.gather_rescore_plain(qb, ann.corpus_bf16, idx)
        torch.cuda.synchronize()
        e = float((kr - pr).abs().max())
        if not e <= 1e-5:
            raise AssertionError(f"gather rescore differs from plain by {e} at B={B}")
        err = max(err, e)
        log(f"  rescore B={B} C={C}: within {e:.3g} of the plain version")
    dev_t, kernels = device_ms(torch, lambda: sk.gather_rescore_cuda(qb, ann.corpus_bf16, idx), 50,
                               "gather_rescore")
    call = cuda_ms(torch, lambda: sk.gather_rescore_cuda(qb, ann.corpus_bf16, idx), 50)
    plain_ms = cuda_ms(torch, lambda: sk.gather_rescore_plain(qb, ann.corpus_bf16, idx), 2)
    uniq = int(torch.unique(idx).numel())
    nbytes = uniq * D * 2 + B * D * 4 + B * C * 8
    b_ms, b_by = bound(nbytes, 2.0 * B * C * D, BF16_FLOPS)
    out["gather_rescore"] = dict(
        name="gather_rescore", route="cuda", source="trie_semantic_search_tpu_torch/csrc/gather_rescore.cu",
        replaces="trie_semantic_search_tpu/ops/pallas_scan.py:796", max_abs_err=err,
        ms=dev_t, device_ms=dev_t, call_ms=call, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, device_kernels=kernels,
        shape=f"B={B} C={C} D={D} segments={len(ann.corpus_bf16)} unique_rows={uniq}",
    )
    report(out["gather_rescore"])
    return out


#: small int8 top-k cases (B, D, N, k, share of scale-0 rows, duplicate
#: stride), drawn as the CPU tests draw theirs: k past one warp slot and
#: up to 128, ragged N, part query tiles, scale-0 rows with signed dots
#: (+-0 ties); a share of 1.0 leaves only row 0 a nonzero scale (see
#: :func:`int8_case`). D=48 runs the dp4a variant, every other D the wgmma
#: variant: at D=384 a ragged N (N % 128 != 0), B=100 (a part 128-query
#: tile), k=128, and duplicates every 61 and 127 rows (copies on both sides
#: of the 64-row steps and 128-row tiles); zero_rows=1.0 at D=32 and 64
INT8_CASES = (
    (8, 32, 2048, 8, 1.0, 0),
    (4, 32, 256, 8, 0.9, 0),
    (12, 32, 384, 33, 0.5, 7),
    (8, 32, 300, 12, 0.0, 11),
    (8, 48, 777, 128, 0.0, 9),
    (8, 48, 130, 128, 0.0, 0),
    (8, 32, 256, 40, 0.0, 0),
    (64, 384, 100_003, 128, 0.3, 13),
    (256, 384, 262_147, 32, 0.2, 0),
    (100, 384, 50_001, 32, 0.0, 61),
    (256, 384, 131_101, 128, 0.1, 127),
    (8, 64, 4096, 16, 1.0, 0),
    (100, 64, 5000, 32, 1.0, 0),
    (72, 64, 9000, 40, 0.2, 127),
    (256, 48, 20_011, 32, 0.2, 61),
)
#: the timed int8 top-k calls over the main path's corpus: (B, k)
INT8_TIMED = ((256, K), (256, 128), (64, K))


def int8_case(np, B, D, N, seed, zero_rows, dup_every):
    """Seeded int8 top-k inputs as the CPU tests draw them: ``(q8 [B, D],
    q_scale [B, 1], corpus [N, D], corpus_scale [N, 1])``."""
    rng = np.random.default_rng(seed)
    q8 = rng.integers(-127, 127, (B, D)).astype(np.int8)
    qs = (rng.random((B, 1)) * 0.01 + 1e-3).astype(np.float32)
    cq = rng.integers(-127, 127, (N, D)).astype(np.int8)
    cs = (rng.random((N, 1)) * 0.01 + 1e-3).astype(np.float32)
    if dup_every:  # exact duplicate rows: equal scores, the lower row first
        cq[dup_every::dup_every] = cq[0]
        cs[dup_every::dup_every] = cs[0]
    if zero_rows >= 1.0:
        # every score but row 0's is +0.0 or -0.0; query 0 dots positive
        # with rows 1-3 and negative with the rest, so its list ends in
        # -0.0 values (no +0.0 row after them); the other queries' zeros
        # read +0.0 from a +0.0 row in a later row range
        cs[1:] = 0.0
        qs[:] = np.abs(qs)
        dots = cq.astype(np.int32) @ q8[0].astype(np.int32)
        flip = np.where(np.arange(N) < 4, dots < 0, dots > 0)
        cq[flip & (np.arange(N) > 0)] *= -1
    elif zero_rows:
        cs[rng.random(N) < zero_rows] = 0.0
        qs[::2] *= -1
    return q8, qs, cq, cs


def int8_topk_phase(torch, np, vi, report) -> tuple[dict, dict, dict]:
    """The int8 top-k's two variants against their plain version, bitwise:
    first the small cases of ``INT8_CASES`` (each by the variant its shape
    picks), then over the main path's int8 blocks viewed flat (pad slots
    have scale 0) at B=256, k=32 (both variants), B=256, k=128 and B=64,
    k=32 (the wgmma variant); times each and ``torch._int_mm`` of the same
    int8 product in row chunks (a yardstick of the tensor-core products,
    not the same function). Then the paths, each with the launch counts set
    to 0 just before and read just after: the public op
    ``fused_int8_topk`` at B=256, k=32 (the wgmma variant) and at D=48 (the
    dp4a variant's own path). Returns both records and the two paths'
    launch counts."""
    from trie_semantic_search_tpu_torch.ops import fused_int8_topk
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
    from trie_semantic_search_tpu_torch.ops.hybrid import quantize_queries

    def bitwise(a, b):
        return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])

    def max_err(a, b):
        fin = torch.isfinite(b[0])
        return float((a[0] - b[0])[fin].abs().max()) if fin.any() else 0.0

    err = {"wgmma": 0.0, "dp4a": 0.0}
    ran = {"wgmma": 0, "dp4a": 0}
    for B, D, N, k, zero_rows, dup in INT8_CASES:
        data = int8_case(np, B, D, N, B + N + k, zero_rows, dup)
        q8, qs, cq, cs = (torch.from_numpy(a).to(vi.device) for a in data)
        args = (q8, qs.reshape(B), cq, cs.reshape(N), k)
        variant = sk.int8_topk_variant(D, k)
        got, want = sk.int8_topk_cuda(*args), sk.int8_topk_plain(*args)
        torch.cuda.synchronize()
        if not bitwise(got, want):
            bad = (got[0].view(torch.int32) != want[0].view(torch.int32)) | (got[1] != want[1])
            raise AssertionError(f"int8 top-k ({variant}) differs from plain at B={B} D={D} N={N} k={k} "
                                 f"zero_rows={zero_rows} dup={dup}: {int(bad.sum())} entries")
        err[variant] = max(err[variant], max_err(got, want))
        ran[variant] += 1
        zeros = want[0] == 0
        log(f"  int8_topk ({variant}) B={B} D={D} N={N} k={k} dup={dup}: bitwise equal "
            f"({int(zeros.sum())} zero scores, {int((zeros & torch.signbit(want[0])).sum())} of them -0.0)")
    if not (ran["wgmma"] and ran["dp4a"]):
        raise AssertionError(f"the small int8 top-k cases did not run both variants: {ran}")

    ann = vi.ann
    P, m, D = ann.part_int8.shape
    N = P * m
    g = torch.Generator(device=vi.device).manual_seed(13)
    q = torch.randn((256, D), generator=g, device=vi.device)
    q8, qs = quantize_queries(q / q.norm(dim=-1, keepdim=True))
    corpus, scale = ann.part_int8.view(N, D), ann.part_scale.view(N, 1)
    chunk = 1 << 18
    corpus_t = [corpus[lo : lo + chunk].t() for lo in range(0, N, chunk)]

    def int_mm(qq):
        for ct in corpus_t:
            torch._int_mm(qq, ct)

    recs, plain = {}, {}
    for B, k in INT8_TIMED:
        args = (q8[:B], qs[:B].reshape(B), corpus, scale.reshape(N), k)
        want = plain[(B, k)] = sk.int8_topk_plain(*args)
        for variant in ("wgmma", "dp4a") if (B, k) == (256, K) else ("wgmma",):
            name = "int8_topk" if variant == "wgmma" else "int8_topk_dp4a"
            got = sk.int8_topk_cuda(*args, variant=variant)
            torch.cuda.synchronize()
            if not bitwise(got, want):
                bad = (got[0].view(torch.int32) != want[0].view(torch.int32)) | (got[1] != want[1])
                raise AssertionError(f"int8 top-k ({variant}) differs from plain at B={B} k={k} over the "
                                     f"corpus: {int(bad.sum())} of {bad.numel()} entries")
            err[variant] = max(err[variant], max_err(got, want))
            fn = functools.partial(sk.int8_topk_cuda, *args, variant=variant)
            reps = 20 if variant == "wgmma" else 3
            dev, kernels = device_ms(torch, fn, reps, name)
            call = cuda_ms(torch, fn, reps)
            b_ms, b_by = bound(N * D + N * 4 + B * (D + 4) + B * k * 8, 2.0 * B * N * D, INT8_OPS)
            shape = f"B={B} k={k} N={N} D={D}"
            if (B, k) == (256, K):
                recs[name] = dict(
                    name=name, route="cuda", source="trie_semantic_search_tpu_torch/csrc/int8_topk.cu",
                    replaces="trie_semantic_search_tpu/ops/pallas_scan.py:160", device_ms=dev, ms=dev,
                    call_ms=call, bound_ms=b_ms, bound_by=b_by, library_ms=None, device_kernels=kernels,
                    shape=shape, bytes_per_s=(N * D + N * 4) / (dev * 1e-3),
                )
            else:
                recs["int8_topk"].setdefault("timed", {})[shape] = dict(
                    device_ms=dev, call_ms=call, bound_ms=b_ms, device_kernels=kernels)
                log(f"  int8_topk (wgmma) {shape}: bitwise equal; device {dev:.4f} ms call {call:.4f} ms "
                    f"bound {b_ms:.4f} ms ({b_by}); device kernels per call {kernels}")
        if (B, k) == (256, K):
            plain_ms = cuda_ms(torch, lambda: sk.int8_topk_plain(*args), 2)
            for name in ("int8_topk", "int8_topk_dp4a"):
                recs[name]["plain_ms"] = plain_ms
            recs["int8_topk"]["int_mm_ms"] = cuda_ms(torch, lambda: int_mm(q8), 5)
    for name, variant in (("int8_topk", "wgmma"), ("int8_topk_dp4a", "dp4a")):
        recs[name]["max_abs_err"] = err[variant]
    rec = recs["int8_topk"]
    log(f"  int8_topk (wgmma) at B=256 k={K}: {rec['bytes_per_s'] / 1e12:.3f} TB/s of corpus and scales; "
        f"torch._int_mm of the same int8 product in {len(corpus_t)} row chunks {rec['int_mm_ms']:.4f} ms "
        "(events; not the same function)")

    sk.reset_launch_counts()
    v, i = fused_int8_topk(q8, qs, corpus, scale, K)
    torch.cuda.synchronize()
    launches = dict(sk.LAUNCHES)
    if launches["int8_topk"] <= 0 or launches["int8_topk_dp4a"]:
        raise AssertionError(f"fused_int8_topk at D={D} did not run the wgmma variant alone: {launches}")
    if not bitwise((v, i), plain[(256, K)]):
        raise AssertionError("fused_int8_topk differs from the plain version")
    rec["launches"] = launches["int8_topk"]
    report(rec)

    B, D48, N48, k48 = 256, 48, 20_011, K
    data = int8_case(np, B, D48, N48, 48, 0.2, 61)
    q48, qs48, c48, cs48 = (torch.from_numpy(a).to(vi.device) for a in data)
    want = sk.int8_topk_plain(q48, qs48.reshape(B), c48, cs48.reshape(N48), k48)
    sk.reset_launch_counts()
    got = fused_int8_topk(q48, qs48, c48, cs48, k48)
    torch.cuda.synchronize()
    dp4a_launches = dict(sk.LAUNCHES)
    if dp4a_launches["int8_topk_dp4a"] <= 0 or dp4a_launches["int8_topk"]:
        raise AssertionError(f"fused_int8_topk at D=48 did not run the dp4a variant alone: {dp4a_launches}")
    if not bitwise(got, want):
        raise AssertionError("fused_int8_topk at D=48 differs from the plain version")
    recs["int8_topk_dp4a"]["launches"] = dp4a_launches["int8_topk_dp4a"]
    report(recs["int8_topk_dp4a"])
    return recs, launches, dp4a_launches


#: ablation builds of the int8 top-k's wgmma variant (TSS_INT8_TOPK_ABLATE
#: in csrc/int8_topk.cu), from the least of the kernel to all of it
INT8_ABLATIONS = ((6, "loads"), (5, "loads + products"), (8, "loads + products + hand-off stores"),
                  (7, "loads + products + hand-off barriers"),
                  (1, "loads + products + hand-off (stores and barriers), no list work"),
                  (3, "all but the inserts (scale, +0.0 rows, votes)"), (0, "the whole kernel"))


@contextlib.contextmanager
def using_library(sk, lib):
    """While open, the wrappers launch from ``lib`` (an ablation build)."""
    kept = sk._library
    sk._library = lib
    try:
        yield
    finally:
        sk._library = kept


def int8_ablation_phase(torch, vi) -> list[dict]:
    """The device time of each build of ``INT8_ABLATIONS`` at the timed case
    (B=256, k=32 over the main path's corpus, queries as in
    :func:`int8_topk_phase`), after half a second of the whole kernel, in
    turns: each build, then each again in reverse order. The whole kernel
    is held bitwise against its plain version first."""
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
    from trie_semantic_search_tpu_torch.ops.hybrid import quantize_queries

    builds = {a: sk.load_library((f"TSS_INT8_TOPK_ABLATE={a}",) if a else ()) for a, _ in INT8_ABLATIONS}
    ann = vi.ann
    P, m, D = ann.part_int8.shape
    N = P * m
    g = torch.Generator(device=vi.device).manual_seed(13)
    q = torch.randn((256, D), generator=g, device=vi.device)
    q8, qs = quantize_queries(q / q.norm(dim=-1, keepdim=True))
    args = (q8, qs.reshape(256), ann.part_int8.view(N, D), ann.part_scale.view(N), K)
    got, want = sk.int8_topk_cuda(*args), sk.int8_topk_plain(*args)
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(got[1], want[1])):
        raise AssertionError("int8 top-k differs from its plain version at the timed case")
    for _ in range(200):  # about half a second at full load, so the clocks are up after the builds
        sk.int8_topk_cuda(*args)
    torch.cuda.synchronize()
    times: dict = {a: [] for a, _ in INT8_ABLATIONS}
    order = [a for a, _ in INT8_ABLATIONS]
    for a in order + order[::-1]:
        with using_library(sk, builds[a]):
            times[a].append(device_ms(torch, lambda: sk.int8_topk_cuda(*args), 10, "int8_topk")[0])
    rows = []
    for a, what in INT8_ABLATIONS:
        rows.append(dict(ablate=a, what=what, device_ms=times[a]))
        log(f"  TSS_INT8_TOPK_ABLATE={a} ({what}): device ms {times[a][0]:.4f} / {times[a][1]:.4f}")
    return rows


#: phase A: rows of the subset built twice from fixed centroids, sampled
#: rows the tuner reads, fresh queries the recall is measured on
BUILD_SUBSET, TUNE_SAMPLE, RECALL_QUERIES = 1 << 19, 64, 256


@contextlib.contextmanager
def logged_records(name: str):
    """While open, the INFO records of logger ``name`` go to the list it
    yields (the ANN build logs its overflow and replica row counts)."""
    records: list = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = logging.getLogger(name)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


@contextlib.contextmanager
def kept_calls(sk, names):
    """While open, each call of the launchers ``names`` of ``sk`` (which
    still launch and count) keeps ``(name, inputs, a copy of the outputs)``
    in the list it yields."""
    calls: list = []
    orig = {n: getattr(sk, n) for n in names}

    def keeper(n):
        def call(*args):
            out = orig[n](*args)
            kept = tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()
            calls.append((n, args, kept))
            return out
        return call

    for n in names:
        setattr(sk, n, keeper(n))
    try:
        yield calls
    finally:
        for n, f in orig.items():
            setattr(sk, n, f)


def hold_against_plain(torch, sk, calls) -> dict:
    """Each kept probe call bitwise against ``probe_candidates_plain`` and
    each kept rescore call within 1e-5 of ``gather_rescore_plain``, on the
    same inputs. Returns the largest difference of each kernel (the probe's
    over its live entries)."""
    err = {"probe_candidates": 0.0, "gather_rescore": 0.0}
    for name, args, out in calls:
        if name == "probe_candidates_cuda":
            (kv, ks), (pv, ps) = out, sk.probe_candidates_plain(*args)
            bad = (kv.view(torch.int32) != pv.view(torch.int32)) | (ks != ps)
            if bad.any():
                raise AssertionError(f"probe kernel differs from plain on the built index: "
                                     f"{int(bad.sum())} entries")
            fin = torch.isfinite(pv)
            e = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
            err["probe_candidates"] = max(err["probe_candidates"], e)
        else:
            e = float((out - sk.gather_rescore_plain(*args)).abs().max())
            if not e <= 1e-5:
                raise AssertionError(f"gather rescore differs from plain by {e} on the built index")
            err["gather_rescore"] = max(err["gather_rescore"], e)
    return err


def ann_build_phase(torch, np, seed: int, work: Path) -> tuple[dict, dict]:
    """Phase A, the ANN build at the served size: the 5,242,880 corpus rows
    of :func:`corpus_slabs` (drawn on the card from ``seed``, in generation
    order, copied to the host) through ``PartitionedANN(AnnConfig(),
    device="cuda").build``: k-means and the top-c assignment on the card,
    the layout on the host. Checks the card's assignment against the CPU's
    on one block (equal but for near-ties), that a build from fixed
    centroids is bitwise reproducible, that ``tune_nprobe`` picks an nprobe
    under P at which the probe and rescore kernels reach tie-aware
    recall@10 >= 0.95 against ``search_brute`` on fresh queries, and that
    ``save_dir`` / ``load_dir`` serve bitwise the same. Returns the details
    and the launch counts of that recall search."""
    from trie_semantic_search_tpu_torch.core.config import AnnConfig
    from trie_semantic_search_tpu_torch.index import kmeans as km
    from trie_semantic_search_tpu_torch.index.ann import PartitionedANN
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk

    dev = torch.device("cuda")
    N = P_PARTS * M_SLOTS
    out: dict = {}
    t0 = time.perf_counter()
    host = np.empty((N, DIM), np.float32)
    for p0, _, v in corpus_slabs(torch, P_PARTS, M_SLOTS, DIM, seed, dev):
        rows = v.reshape(-1, DIM)
        host[p0 * M_SLOTS : p0 * M_SLOTS + rows.shape[0]] = rows.cpu().numpy()
    out["draw_s"] = time.perf_counter() - t0
    log(f"  {N} x {DIM} f32 rows drawn on the card and copied to the host in {out['draw_s']:.1f} s")

    ann = PartitionedANN(AnnConfig(), device=dev)
    t0 = time.perf_counter()
    with logged_records("tss_torch.ann") as records:
        ann.build(host, seed)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["stages_s"] = dict(ann.build_seconds)
    moved = [r.args[0] for r in records if r.msg.startswith("partition overflow")]
    out["overflow_rows"] = moved[0] if moved else 0
    out["replica_rows"] = int((ann.part_rows >= 0).sum()) - N
    P, m = (int(x) for x in ann.part_rows.shape)
    out["partitions"], out["capacity"], out["bytes"] = P, m, ann.get_stats().nbytes_total
    if P != P_PARTS:
        raise AssertionError(f"_auto_partitions gave P={P}, expected {P_PARTS}")
    log(f"  build {out['build_s']:.1f} s: " + ", ".join(f"{k} {v:.2f} s" for k, v in out["stages_s"].items()))
    log(f"  P={P} m={m}; {out['overflow_rows']} rows moved by the overflow rebalance, "
        f"{out['replica_rows']} pad replicas; index {out['bytes'] / 2**30:.2f} GiB on the card")

    # the card's top-c column 0 against the CPU's nearest centroid, one block
    cents = ann.centroids.cpu().numpy()
    blk = host[: km._LLOYD_BLOCK]
    blk = blk / np.maximum(np.linalg.norm(blk, axis=1, keepdims=True), 1e-12)
    card = km.assign_topc(blk, cents, 8, device=dev)[:, 0]
    cpu = km.assign_clusters(blk, cents, device="cpu")
    top2 = torch.topk(torch.from_numpy(blk) @ torch.from_numpy(cents).T, 2, dim=1).values
    near = ((top2[:, 0] - top2[:, 1]) <= 1e-5).numpy()
    differ = card != cpu
    if (differ & ~near).any():
        raise AssertionError(f"card and CPU assignments differ on {int((differ & ~near).sum())} rows "
                             "whose top-two centroid scores are more than 1e-5 apart")
    out["assign_block_differ"], out["assign_block_near_ties"] = int(differ.sum()), int(near.sum())
    log(f"  assign_topc column 0, card vs CPU on {len(blk)} rows: {int(differ.sum())} differ, all "
        f"among the {int(near.sum())} rows whose top-two scores lie within 1e-5")

    # a copy of the block's most chosen centroid as the last column (the
    # GEMM's tail): assignment, top-c and the Lloyd steps' pick tie it to
    # the lower id on the card, and agree with the assignment without the
    # copy but for near-ties (one more column may change the GEMM)
    j = int(np.bincount(card).argmax())
    dup = np.concatenate([cents, cents[j : j + 1]])
    first = km.assign_clusters(blk, dup, device=dev)
    topc = km.assign_topc(blk, dup, 3, device=dev)
    dup_t = torch.from_numpy(dup).to(dev)
    lloyd = km._nearest(torch.from_numpy(blk).to(dev), dup_t, km._first_copy(dup_t)).cpu().numpy()
    at_j, at_copy = topc == j, topc == P
    if not (np.array_equal(first, topc[:, 0]) and np.array_equal(lloyd, first)
            and not ((first != card) & ~near).any() and not at_copy[:, 0].any()
            and np.array_equal(at_copy[:, 1:], at_j[:, :-1]) and at_j[:, 0].any()):
        raise AssertionError(f"a duplicate of centroid {j} as id {P} does not tie to the lower id on the card")
    out["duplicate_centroid_rows"] = int(at_j[:, 0].sum())
    log(f"  centroid {j} copied as id {P}: assign_clusters, assign_topc and the Lloyd steps' pick on the "
        f"card keep id {j} on its {out['duplicate_centroid_rows']} rows, the copy right behind it in "
        "every top-3")

    # fixed centroids: a subset (every tenth row, so it spans every
    # cluster) built twice, bitwise the same
    builds = []
    sub = host[:: N // BUILD_SUBSET]
    for _ in range(2):
        a = PartitionedANN(AnnConfig(), device=dev)
        t0 = time.perf_counter()
        a.build(sub, reuse_centroids=cents)
        torch.cuda.synchronize()
        builds.append((a, time.perf_counter() - t0))
    (a, ta), (b, tb) = builds
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t  # noqa: E731
    pairs = [(a.part_rows, b.part_rows), (a.part_int8, b.part_int8), (a.part_scale.view(torch.int32),
             b.part_scale.view(torch.int32)), *zip(map(bits, a.corpus_bf16), map(bits, b.corpus_bf16))]
    if len(a.corpus_bf16) != len(b.corpus_bf16) or not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError("two builds from the same centroids differ")
    out["subset_build_s"] = [ta, tb]
    log(f"  {len(sub)} rows (every {N // BUILD_SUBSET}th) from fixed centroids, built twice "
        f"({ta:.2f} s, {tb:.2f} s): bitwise equal")
    del builds, a, b, sub

    # tune, then recall through the kernels on fresh queries
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    nprobe = ann.tune_nprobe(host[rng.choice(N, TUNE_SAMPLE, replace=False)], k=10, target_recall=0.95)
    out["tune_s"], out["nprobe"] = time.perf_counter() - t0, nprobe
    if not nprobe < P:
        raise AssertionError(f"tune_nprobe picked nprobe={nprobe}, not under P={P}")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    noise = 0.1 * torch.randn((RECALL_QUERIES, DIM), generator=g, device=dev) / DIM**0.5
    q = host[rng.choice(N, RECALL_QUERIES, replace=False)] + noise.cpu().numpy()
    ov, _ = ann.search_brute(q, 10)
    thresh = ov[:, 9:10] - 1e-5
    with kept_calls(sk, ("probe_candidates_cuda", "gather_rescore_cuda")) as calls:
        sk.reset_launch_counts()
        gv, gi = ann.search(q, 10, nprobe=nprobe)
        torch.cuda.synchronize()
        launches = dict(sk.LAUNCHES)
        if launches["probe_candidates"] <= 0 or launches["gather_rescore"] <= 0:
            raise AssertionError(f"the recall search did not run the probe and rescore kernels: {launches}")
        out["recall_at_10"] = float(np.mean(gv >= thresh))
        out["recall_at_10_nprobe64"] = float(np.mean(ann.search(q, 10, nprobe=64)[0] >= thresh))
    if out["recall_at_10"] < 0.95:
        raise AssertionError(f"recall@10 {out['recall_at_10']} < 0.95 at the tuned nprobe {nprobe}")
    log(f"  tune_nprobe on {TUNE_SAMPLE} rows picked nprobe={nprobe} in {out['tune_s']:.1f} s; on "
        f"{RECALL_QUERIES} fresh queries tie-aware recall@10 vs search_brute {out['recall_at_10']:.4f} "
        f"(nprobe 64: {out['recall_at_10_nprobe64']:.4f}); launches {launches}")

    # both searches' kernel calls against the plain versions on the same
    # inputs: the build's layout (m past eight sub-blocks, pad slots, pad
    # replicas), nprobe as tuned and 64
    names = [n for n, _, _ in calls]
    if names.count("probe_candidates_cuda") != 2 or names.count("gather_rescore_cuda") != 2:
        raise AssertionError(f"expected two probe and two rescore launches, kept {names}")
    out["plain_err"] = hold_against_plain(torch, sk, calls)
    pad = int((ann.part_rows < 0).sum())
    log(f"  on the built index (m={m}: {m // 128} sub-blocks, {pad} pad slots, {out['replica_rows']} "
        f"replicas) at nprobe {nprobe} and 64: probe bitwise equal to its plain version, rescore within "
        f"{out['plain_err']['gather_rescore']:.3g} of its plain version")
    del calls

    # the raw .npy directory artifact serves bitwise the same
    t0 = time.perf_counter()
    ann.save_dir(work / "ann.mmap")
    out["save_dir_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = PartitionedANN.load_dir(work / "ann.mmap", device=dev)
    torch.cuda.synchronize()
    out["load_dir_s"] = time.perf_counter() - t0
    bv, bi = back.search(q, 10, nprobe=nprobe)
    if not (np.array_equal(bv.view(np.int32), gv.view(np.int32)) and np.array_equal(bi, gi)):
        raise AssertionError("the index loaded from save_dir serves other results")
    log(f"  save_dir {out['save_dir_s']:.1f} s, load_dir {out['load_dir_s']:.1f} s: bitwise the same "
        "search results")
    del ann, back, host
    shutil.rmtree(work / "ann.mmap")
    torch.cuda.empty_cache()
    return out, launches


#: phase B: cases in the store the pipeline builds from, and of them named
PIPE_CASES, PIPE_NAMES = 32_768, 4096


def pipeline_phase(torch, np, seed: int, work: Path) -> dict:
    """Phase B, the build pipeline through the entry points a user calls:
    a sqlite store of ``PIPE_CASES`` fixture cases (four sentences each),
    ``build_indexes(storage, cfg, device="cuda")`` with mean pooling and no
    embedder (a corpus vocab and the seeded MiniLM-L6 at full width),
    ``save_artifacts``, ``load_artifacts(cfg, device="cuda")``, then
    ``SearchEngine.search_batch`` at B=8 and 64 over the loaded artifacts,
    which must return what an engine over the in-memory indexes returns,
    with name queries led by a case-name or exact hit."""
    from trie_semantic_search_tpu_torch.core.config import Config
    from trie_semantic_search_tpu_torch.core.types import CaseMetadata, SearchConfig
    from trie_semantic_search_tpu_torch.index.builder import build_indexes, load_artifacts, save_artifacts
    from trie_semantic_search_tpu_torch.search.engine import MatchType, SearchEngine, SearchQuery
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    cfg = Config()
    cfg.storage.db_path = str(work / "pipeline.sqlite")
    cfg.trie.index_path = str(work / "trie")
    cfg.vector.hnsw.index_path = str(work / "vec")
    cfg.vector.pooling = "mean"
    out: dict = {}
    t0 = time.perf_counter()
    write_cases_fast(cfg.storage.db_path,
                     fixture_cases(np, CaseMetadata, range(PIPE_CASES), PIPE_CASES, PIPE_NAMES, seed))
    out["store_s"] = time.perf_counter() - t0
    storage = StorageManager(cfg.storage)
    built = build_indexes(storage, cfg, device="cuda")
    torch.cuda.synchronize()
    r = built.report
    chunks = built.vector.ann.num_vectors
    if (r.cases, r.content_chunks, chunks) != (PIPE_CASES, CHUNKS_PER_CASE * PIPE_CASES, r.content_chunks):
        raise AssertionError(f"built {r.cases} cases, {r.content_chunks} chunks, ANN of {chunks}")
    ann_s = sum(built.vector.ann.build_seconds.values())
    out.update(build_s=r.seconds, vocab_s=r.vocab_seconds, embed_s=r.embed_seconds,
               text_and_trie_s=r.seconds - r.vocab_seconds - r.embed_seconds - r.freeze_seconds,
               trie_freeze_s=r.freeze_seconds - ann_s, ann_build_s=ann_s,
               ann_stages_s=dict(built.vector.ann.build_seconds), chunks=chunks,
               chunks_per_s=chunks / r.embed_seconds, partitions=int(built.vector.ann.part_rows.shape[0]),
               capacity=int(built.vector.ann.part_rows.shape[1]))
    log(f"  store of {PIPE_CASES} cases {out['store_s']:.1f} s; build_indexes {r.seconds:.1f} s = vocab "
        f"{r.vocab_seconds:.1f} + text processing and trie inserts {out['text_and_trie_s']:.1f} + embed "
        f"{r.embed_seconds:.1f} ({out['chunks_per_s']:.0f} chunks/s) + trie freeze "
        f"{out['trie_freeze_s']:.1f} + ANN build {ann_s:.1f} (P={out['partitions']} m={out['capacity']})")
    t0 = time.perf_counter()
    save_artifacts(built, cfg)
    out["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_artifacts(cfg, device="cuda")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    log(f"  save_artifacts {out['save_s']:.1f} s, load_artifacts {out['load_s']:.1f} s")

    in_memory = SearchEngine(cfg, storage, built.trie, built.vector, built.columns, device="cuda")
    from_disk = SearchEngine(cfg, storage, *loaded, device="cuda")
    names = case_names(np, PIPE_CASES, PIPE_NAMES, seed)
    rng = np.random.default_rng(seed + 3)
    for B in (8, 64):
        texts = texts_for(rng, names, WORDS, B)
        qs = [SearchQuery(query=t, config=SearchConfig(min_similarity=-1.0)) for t in texts]
        t0 = time.perf_counter()
        got = from_disk.search_batch(qs)
        out[f"search_B{B}_ms"] = (time.perf_counter() - t0) * 1e3
        want = in_memory.search_batch(qs)
        if [[x.to_json() for x in rs] for rs in got] != [[x.to_json() for x in rs] for rs in want]:
            raise AssertionError(f"B={B}: the loaded artifacts serve other results than the built ones")
        n = check_results(MatchType, set(names.values()), qs, got)
        log(f"  search_batch B={B} over the loaded artifacts: {n} results, equal to the in-memory "
            f"engine's, {out[f'search_B{B}_ms']:.1f} ms")
    storage.close()
    del in_memory, from_disk, loaded, built
    torch.cuda.empty_cache()
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
        # the device-side events themselves (kernels, copies, memsets): an
        # operator's device time repeats theirs, so only these are summed
        on_dev = [e for e in events if on_device(e)]
        device_ms = sum(dev_us(e) for e in on_dev) / 1e3
        top = sorted(on_dev, key=dev_us, reverse=True)[:8]
        (out_dir / f"profile_B{B}.txt").write_text(
            events.table(sort_by="self_cuda_time_total", row_limit=25)
        )
        kernel_ms = {k: sum(dev_us(e) for e in on_dev if any(f in e.key for f in KERNEL_SYMBOLS[k])) / 1e3
                     for k in SERVING_KERNELS}
        scan_ms = kernel_ms["fused_scan"]
        rows.append(dict(B=B, mode=rec["mode"], wall_ms=wall_ms, device_ms=device_ms,
                         busy_share=device_ms / wall_ms, kernel_ms=kernel_ms, fused_scan_ms=scan_ms,
                         fused_scan_share=scan_ms / device_ms if device_ms else 0.0,
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


#: batch sizes the engine's warmup covers
WARM_SIZES = (8, 64)
#: the engine's batches: (path, B, filtered); B=8 on the staged path
#: probes, B=64 there scans exactly (the vector index's rule)
ENGINE_PLAN = (("fused", 8, False), ("fused", 64, False), ("fused", 256, False),
               ("fused", 64, True), ("staged", 8, False), ("staged", 64, True))


def check_results(MatchType, names: set, qs, res) -> int:
    """Every result hydrated, with a snippet, in score order and inside its
    filters; unfiltered queries fill their limit; a name query has a
    case-name or exact hit first and finds its case. Returns the count."""
    if len(res) != len(qs):
        raise AssertionError(f"{len(res)} result lists for {len(qs)} queries")
    n = 0
    for q, rs in zip(qs, res):
        scores = [r.score for r in rs]
        if not all(map(math.isfinite, scores)) or scores != sorted(scores, reverse=True):
            raise AssertionError(f"{q.query!r}: scores not finite and descending: {scores}")
        if q.court_filter is None and q.date_range is None and len(rs) != q.config.max_results:
            raise AssertionError(f"{q.query!r}: {len(rs)} results, limit {q.config.max_results}")
        for r in rs:
            m = r.case_metadata
            if m is None or not m.name or not r.snippet:
                raise AssertionError(f"{q.query!r}: a result without metadata or snippet")
            if q.court_filter and m.court not in q.court_filter:
                raise AssertionError(f"{q.query!r}: court {m.court!r} outside {q.court_filter}")
            if q.date_range and not q.date_range[0] <= m.decision_date <= q.date_range[1]:
                raise AssertionError(f"{q.query!r}: date {m.decision_date} outside {q.date_range}")
        if q.query in names and q.court_filter is None and q.date_range is None:
            if rs[0].match_type not in (MatchType.CASE_NAME, MatchType.EXACT):
                raise AssertionError(f"name query {q.query!r} led by a {rs[0].match_type} hit")
            if not any(r.case_metadata.name == q.query for r in rs):
                raise AssertionError(f"name query {q.query!r} missed its case")
        n += len(rs)
    return n


def engine_phase(torch, np, fused, vi, names, db_path: str, seed: int):
    """The entry point users call: ``SearchEngine`` over the same state,
    hydrating from the sqlite store. Warmup at ``WARM_SIZES`` (must leave
    ``is_warm``), the batches of ``ENGINE_PLAN``, then the first batch again, which the query cache
    must serve without a launch. Returns the warmup seconds, per-batch
    records and the launch counts of exactly these batches."""
    from trie_semantic_search_tpu_torch.core.config import Config
    from trie_semantic_search_tpu_torch.core.metrics import metrics
    from trie_semantic_search_tpu_torch.core.types import SearchConfig
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
    from trie_semantic_search_tpu_torch.search.engine import MatchType, SearchEngine, SearchQuery
    from trie_semantic_search_tpu_torch.storage.columns import date_to_int
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    sync = torch.cuda.synchronize if vi.device.type == "cuda" else (lambda: None)
    cols = fused.columns
    config = Config()
    config.storage.db_path = db_path
    storage = StorageManager(config.storage)
    if storage.get_stats().total_cases != len(cols):
        raise AssertionError(f"store holds {storage.get_stats().total_cases} cases, columns {len(cols)}")
    rng = np.random.default_rng(seed + 2)
    sample = rng.choice(len(cols), min(512, len(cols)), replace=False)
    got = storage.get_case_metadata_many([cols.case_ids[r] for r in sample])
    for r in sample:
        meta = got[str(cols.case_ids[r])]
        if meta.court != COURTS[cols.court_ids[r]] or date_to_int(meta.decision_date) != cols.dates[r]:
            raise AssertionError(f"store and columns disagree on case row {r}")

    engine = SearchEngine(config, storage, fused.trie_index, vi, cols, device=vi.device)
    t0 = time.perf_counter()
    engine.warmup(batch_sizes=WARM_SIZES)
    warm_s = time.perf_counter() - t0
    if not engine.is_warm:
        raise AssertionError("SearchEngine.warmup left is_warm False: a warmup batch failed")

    def queries(B, filtered):
        out = []
        for i, text in enumerate(texts_for(rng, names, WORDS, B)):
            cf = [COURTS[1 + i % 15], COURTS[2 + (i + 3) % 14]] if filtered and i % 2 == 0 else None
            dr = (dt.date(1960, 1, 1), dt.date(1990, 12, 31)) if filtered and i % 3 != 1 else None
            # every semantic hit passes: the seeded encoder's cosines to the
            # synthetic corpus lie near 0, under the default 0.5
            out.append(SearchQuery(query=text, court_filter=cf, date_range=dr,
                                   config=SearchConfig(min_similarity=-1.0)))
        return out

    batches = [(path, B, filtered, queries(B, filtered)) for path, B, filtered in ENGINE_PLAN]
    name_set = set(names.values())
    records = []
    sk.reset_launch_counts()
    for path, B, filtered, qs in batches:
        engine.config.search.use_fused_device_path = path == "fused"
        split0 = {n: metrics.histogram(n).total_ms for n in ("fused_embed", "fused_device")}
        before = dict(sk.LAUNCHES)
        sync()
        t0 = time.perf_counter()
        res = engine.search_batch(qs)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        split = {n: metrics.histogram(n).total_ms - v for n, v in split0.items()}
        records.append(dict(
            path=path, B=B, filtered=filtered, wall_ms=wall,
            embed_ms=split["fused_embed"] if path == "fused" else None,
            device_ms=split["fused_device"] if path == "fused" else None,
            results=check_results(MatchType, name_set, qs, res),
            launches={k: v - before[k] for k, v in sk.LAUNCHES.items()},
            json=[[r.to_json() for r in rs] for rs in res],
        ))
    engine.config.search.use_fused_device_path = True
    hits, before = engine.query_cache.get_stats().hits, dict(sk.LAUNCHES)
    path, B, filtered, qs = batches[0]
    t0 = time.perf_counter()
    again = engine.search_batch(qs)
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(sk.LAUNCHES)
    if engine.query_cache.get_stats().hits - hits != B or launches != before:
        raise AssertionError("the repeated batch was not served from the query cache")
    if [[r.to_json() for r in rs] for rs in again] != records[0]["json"]:
        raise AssertionError("the cached batch differs from the first")
    records.append(dict(path="cache", B=B, filtered=filtered, wall_ms=wall, embed_ms=None,
                        device_ms=None, results=sum(map(len, again)), launches={}, json=None))
    engine.health_check()
    stats = engine.get_stats()
    storage.close()
    for rec in records:
        del rec["json"]
    return warm_s, records, launches, stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["kernels", "int8-ablations"],
                    help="kernels: the device, kernel build, small-reference and kernel phases "
                         "only (no index builds, serving, profile, store or engine); "
                         "int8-ablations: the device time of each ablation build of the int8 "
                         "top-k's wgmma variant at its timed case")
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

    if args.only:
        return run(torch, np, sk, args.seed, "", None, only=args.only)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        db_path = str(Path(tmp) / "cases.sqlite")
        n_cases = P_PARTS * M_SLOTS // CHUNKS_PER_CASE
        store = multiprocessing.get_context("spawn").Process(
            target=build_store, args=(db_path, n_cases, N_NAMES, args.seed))
        store.start()
        try:
            return run(torch, np, sk, args.seed, db_path, store)
        finally:
            if store.is_alive():
                store.terminate()
            store.join()


def run(torch, np, sk, seed: int, db_path: str, store, only: str | None = None) -> int:
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
    detail["small_reference_max_score_diff"] = small_reference(torch, np, seed)
    log(f"  agree; max score difference {detail['small_reference_max_score_diff']:.3g}")

    log(f"phase: build state on the card (P={P_PARTS} m={M_SLOTS} D={DIM})")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    fused, vi, names, words, courts = build_search(
        torch, np, dev, P_PARTS, M_SLOTS, DIM, seed, N_NAMES, 64
    )
    if fused.ann_mode != "partitioned":
        raise AssertionError(f"auto mode picked {fused.ann_mode} at {vi.ann.num_vectors} chunks")
    torch.cuda.synchronize()
    detail["build_state_s"] = time.perf_counter() - t0
    log(f"  {vi.ann.num_vectors} chunks, mode {fused.ann_mode}, nprobe {vi.ann.default_nprobe}, "
        f"{len(vi.ann.corpus_bf16)} rescore segments, {detail['build_state_s']:.1f} s")
    out_dir = Path.cwd() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if only == "int8-ablations":
        log(f"phase: int8 top-k ablation builds at B=256 k={K} (device ms, two turns)")
        detail["int8_ablations"] = int8_ablation_phase(torch, vi)
        return finish(torch, detail, {}, {}, out_dir, card, t_start)

    def report(r):
        log(f"  {r['name']}: {r['shape']} max_abs_err={r['max_abs_err']:.3g} device {r['device_ms']:.4f} ms "
            f"call {r['call_ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); device kernels per call {r['device_kernels']}")

    log("phase: fused scan vs plain (both variants), then the dp4a variant's path fused_scan_topk "
        "at T=17 (counts reset just before)")
    kernels, dp4a_launches = fused_scan_phase(torch, np, fused, vi, report)
    log(f"  launches on the fused_scan_topk T=17 path: {dp4a_launches}")
    log("phase: probe and rescore kernels vs plain versions at the main path's shapes")
    kernels.update(kernel_phases(torch, np, fused, vi, report))
    log("phase: int8 top-k (both variants) vs plain, then its paths fused_int8_topk at D=384 and "
        "D=48 (counts reset just before each)")
    i8recs, i8launches, i8dp4a_launches = int8_topk_phase(torch, np, vi, report)
    kernels.update(i8recs)
    log(f"  launches on the fused_int8_topk path: {i8launches}; at D=48: {i8dp4a_launches}")
    paths = {"fused_int8_topk": i8launches, "fused_int8_topk D=48": i8dp4a_launches,
             "fused_scan_topk T=17": dp4a_launches}
    if only == "kernels":
        for k in SERVING_KERNELS:
            kernels[k]["launches"] = None
        return finish(torch, detail, kernels, paths, out_dir, card, t_start)

    work = Path(db_path).parent
    log(f"phase: build: ANN at full size ({P_PARTS * M_SLOTS} rows, D={DIM}; counts reset just "
        "before the recall search, read just after)")
    detail["build_ann"], paths["build"] = ann_build_phase(torch, np, seed, work)
    for k, e in detail["build_ann"]["plain_err"].items():
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], e)
    log("phase: build: pipeline end to end (build_indexes -> save_artifacts -> load_artifacts "
        "-> SearchEngine)")
    detail["build_pipeline"] = pipeline_phase(torch, np, seed, work)

    log("phase: serve through query_batch (counts reset just before, read just after)")
    records, launches = serve(torch, np, fused, vi, names, words, courts, seed)
    log(f"  launches on the query_batch path: {launches}")
    missing = [k for k in SERVING_KERNELS if launches[k] <= 0]
    if missing or launches["fused_scan_dp4a"]:
        raise AssertionError(f"kernels not launched on the query_batch path: {missing}, or the "
                             f"dp4a fused scan launched: {launches}")
    for k in SERVING_KERNELS:
        kernels[k]["launches"] = launches[k]

    log("phase: checks and recall@10 vs the exact stream")
    from trie_semantic_search_tpu_torch.ops.topk import exact_topk

    detail["batches"] = []
    uniq_kernel_phase = kernels["probe_candidates"]["shape"].split("unique_partitions=")[1].split()[0]
    for rec in records:
        r10 = check_and_recall(np, fused, rec)
        row = dict(B=rec["B"], filtered=rec["filtered"], mode=rec["mode"],
                   encode_ms=rec["encode_ms"], query_ms=rec["query_ms"], recall_at_10=r10)
        probed = ""
        if rec["mode"] == "probe":
            # the partitions the batch's queries probe (as query_batch picks them)
            qt = torch.as_tensor(rec["q"], dtype=torch.float32, device=dev)
            _, top_p = exact_topk(qt @ vi.ann.centroids.T, int(vi.ann.default_nprobe))
            row["distinct_partitions"] = int(torch.unique(top_p).numel())
            probed = (f" distinct partitions probed {row['distinct_partitions']} of {top_p.numel()} "
                      f"(kernel phase B=64: {uniq_kernel_phase})")
        detail["batches"].append(row)
        log(f"  B={rec['B']} {rec['mode']} filtered={rec['filtered']}: encode ms {rec['encode_ms']} "
            f"query ms {rec['query_ms']} recall@10 vs exact {r10:.4f}{probed}")
    detail["escalated"] = fused.escalated
    log("phase: profile (device time by kernel)")
    detail["profile"] = profile_batches(torch, fused, vi, records, out_dir)
    for row in detail["profile"]:
        log(f"  B={row['B']} {row['mode']}: wall {row['wall_ms']:.2f} ms, device "
            f"{row['device_ms']:.2f} ms (busy {row['busy_share']:.3f}); fused scan "
            f"{row['fused_scan_ms']:.3f} ms ({row['fused_scan_share']:.3f} of device time); "
            f"serving kernels' device ms {row['kernel_ms']}")
        for name, ms, count in row["top"]:
            log(f"    {ms:9.3f} ms  x{count:<5} {name}")

    log("phase: case store (written in a child process, one transaction per batch)")
    t0 = time.perf_counter()
    store.join()
    if store.exitcode != 0:
        raise AssertionError(f"the store build failed with exit code {store.exitcode}")
    st = json.loads(Path(db_path + ".json").read_text())
    detail["store_build_s"], detail["store_cases_batch_s"] = st["fast_s"], st["store_cases_batch_s"]
    n_cases = len(fused.columns)
    log(f"  {n_cases} cases in {st['fast_s']:.1f} s (waited {time.perf_counter() - t0:.1f} s for it "
        f"here); its rows equal store_cases_batch's on {STORE_CHECK_CASES} cases; store_cases_batch "
        f"(a commit per row) wrote {STORE_TIMED_CASES} cases in {st['store_cases_batch_s']:.2f} s, "
        f"{st['store_cases_batch_s'] / STORE_TIMED_CASES * n_cases:.0f} s at {n_cases} cases")

    log("phase: SearchEngine (counts reset just before the batches, read just after)")
    warm_s, erecs, elaunches, stats = engine_phase(torch, np, fused, vi, names, db_path, seed)
    log(f"  warmup(batch_sizes={WARM_SIZES}) {warm_s:.1f} s, is_warm True")
    for r in erecs:
        split = "" if r["embed_ms"] is None else (
            f" = embed {r['embed_ms']:.2f} + device step {r['device_ms']:.2f} + hydration and "
            f"snippets {r['wall_ms'] - r['embed_ms'] - r['device_ms']:.2f}")
        log(f"  {r['path']} B={r['B']} filtered={r['filtered']}: {r['wall_ms']:.2f} ms{split}; "
            f"{r['results']} results; launches {r['launches']}")
    log(f"  launches on the SearchEngine path: {elaunches}; queries served {stats.queries_served}, "
        f"cache hits {stats.cache_stats.hits}, escalated {stats.escalated_queries}")
    missing = [k for k in SERVING_KERNELS if elaunches[k] <= 0]
    if missing or elaunches["fused_scan_dp4a"]:
        raise AssertionError(f"kernels not launched on the SearchEngine path: {missing}, or the "
                             f"dp4a fused scan launched: {elaunches}")
    detail["engine"] = dict(warmup_s=warm_s, batches=erecs)
    paths = {"query_batch": launches, "SearchEngine": elaunches, **paths}
    return finish(torch, detail, kernels, paths, out_dir, card, t_start)


def finish(torch, detail, kernels, paths, out_dir: Path, card: str, t_start: float) -> int:
    """Write the details and print the kernel line and the last line."""
    for n, rec in kernels.items():
        rec["launches_by_path"] = {p: counts[n] for p, counts in paths.items()}
    detail["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    detail["kernels"] = kernels
    detail["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    log(f"peak memory {detail['peak_mem_gb']:.1f} GiB; {detail['seconds']:.1f} s")
    log(f"gpu: {card}")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err",
            "ms", "device_ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: rec[k] for k in keys + ("int_mm_ms",) if k in rec} for rec in kernels.values()]}))
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
