#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ingest, pretraining, index build and serving path on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

What it does, in order (any failure exits non-zero before the last line):

1. Device: requires CUDA (no CPU path); prints the card's name and power
   limit (``nvidia-smi``), ``torch.version.cuda``, the kernel build time
   and that of the native host library (``g++``, built beside ``nvcc``;
   a run without it fails). Every trie build of phases 6, 6a, 6b, 6c and
   11 must run on that library: phases 6 and 6b read the builders'
   backend, 6a also its spill's CSR route, and the CLI subprocesses of 6a,
   6c and 11 the ``trie builder: native`` line of their logs.
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
4W. The DeepSeek-V2-Lite cell's kernels at D=2048 (``wide_phase``): the
   fused scan's tensor-core variant, a row in parts of K, over the B=256
   stream slab of 163,840 random rows at T = 2, 3 and 5, filters on and
   off, and the probe at B=64, nprobe 64 over 5,120 partitions of 1,024
   slots (filtered, padding slots), each bitwise against its plain
   version and timed; the scan counts (path ``wide D=2048``) must show no
   dp4a launch. The routed experts' grouped products (``ops/moe.py``,
   ``torch._grouped_mm``) against the plain per-expert loop at 2,048 x
   1,408, top 6, over 3,395 tokens routed with a skew, at 64 experts and
   at 60, and over 20 tokens (most experts idle), within ``MOE_TOL`` of
   the output's norm; the grouped GEMM timed, its kernel found by
   ``moe.KERNEL_NAME``. Then ``Embedder.embed`` of 256 queries through
   ``DeepseekV2.encode`` at the published widths, three layers (one
   dense, two MoE): ``moe.LAUNCHES``, reset just before, must read one
   grouped call a MoE layer, and the rows unit norm.
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
   ``load_dir`` serves bitwise the same. Then the case-level tuner,
   ``tune_nprobe_case_recall``, on the same index: 64 query-shaped probes
   (two rows of one generated cluster mixed, plus noise), chunk → case
   ``row // 4``, target and floor 0.95, its oracle in numpy over the f32
   host rows (counts reset just before, read just after: the path
   ``case_tuner``, which must launch the probe and the rescore). Every
   probe and rescore call of the sweep (nprobe 1 to the cap, m=2,304) is
   held against its plain version on the same inputs (probe bitwise,
   rescore within 1e-5), and the pick must follow from the sweep's own
   steps. Prints the two tuners' picks side by side, the case recall@10
   and the row-level recall@10 at each, the oracle's seconds and every
   sweep step's nprobe, route, recall and seconds.
5b. S1, the streaming ANN build at the same size: after a check of the
   free disk (the 8 GB input and the ~8.6 GB of emit files), phase 5's
   host rows written to a ``.npy`` file and memmapped, then
   ``PartitionedANN.build_streaming`` from phase 5's centroids in
   262,144-row slabs into a memmap emit directory, host-deferred (the
   anonymous RSS sampled above its level before the build, beside phase
   5's in-memory build's). The first search promotes the arrays to the
   card (counts reset just before, read just after: path ``stream_ann``);
   ``part_rows``, ``part_int8``, ``part_scale``, the centroids and the
   5,242,880 rescore rows must be bitwise phase 5's (its rescore segments
   split the rows otherwise), and the search phase 5's results; every probe
   and rescore call is held against its plain version. ``save_dir`` must
   adopt the emit directory by a rename (the files keep their inodes);
   ``load_dir`` of it serves the same. Prints each pass's seconds, the RSS
   peak, the promotion and ``save_dir`` seconds. Both indexes are freed
   after.
5c. M1-M3 and M5, sharded serving over phase 5's rows (the served corpus,
   four chunks per case) in a seeded random order (in generation order a
   shard would hold whole clusters) on a mesh of four shards on ``cuda:0``
   (one shard per card when more than one is visible). M1: ``FusedHybridSearch(...,
   ann_mode="partitioned", mesh=)`` over phase 5's centroids (P=5120,
   nprobe 64): ``build_sharded_partitions``'s seconds by stage, the
   per-shard slot capacity and the host RSS; ``query_batch`` at B=8 and 64
   (probe), 256 (stream) and a filtered 64 at the serving recall target
   (counts set to 0 just before, read just after: path ``sharded``), every
   probe, rescore and fused-scan call held against its plain version
   (probe and fused scan bitwise, rescore within 1e-5), recall@10 of the
   served cases against phase 3's single-device exact stream at least
   0.97, and one B=64 probe and one B=256 stream batch under
   ``torch.profiler``: each shard's device ms (the ranges ``sharded shard
   <s>``) and the merge's. M2: ``ann_mode="brute"`` (mode ``sharded``):
   B=64 and the filtered 64 at the serving recall target through each
   shard's fused scan (path ``sharded``, every call held bitwise), then at
   ``recall_target=1.0`` against the single-device brute mode's exact
   scan on the same rows: case rows and score bits equal position by
   position but for members of a tie at the k-th score, which the log
   names. M3: ``ShardedCorpusIndex`` over 1,048,576 of the rows, int8 and
   bf16, against one exact top-k over the whole matrix; one of 32,768 rows
   saved and loaded on a mesh of 2, bitwise what the same file serves on
   four shards. M5, the mesh across processes: the first 1,048,576 of
   those rows, phase A's centroids, phase 3's trie and M1's B=64, B=256
   and filtered 64 batches go to a directory, and two processes of this
   script join a job (``make_distributed_mesh`` with a coordinator on a
   free port of 127.0.0.1), each owning two shards of a 4x1 mesh on
   ``cuda:0`` (gloo; two cards each, and NCCL, when four are visible).
   Each builds ``FusedHybridSearch(mesh=)`` in both modes from the same
   rows, serves the three batches partitioned and B=64 brute (counts set to
   0 just before, read just after: path ``distributed``, per process;
   every probe, rescore and fused-scan call held against its plain
   version), searches ``ShardedCorpusIndex`` over the rows in int8 and
   bf16, and runs one sharded train step of the full-width encoder (f32,
   a 2x2 mesh: dp across the processes). Meanwhile this process serves the
   same batches on the single-process mesh of four shards and runs the same
   step. Each process's case rows, chunk rows, sources and score bits must
   equal this process's, its index results M3's, its loss this loss within
   1e-5 and its parameters within T0's bound; a process that fails or
   outlives its timeout fails the phase (logs: ``chiprun_out/m5_rank*.log``).
6. Build, pipeline end to end: a sqlite store of 32,768 cases with the
   fixture's texts (131,072 chunks), ``build_indexes(storage, cfg,
   device="cuda")`` with mean pooling and no embedder (a corpus vocab and
   the seeded MiniLM-L6 at full width), ``save_artifacts``,
   ``load_artifacts(cfg, device="cuda")``, ``SearchEngine.search_batch`` at
   B=8 and 64: the loaded engine must return what an engine over the
   in-memory indexes returns, name queries led by a case-name or exact
   hit. Prints each stage's time (vocab, text processing and trie inserts,
   embedding in chunks/s, trie freeze, ANN build, save, load).
6P. P, the rest of the public surface at full width: ``brute_force_topk``
   over the first 1,048,576 rows of phase 3's corpus (drawn on the card
   again) for 64 queries (rows plus noise) at k=32, also at recall target
   0.95, equal to ``exact_topk(cosine_scores(...))``; ``chunked_topk`` (8
   chunks) over those scores equal to ``exact_topk``; ``segment_max_dedup``
   of the top-k by case on the card equal to its CPU result; over phase
   6's three tries, ``FrozenTrie.search_batch`` and ``walk_and_gather``
   (with the postings' weights) on the card equal to
   ``TrieIndex.search_batch_rows`` for 64 names, words, citations and
   phrases, ``FrozenTrie.walk`` equal to their nodes, the unranked
   ``walk_and_gather`` on the card equal to the CPU's; and
   ``VectorIndex.generate_embedding`` of 8 texts (cold memo) equal to
   ``generate_embeddings([text])`` bitwise and within cosine 0.999 of its
   row of one 8-text batch. Each op's time.
6M. M4, ``load_artifacts(cfg, mesh=)`` of phase 6's artifacts on the
   mesh of 5c (the vector index a ``ShardedCorpusIndex`` rebuilt from the
   saved vectors) and ``SearchEngine(..., mesh=)``: ``search_batch`` at
   B=8 (probe) and 64 (stream) (path ``sharded``, every call held); every
   name query led by its case, recall@10 of the served cases at least 0.97
   against the engine without a mesh at ``recall_target=1.0``.
6a. S2, the operator's streaming build over that store, killed and
   resumed: phase 6's saved encoder copied into a new vector directory (no
   pretraining runs), ``cli build-index --streaming`` as a subprocess
   (8,192-chunk shards, so 16; content spill and ``tune_on_build`` on)
   SIGKILLed once its manifest records 6 shards, then
   ``StreamingIndexBuilder(...).build(resume=True)`` in this process
   (counts reset just before, read just after: path ``stream_build``;
   every probe and rescore call of its tuner held against the plain
   versions, the pick checked against the steps). It must resume past row
   0 and embed only the chunks after the watermark; its three tries (the
   content trie spill-built) must be bitwise phase 6's, its refs equal and
   its vectors within 1e-5. Over the loaded artifacts: the tuner's probes
   through ``SearchEngine`` at B=64 against the exact case-level oracle;
   ``evaluate_engine`` and ``evaluate_stages`` (path ``eval``, every call
   held); ``eval-retrieval --control`` as subprocesses over phase 6's and
   the streamed artifacts. Prints chunks/s, shards, the spill's run sort,
   merge and CSR seconds, the store fill, ANN and tune seconds, peak RSS
   and anonymous RSS, and the seconds from the kill to the resume.
6b. I, ingest → tuned build → serve, as an operator runs it: 8,192 fixture
   cases (phase 6's generator) under new ids, 64 planted cases that fail
   validation (a short text, a future date) and 64 exact copies of cases
   that pass, through ``IngestionManager.ingest_bulk("mock")`` (a
   ``MockDataSource``) into a fresh store and cache directory, with the
   ``[ingestion]`` defaults (printed) but no pause between batches
   (``--ingest-cases N`` sets the fixture's count). The counts must follow
   from the fixture: every case of row % 16 == 0 has no court and fails
   validation, so processed 7,680, failed validation 512 + 64, skipped
   duplicates 64, stored rows = processed; a second ``ingest_bulk`` of the
   first 1,024 payloads stores nothing and skips as duplicates every one
   of them that passed validation (all 8,320 took 45–70 s, cut for the
   time limit). Prints cases/s overall and per
   eighth of the run, the time of one duplicate check (a full scan of the
   table) at the end of each eighth (left out of the rates), the cache
   and the job's status. Then ``build_indexes(storage, cfg,
   tune_recall=0.95, device="cuda")`` over that store (counts reset just
   before, read just after: the path ``tune``, where the probe and the
   rescore must have launched and no sweep step may take the brute
   route; every probe and rescore call of the sweep is held against its
   plain version, and the pick must follow from the steps): stage times
   with the tuner split into probe embedding, oracle and sweep; each sweep
   step's nprobe, route (kernel, einsum or brute), mean, min and
   tie-aware min case recall@10 and seconds; the tuned nprobe's case
   recall@10 against the oracle over the tuner's own probes (it must equal
   what the sweep measured at that nprobe); the probe texts through
   ``SearchEngine.search_batch`` at B=64 (``min_similarity=-1.0``) and its
   top 10's overlap with the oracle's; ``save_artifacts`` →
   ``load_artifacts``, which must keep the tuned nprobe and serve B=8 and
   B=64 name queries their case first.
6c. T, pretraining, over a store of its own: 8,192 cases of eight seeded
   sentences each (words of the training synonym lexicon, of ``WORDS`` with
   their digits spelled as letters, and view stopwords; a digit only in
   the case number), the corpus vocab and the 2,000-case sample the
   streaming builder pretrains on. The share of in-batch negatives the
   Jaccard mask drops in the first 10 batches must stay at or under 0.5.
   T0: MiniLM-L6 at full width, one batch of B=32, L=64 from
   ``batches_from_pairs`` through the port's step on the card and on the
   CPU from the same seeded parameters at f32 (TF32 off): the loss, the
   accuracy, every gradient leaf, the global norm before and after the
   clip, and the parameters after 3 AdamW steps (warmup 1), each within
   the tolerance it prints. T3: the sharded step
   (``make_sharded_train_step``) on a 2x2 (dp x tp) and a 4x1 mesh over
   four shards on ``cuda:0`` (four cards when visible): T0's batches
   (without ``neg_mask``) at f32 against T0's single-device step on the
   card (each loss within 1e-5, the parameters after 3 steps within T0's
   bound), then 50 bf16 steps on the 2x2 mesh on drawn batches: steps/s, a
   step's ms against its device ms under ``torch.profiler``, device events
   a step. T1: ``pretrain_encoder_guarded`` at its
   defaults (B=32, max_len 64, views, Jaccard 0.5, scrubbing, bf16) for
   300 steps: pairs, steps/s, the loss and accuracy every 50 steps, the
   guardrail's MRRs and pick (the weights with the higher MRR kept; a kept
   init equal to its copy bitwise); timed alone beside it: the pair mining,
   300 batches drawn on the host, a step on drawn batches and 2 steps
   under ``torch.profiler`` (the card's busy share). T2: ``cli build-index
   --streaming --shard-chunks 2048`` over that store with an empty vector
   directory (it pretrains 300 steps, saves the encoder, streams),
   SIGKILLed at 6 shards (its log: ``chiprun_out/t2_build.log``), resumed
   in this process (counts reset just before, read just after: path
   ``pretrain_build``): no pretraining, the saved encoder files' sha256
   unchanged, only the chunks after the watermark embedded, the tuner
   (every probe and rescore call held against the plain versions, the
   pick checked against the steps) and the quality gate finished; the
   tuner's probes through ``SearchEngine`` at B=64 against the exact
   case-level oracle.
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
10. H1, HTTP over that engine, in this process: ``ApiServer`` with the
   default ``[server]`` section (batch_max 64, window 2 ms, two batches
   in flight; the per-client rate limit lifted for the loadtest) bound
   through aiohttp's ``AppRunner`` on 127.0.0.1 in an event loop on its
   own thread. Eight semantic queries get a planted corpus row each (the
   seeded encoder's cosines to the synthetic corpus lie under the 0.5 an
   HTTP request cannot change). /health; POST /search with 8 case names
   (their case first) and the 8 semantic queries (their planted case
   first), each reply equal to ``search_batch([q])`` with the query cache
   cleared; GET /search, /graphql, /completions, /stats; three 400s; then
   the port's ``loadtest`` coroutine: 1,024 distinct queries at
   concurrency 64 after its warm pass, with the query and embedding
   caches cleared between the two, so that no measured request is a
   cache reply (every reply 200; QPS, p50/p95/p99; the batcher's mean
   batch from /stats must exceed 1). Launch counts are reset just before
   the first request and read just after the loadtest, before any direct
   engine call (path ``http``): the probe and the rescore must have
   launched. Then 64 of the loadtest's queries served alone must equal
   what the burst served (same query embeddings; scores within 1e-5).
11. H2, the CLI lifecycle over phase 6's store and artifacts, as
   subprocesses: ``config-dump``, ``check-health``, ``search`` and
   ``completions`` (started together, each must exit 0 with the expected
   output), then ``serve`` until "warmup complete", /health and POST
   /search, 64 new cases stored, ``POST /admin/reindex?mode=incremental``
   until /stats counts them, a new case found by name, ``quality.json``
   beside the vectors, SIGINT: exit 0 with "shutting down" in its log
   (``chiprun_out/h2_serve.log``). Beside ``serve``'s lifecycle, from an
   empty store with the default ``[vector] pooling = "auto"``: ``ingest --source mock`` (3
   cases processed), the same again (3 skipped), ``build-index
   --pretrain-steps 20`` (its log must carry the pretraining report),
   ``build-index --tune-recall 0.95`` (the pooling pick from its log; the tuner skipped
   at 3 cases) and ``search "miranda v. arizona"`` (Miranda first). Each
   step's seconds.

The line before the last is a JSON object with one entry per kernel:
``launches`` counts the kernel on the path that reaches it (the
``query_batch`` run for the three serving kernels, ``fused_int8_topk`` for
the int8 top-k (at D=48 for its dp4a variant), ``fused_scan_topk`` at T=17 for the fused scan's dp4a
variant, which the serving paths must not launch) and ``launches_by_path``
on each path (``build``: phase 5's recall search; ``case_tuner``: phase
5's case-level tuner; ``stream_ann``: S1's first search; ``stream_build``:
S2's resumed build; ``eval``: S2's evaluation; ``tune``: phase 6b's tuned
build; ``pretrain_build``: T2's resumed build; ``http``: phase 10;
``sharded``: M1, M2 and M4 summed; ``distributed rank <r>``: M5's serving
runs in process ``r``). Each kernel's ``max_abs_err`` is the
largest difference from its plain version over the kernel phase and every
call held on the ``build``, ``case_tuner``, ``stream_ann``,
``stream_build``, ``eval``, ``tune``, ``pretrain_build``, ``sharded`` and
``distributed`` paths. The last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --only kernels`` runs phases 1, 2, 4 and 4W (and
the card state of 3) and skips the builds, serving, the profile, the store and
the engine: about a minute, for iterating on a kernel. Its serving kernels
print ``"launches": null``. ``--only wide`` runs phases 1, 2 and 4W alone
(about two minutes). ``--only int8-ablations`` builds the ablation
variants of the int8 top-k's wgmma kernel (``TSS_INT8_TOPK_ABLATE``) and
prints the device time of each at B=256, k=32 over the corpus of phase 3.
``--only stream`` runs phases 1, 2, 5, 5b, 6 and 6a: the builds and their
kernel checks, with no kernel timing, serving, store or engine.
``--only train`` runs phases 1, 2 and 6c: pretraining with its own store
(T3, the sharded step, included). ``--only build`` runs phases 1, 2, 5
(without the case-level tuner and S1), 6 and 6P. Phase 6P runs after
phase 6 in every mode that runs phase 6. Before the last two lines a line
collects the host figures the native library moves (phase 6's text + tries
and trie freeze, 6a's CSR pass, 11's reindex, 5b's and 6a's anonymous RSS
peaks). ``--only mesh`` runs phases 1, 2, 3, 5
(without the case-level tuner and S1), 5c (M5, the mesh across processes,
included), 6 and 6M: the sharded phases and the builds they serve.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime as dt
import functools
import json
import logging
import math
import multiprocessing
import pickle
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


def rescore_seg_rows(D: int) -> int:
    """Rows of each bf16 rescore segment but the last (the saved layout)."""
    from trie_semantic_search_tpu_torch.ops.scan_kernels import (
        GATHER_ROW_ALIGN_LCM,
        GATHER_SEG_BYTES,
    )

    L = GATHER_ROW_ALIGN_LCM
    return max(L, (GATHER_SEG_BYTES // (D * 2)) // L * L)


def make_corpus(torch, P: int, m: int, D: int, seed: int, device, gen_device=None):
    """The clustered corpus of :func:`corpus_slabs` (the shape of the JAX
    package's bench corpus) laid out partition-major as a built index would
    hold it: centroids, int8 blocks, scales and bf16 rescore segments (the
    saved artifact geometry), row ``p * m + j`` in slot ``j`` of partition
    ``p``. The random numbers come from a generator on ``gen_device``
    (default ``device``)."""
    from trie_semantic_search_tpu_torch.ops.scan_kernels import GATHER_ROW_ALIGN_LCM

    N = P * m
    L = GATHER_ROW_ALIGN_LCM
    seg_rows = rescore_seg_rows(D)
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
    columns = serving_columns(np, n_cases)
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


def serving_columns(np, n_cases: int):
    """The served cases' metadata columns (ids, courts, dates)."""
    from trie_semantic_search_tpu_torch.storage.columns import MetadataColumns

    court_ids, dates = case_columns(np, n_cases)
    return MetadataColumns(
        case_ids=[uuid.UUID(int=i + 1) for i in range(n_cases)],
        court_ids=court_ids,
        dates=dates,
        court_vocab={c: i for i, c in enumerate(COURTS)},
    )


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


#: the DeepSeek-V2-Lite bulk cell's shapes: rows of its hidden size, the
#: stream's 256-query slab, the probe's 64 queries x 64 probes over 5,120
#: partitions of 1,024 slots, and its routed experts (64 of 1,408, top 6)
#: over a B=256 batch's real tokens
WIDE_D, WIDE_SLAB, WIDE_P, WIDE_M = 2048, 163_840, 5120, 1024
MOE_E, MOE_F, MOE_K, MOE_TOKENS = 64, 1408, 6, 3395
#: the grouped products against the plain loop, relative to the output's
#: norm: the grouped GEMM sums in another order, so a projection's bf16
#: rounding moves by a unit in the last place now and then (not bitwise)
MOE_TOL = 2e-3


def wide_scan_inputs(torch, g, dev, B, D, N):
    """Random int8 queries and rows with their scales and filter columns
    (courts 0-39, dates 0-999), for the stream at ``D``."""
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk

    q8 = torch.randint(-128, 128, (B, D), generator=g, device=dev, dtype=torch.int16).to(torch.int8)
    rows = torch.randint(-128, 128, (N, D), generator=g, device=dev, dtype=torch.int16).to(torch.int8)
    qs = torch.rand((B, 1), generator=g, device=dev) * 1e-3 + 1e-4
    cs = torch.rand((N, 1), generator=g, device=dev) * 1e-3 + 1e-4
    court = torch.randint(0, 40, (N,), generator=g, device=dev, dtype=torch.int32)
    date = torch.randint(0, 1000, (N,), generator=g, device=dev, dtype=torch.int32)
    table = torch.rand((B, 40), generator=g, device=dev) < 0.7
    lo = torch.randint(0, 300, (B,), generator=g, device=dev, dtype=torch.int32)
    hi = torch.randint(600, 1000, (B,), generator=g, device=dev, dtype=torch.int32)
    mins = torch.full((B,), -1e30, device=dev)
    return q8, rows, sk.fused_scan_inputs(qs, court, date, table, lo, hi, mins, cs)


def wide_phase(torch, np, seed: int, dev: str = "cuda") -> tuple[dict, dict]:
    """The DeepSeek-V2-Lite bulk cell's kernels at its shapes. The fused
    scan's tensor-core variant (a row in parts of K) over the B=256 stream
    slab at D=2048, T = 2, 3 and 5, filters on and off, and the probe at
    B=64, nprobe 64, filtered, some slots padding, both bitwise against
    their plain versions and timed (the scan counts reset just before,
    read just after: the dp4a variant must not run). Then the routed
    experts' grouped products against the plain per-expert loop at 64
    experts and at 60 (no power of two), under a skewed routing, timed,
    and the grouped GEMM's kernel found by ``moe.KERNEL_NAME``. Then the
    main path, ``Embedder.embed`` of 256 queries through
    ``DeepseekV2.encode`` at the published widths over three layers (one
    dense, two MoE), with ``moe.LAUNCHES`` reset just before and read just
    after. Returns the figures and the scan launches."""
    from torch.profiler import ProfilerActivity, profile

    from trie_semantic_search_tpu_torch.models import deepseek_v2 as dsv2
    from trie_semantic_search_tpu_torch.models.embedder import Embedder
    from trie_semantic_search_tpu_torch.models.tokenizer import SPECIALS, WordPieceTokenizer
    from trie_semantic_search_tpu_torch.ops import moe
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 2048)
    out: dict = {}
    sk.reset_launch_counts()
    q8, slab, inp = wide_scan_inputs(torch, g, dev, 256, WIDE_D, WIDE_SLAB)
    for T in (2, 3, 5):
        if sk.fused_scan_variant(WIDE_D, T) != "wgmma":
            raise AssertionError(f"the fused scan at D={WIDE_D} T={T} is not on the tensor-core variant")
        for filt in (False, True):
            kw = dict(corpus_q=slab, n_keep=T, use_court=filt, use_date=filt, **inp)
            kv, ki = sk.fused_scan_cuda(q8, **kw)
            pv, pi = sk.fused_scan_plain(q8, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ki, pi)):
                raise AssertionError(f"fused scan differs from plain at D={WIDE_D} T={T} filters={filt}")
    kw = dict(corpus_q=slab, n_keep=2, use_court=False, use_date=False, **inp)
    ms, _ = device_ms(torch, lambda: sk.fused_scan_cuda(q8, **kw), 20, "fused_scan")
    nbytes = WIDE_SLAB * (WIDE_D + 4)
    out["fused_scan_ms"], out["fused_scan_roofline"] = ms, 100.0 * nbytes / HBM_BPS * 1e3 / ms
    log(f"  fused scan D={WIDE_D}: 6 cases (T = 2, 3, 5, filters on/off) over the B=256 slab of {WIDE_SLAB} "
        f"rows bitwise equal to the plain version; device {ms:.4f} ms a slab at T=2, "
        f"{out['fused_scan_roofline']:.1f}% of the slab's byte bound")
    del slab, inp

    B, NP = 64, 64
    part = torch.randint(-128, 128, (WIDE_P, WIDE_M, WIDE_D), generator=g, device=dev,
                         dtype=torch.int16).to(torch.int8)
    q8 = q8[:B].contiguous()
    qs = torch.rand((B,), generator=g, device=dev) * 1e-3 + 1e-4
    ps = torch.rand((WIDE_P, WIDE_M), generator=g, device=dev) * 1e-3 + 1e-4
    top_p = torch.randint(0, WIDE_P, (B, NP), generator=g, device=dev, dtype=torch.int32)
    rows = torch.arange(WIDE_P * WIDE_M, dtype=torch.int32, device=dev).reshape(WIDE_P, WIDE_M)
    rows[:, -7:] = -1
    court = torch.randint(0, 40, (WIDE_P, WIDE_M), generator=g, device=dev, dtype=torch.int32)
    pdate = torch.randint(0, 1000, (WIDE_P, WIDE_M), generator=g, device=dev, dtype=torch.int32)
    args = (q8, qs, top_p, part, ps, rows, court // 32, (1 << (court % 32)).to(torch.int32), pdate,
            sk.pack_court_words(torch.rand((B, 40), generator=g, device=dev) < 0.7),
            torch.randint(0, 300, (B,), generator=g, device=dev, dtype=torch.int32),
            torch.randint(600, 1000, (B,), generator=g, device=dev, dtype=torch.int32),
            torch.full((B,), -1e30, device=dev))
    kv, ks = sk.probe_candidates_cuda(*args)
    pv, ps_ = sk.probe_candidates_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kv.view(torch.int32), pv.view(torch.int32)) and torch.equal(ks, ps_)):
        raise AssertionError(f"probe differs from plain at D={WIDE_D}")
    ms, kernels = device_ms(torch, lambda: sk.probe_candidates_cuda(*args), 10, "probe_candidates")
    uniq = int(torch.unique(top_p).numel())
    out["probe_ms"], out["probe_kernels"] = ms, kernels
    log(f"  probe D={WIDE_D}: B={B} nprobe={NP} over {WIDE_P} x {WIDE_M} slots ({uniq} distinct partitions, "
        f"filtered, 7 padding slots each) bitwise equal to the plain version; device {ms:.4f} ms")
    del part, args, kv, pv
    launches = dict(sk.LAUNCHES)
    if launches["fused_scan"] <= 0 or launches["probe_candidates"] <= 0 or launches["fused_scan_dp4a"]:
        raise AssertionError(f"scan launches at D={WIDE_D}: {launches}")
    torch.cuda.empty_cache()

    H = WIDE_D
    out["moe"] = {}
    for E, n in ((MOE_E, MOE_TOKENS), (60, MOE_TOKENS), (MOE_E, 20)):
        gm = torch.Generator(device=dev).manual_seed(seed + E * n)
        wg, wu = ((torch.randn((E, H, MOE_F), generator=gm, device=dev) / H ** 0.5).to(torch.bfloat16)
                  for _ in "gu")
        wd = (torch.randn((E, MOE_F, H), generator=gm, device=dev) / MOE_F ** 0.5).to(torch.bfloat16)
        x = torch.randn((n, H), generator=gm, device=dev).to(torch.bfloat16)
        logits = torch.randn((n, E), generator=gm, device=dev) + 1.5 * torch.randn((E,), generator=gm, device=dev)
        w, idx = torch.topk(torch.softmax(logits, -1), MOE_K, dim=-1)
        moe.reset_launch_counts()
        got = moe.grouped_expert_ffn(x, idx, w, wg, wu, wd)
        want = moe.grouped_expert_ffn_plain(x, idx, w, wg, wu, wd)
        rel = float((got - want).norm() / want.norm())
        if moe.LAUNCHES["grouped_expert_ffn"] != 1 or not rel < MOE_TOL:
            raise AssertionError(f"grouped experts E={E} n={n}: {moe.LAUNCHES}, rel {rel:.3g} (tolerance {MOE_TOL})")
        counts = torch.bincount(idx.reshape(-1), minlength=E)
        rec = dict(rel=rel, busiest_over_mean=float(counts.max()) * E / (n * MOE_K),
                   idle_experts=int((counts == 0).sum()))
        if (E, n) == (MOE_E, MOE_TOKENS):
            fn = lambda: moe.grouped_expert_ffn(x, idx, w, wg, wu, wd)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            reps = 10
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            by_name = {e.key: dev_us(e) / 1e3 / reps for e in prof.key_averages() if on_device(e)}
            gemm = {k: v for k, v in by_name.items() if moe.KERNEL_NAME in k}
            if not gemm:
                raise AssertionError(f"no device kernel holds {moe.KERNEL_NAME!r}: {sorted(by_name)}")
            least = max(2.0 * 3 * H * MOE_F * MOE_K * n / BF16_FLOPS, 3.0 * E * H * MOE_F * 2 / HBM_BPS) * 1e3
            rec.update(device_ms=sum(by_name.values()), grouped_gemm_ms=sum(gemm.values()), least_ms=least,
                       grouped_gemm_roofline=100.0 * least / sum(gemm.values()),
                       call_ms=cuda_ms(torch, fn, reps), plain_ms=cuda_ms(torch, lambda: moe.grouped_expert_ffn_plain(
                           x, idx, w, wg, wu, wd), 2),
                       kernels={k[:160]: v for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])})
            log(f"  grouped experts E={E} n={n}: device {rec['device_ms']:.4f} ms a layer, of it the grouped "
                f"GEMMs {rec['grouped_gemm_ms']:.4f} ms ({rec['grouped_gemm_roofline']:.1f}% of the least "
                f"{least:.4f} ms); call {rec['call_ms']:.4f} ms, plain loop {rec['plain_ms']:.4f} ms")
            for k, v in list(rec["kernels"].items())[:8]:
                log(f"    {v:8.4f} ms  {k}")
        out["moe"][f"E={E} n={n}"] = rec
        log(f"  grouped experts E={E} n={n}: within {rel:.3g} of the plain loop (tolerance {MOE_TOL}); "
            f"busiest expert {rec['busiest_over_mean']:.2f}x the mean, {rec['idle_experts']} idle")
        del wg, wu, wd, x, got, want
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(dsv2.DeepseekV2Config(), num_hidden_layers=3)
    vocab = {t: i for i, t in enumerate([*SPECIALS, *WORDS])}
    emb = Embedder(tokenizer=WordPieceTokenizer(vocab), model=dsv2.DeepseekV2(cfg, device=dev, seed=seed),
                   device=dev)
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(WORDS, rng.integers(4, 25))) for _ in range(256)]
    emb.embed(texts)  # warm
    moe.reset_launch_counts()
    t0 = time.perf_counter()
    e = emb.embed(texts).embedding
    out["encode_s"] = time.perf_counter() - t0
    out["main_path_launches"] = dict(moe.LAUNCHES)
    norms = np.linalg.norm(e, axis=1)
    if moe.LAUNCHES["grouped_expert_ffn"] != cfg.n_moe_layers or not np.allclose(norms, 1.0, atol=1e-3):
        raise AssertionError(f"Embedder -> DeepseekV2.encode: launches {moe.LAUNCHES} (want "
                             f"{cfg.n_moe_layers}), norms {norms.min():.4f}-{norms.max():.4f}")
    log(f"  Embedder.embed of 256 queries through DeepseekV2.encode (published widths, 3 layers): "
        f"launches {out['main_path_launches']}, {out['encode_s'] * 1e3:.1f} ms, unit-norm rows")
    del emb
    torch.cuda.empty_cache()
    return out, launches


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


def trie_backends(text: str) -> list[str]:
    """The backend of each trie build a log records (its ``trie builder:
    <backend>`` lines), in order."""
    return [ln.split("trie builder: ", 1)[1].split()[0] for ln in text.splitlines() if "trie builder: " in ln]


def require_native(what: str, backends) -> list[str]:
    """Fail unless every trie build in ``backends`` (one at least) ran the
    native host library: a build that fell back to the Python builder is a
    failed run."""
    backends = list(backends)
    if not backends or any(b != "native" for b in backends):
        raise AssertionError(f"{what}: trie builds on {backends or 'no logged backend'}, not the native "
                             "host library")
    return backends


@contextlib.contextmanager
def kept_calls(sk, names):
    """While open, each call of the launchers ``names`` of ``sk`` (which
    still launch and count) keeps ``(name, inputs, a copy of the outputs)``
    in the list it yields, the inputs as positional arguments."""
    import inspect

    calls: list = []
    orig = {n: getattr(sk, n) for n in names}

    def keeper(n):
        sig = inspect.signature(orig[n])

        def call(*args, **kwargs):
            out = orig[n](*args, **kwargs)
            kept = tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()
            calls.append((n, sig.bind(*args, **kwargs).args, kept))
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
    """Each kept probe and fused-scan call bitwise against
    ``probe_candidates_plain`` / ``fused_scan_plain`` and each kept rescore
    call within 1e-5 of ``gather_rescore_plain``, on the same inputs.
    Returns the largest difference of each kernel (over live entries)."""
    err = {"probe_candidates": 0.0, "gather_rescore": 0.0, "fused_scan": 0.0}
    for name, args, out in calls:
        if name in ("probe_candidates_cuda", "fused_scan_cuda"):
            plain = sk.probe_candidates_plain if name == "probe_candidates_cuda" else sk.fused_scan_plain
            key = name.removesuffix("_cuda")
            (kv, ks), (pv, ps) = out, plain(*args)
            bad = (kv.view(torch.int32) != pv.view(torch.int32)) | (ks != ps)
            if bad.any():
                raise AssertionError(f"{key} kernel differs from plain on the built index: "
                                     f"{int(bad.sum())} entries")
            fin = torch.isfinite(pv)
            e = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
            err[key] = max(err[key], e)
        else:
            e = float((out - sk.gather_rescore_plain(*args)).abs().max())
            if not e <= 1e-5:
                raise AssertionError(f"gather rescore differs from plain by {e} on the built index")
            err["gather_rescore"] = max(err["gather_rescore"], e)
    return err


def held_summary(calls) -> str:
    """The kept probe calls' batch, nprobe range and partition capacity,
    and the number of rescore calls, for the log."""
    probes = [args[2].shape for n, args, _ in calls if n == "probe_candidates_cuda"]
    caps = {args[3].shape[1] for n, args, _ in calls if n == "probe_candidates_cuda"}
    nps = [s[1] for s in probes]
    return (f"{len(probes)} probe calls (B {sorted({s[0] for s in probes})}, nprobe "
            f"{min(nps, default=0)}..{max(nps, default=0)}, m {sorted(caps)}) and "
            f"{len(calls) - len(probes)} rescore calls")


def tuner_steps(records) -> tuple[float, list[dict], list[str]]:
    """From the records of the ``tss_torch.index.tuning`` logger: the
    oracle's seconds, each sweep step in the order measured (nprobe, mean,
    min and tie-aware min case recall, route, seconds) and the settling
    warnings."""
    oracle_s = next(r.args[2] for r in records if r.msg.startswith("case-level oracle"))
    steps = [dict(nprobe=r.args[1], mean=r.args[2], min=r.args[3], tie_min=r.args[4],
                  route=r.args[5], s=r.args[6])
             for r in records if r.msg.startswith("case recall@")]
    settled = [r.getMessage() for r in records if r.levelno >= logging.WARNING]
    return oracle_s, steps, settled


def check_pick(steps: list[dict], pick: int, target: float, floor: float | None) -> str:
    """The tuner's pick must follow from its own measured steps: the
    smallest step whose mean reaches ``target`` and whose tie-aware worst
    reaches ``floor``; when no step does, the smallest whose mean reaches
    ``target`` and whose tie-aware worst is within 1e-3 of the best seen
    (with a floor), else the largest step, the cap. No step may have taken
    the brute route. Returns which rule picked."""
    if not steps or any(st["route"] == "brute" for st in steps):
        raise AssertionError(f"the sweep measured the brute scan or nothing: {steps}")
    ok = [st["nprobe"] for st in steps
          if st["mean"] >= target and (floor is None or st["tie_min"] >= floor)]
    best = max(st["tie_min"] for st in steps)
    plateau = [st["nprobe"] for st in steps if st["mean"] >= target and st["tie_min"] >= best - 1e-3]
    if ok:
        rule, want = "target met", min(ok)
    elif floor is not None and plateau:
        rule, want = "plateau of the worst probe", min(plateau)
    else:
        rule, want = "cap", max(st["nprobe"] for st in steps)
    if pick != want:
        raise AssertionError(f"the tuner picked nprobe {pick}, its steps give {want} ({rule}): {steps}")
    return rule


def ann_build_phase(torch, np, seed: int, work: Path, keep: dict | None = None,
                    full: bool = True) -> tuple[dict, dict, dict | None, dict | None]:
    """Phase A, the ANN build at the served size: the 5,242,880 corpus rows
    of :func:`corpus_slabs` (drawn on the card from ``seed``, in generation
    order, copied to the host) through ``PartitionedANN(AnnConfig(),
    device="cuda").build``: k-means and the top-c assignment on the card,
    the layout on the host. Checks the card's assignment against the CPU's
    on one block (equal but for near-ties), that a build from fixed
    centroids is bitwise reproducible, that ``tune_nprobe`` picks an nprobe
    under P at which the probe and rescore kernels reach tie-aware
    recall@10 >= 0.95 against ``search_brute`` on fresh queries, and that
    ``save_dir`` / ``load_dir`` serve bitwise the same; then the
    case-level tuner on the same index (:func:`case_tuner_check`), and
    phase S1 over the same rows (:func:`stream_ann_phase`); with ``full``
    false these two are skipped (their counts None). ``keep`` receives the
    host rows and the centroids (phase M serves them). Returns the
    details, the launch counts of that recall search, those of the
    case-level tuner and those of S1's first search."""
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
    with logged_records("tss_torch.ann") as records, anon_rss_peak() as rss:
        ann.build(host, seed)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["stages_s"] = dict(ann.build_seconds)
    out["rss"] = rss
    moved = [r.args[0] for r in records if r.msg.startswith("partition overflow")]
    out["overflow_rows"] = moved[0] if moved else 0
    out["replica_rows"] = int((ann.part_rows >= 0).sum()) - N
    P, m = (int(x) for x in ann.part_rows.shape)
    out["partitions"], out["capacity"], out["bytes"] = P, m, ann.get_stats().nbytes_total
    if P != P_PARTS:
        raise AssertionError(f"_auto_partitions gave P={P}, expected {P_PARTS}")
    log(f"  build {out['build_s']:.1f} s: " + ", ".join(f"{k} {v:.2f} s" for k, v in out["stages_s"].items())
        + "; " + rss_line(rss))
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
    del back
    shutil.rmtree(work / "ann.mmap")

    # the case-level tuner on the same index (counts reset just before,
    # read just after: the path ``case_tuner``)
    tuner_launches = stream_launches = None
    if full:
        out["case_tuner"], tuner_launches, pending = case_tuner_check(torch, np, sk, ann, host, seed, q, thresh)
        log(f"phase: S1, build_streaming of the same {N} rows from the same centroids into a memmap "
            "emit directory (counts reset just before the first search, read just after)")
        out["stream_ann"], stream_launches = stream_ann_phase(
            torch, np, sk, ann, host, nprobe, q, gv, gi, work, out["save_dir_s"])
        ct = out["case_tuner"]
        ct["plain_err"], _, ct["plain_s"] = pending.result()
        log(f"  the case-level tuner's {ct['held']} against the plain versions in {ct['plain_s']:.1f} s "
            f"(beside S1): probe bitwise equal, rescore within {ct['plain_err']['gather_rescore']:.3g}")
    if keep is not None:
        keep.update(host=host, centroids=cents)
    del ann, host
    torch.cuda.empty_cache()
    return out, launches, tuner_launches, stream_launches


#: phase A's case-level tuner: query-shaped probes, the target and floor
CASE_TUNE_PROBES, CASE_TUNE_RECALL = 64, 0.95


def case_tuner_check(torch, np, sk, ann, host, seed: int, q, thresh) -> tuple[dict, dict]:
    """``tune_nprobe_case_recall`` on phase A's index beside its row-level
    ``tune_nprobe`` pick: ``CASE_TUNE_PROBES`` query-shaped probes (two rows
    of one generated cluster mixed, plus noise), chunk → case ``row // 4``
    (the engine's mapping), target and floor ``CASE_TUNE_RECALL``; the
    oracle in numpy over the f32 host rows. Prints both picks, each one's
    case recall@10 and the row-level tie-aware recall@10 on the fresh
    queries ``q`` (``thresh``: the exact k-th score minus 1e-5) at both,
    the oracle's seconds, and the sweep's steps and routes. The pick must
    follow from the steps (:func:`check_pick`), and every probe and rescore
    call of the sweep must match its plain version on the same inputs
    (:func:`held_in_background`, which the caller reads after S1). Returns
    the details, the launch counts of the tuner's run and that future."""
    from trie_semantic_search_tpu_torch.index import tuning

    N = len(host)
    row_pick = int(ann.tuned_nprobe)
    rng = np.random.default_rng(seed + 13)
    cl = rng.integers(0, P_PARTS, CASE_TUNE_PROBES)
    j1, j2 = rng.integers(0, M_SLOTS, (2, CASE_TUNE_PROBES))
    w = rng.random((CASE_TUNE_PROBES, 1)).astype(np.float32) * 0.5
    probes = ((1 - w) * host[cl * M_SLOTS + j1] + w * host[cl * M_SLOTS + j2]
              + 0.1 * rng.standard_normal((CASE_TUNE_PROBES, DIM)).astype(np.float32) / DIM**0.5)
    chunk_case = np.arange(N, dtype=np.int64) // CHUNKS_PER_CASE
    with (logged_records("tss_torch.index.tuning") as records,
          kept_calls(sk, ("probe_candidates_cuda", "gather_rescore_cuda")) as calls):
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        case_pick = tuning.tune_nprobe_case_recall(
            ann, chunk_case, host, probes, k=10, target_recall=CASE_TUNE_RECALL,
            min_recall=CASE_TUNE_RECALL)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
    oracle_s, sweep, settled = tuner_steps(records)
    rule = check_pick(sweep, case_pick, CASE_TUNE_RECALL, CASE_TUNE_RECALL)
    # every sweep step's kernel calls against the plain versions, same
    # inputs, in a thread beside S1's host-bound build
    held = held_summary(calls)
    pending = held_in_background(torch, sk, calls)
    del calls
    steps = {st["nprobe"]: st for st in sweep}
    if row_pick not in steps:
        oracle = tuning.case_level_oracle(host, chunk_case, probes, 10)
        per = [len(set(s_) & set(o)) / 10 for s_, o in
               zip(tuning._served_cases(ann, chunk_case, probes, 10, row_pick), oracle)]
        steps[row_pick] = dict(nprobe=row_pick, mean=float(np.mean(per)), min=float(np.min(per)),
                               route=ann.search_route(len(probes), row_pick), measured_apart=True)
    row_recall = {n: float(np.mean(ann.search(q, 10, nprobe=n)[0] >= thresh)) for n in (row_pick, case_pick)}
    out = dict(row_pick=row_pick, case_pick=case_pick, seconds=seconds, oracle_s=oracle_s,
               sweep=list(steps.values()), settled=settled, rule=rule, launches=launches, held=held,
               case_recall_at_row_pick=steps[row_pick], case_recall_at_case_pick=steps[case_pick],
               row_recall=row_recall)
    log(f"  case-level tuner ({CASE_TUNE_PROBES} query-shaped probes, chunk -> case row // "
        f"{CHUNKS_PER_CASE}, target and floor {CASE_TUNE_RECALL}) in {seconds:.1f} s (oracle over the "
        f"{N} f32 host rows {oracle_s:.1f} s){'; ' + settled[0] if settled else ''}")
    for st in sorted(steps.values(), key=lambda x: x["nprobe"]):
        extra = f" tie-aware min {st['tie_min']:.4f}  {st['s']:.2f} s" if "s" in st else " (measured apart)"
        log(f"    nprobe {st['nprobe']:5d} route {st['route']:6s} case recall@10 mean {st['mean']:.4f} "
            f"min {st['min']:.4f}{extra}")
    log(f"  picks side by side: tune_nprobe (rows as queries) {row_pick}: case recall@10 mean "
        f"{steps[row_pick]['mean']:.4f} min {steps[row_pick]['min']:.4f}, row recall@10 "
        f"{row_recall[row_pick]:.4f}; tune_nprobe_case_recall {case_pick}: case recall@10 mean "
        f"{steps[case_pick]['mean']:.4f} min {steps[case_pick]['min']:.4f}, row recall@10 "
        f"{row_recall[case_pick]:.4f}; the pick follows from the steps ({rule}); launches on the "
        f"case_tuner path {launches}")
    if launches["probe_candidates"] <= 0 or launches["gather_rescore"] <= 0:
        raise AssertionError(f"the case-level tuner did not run the probe and rescore kernels: {launches}")
    return out, launches, pending


@contextlib.contextmanager
def anon_rss_peak(period: float = 0.5):
    """While open, a thread samples this process's anonymous RSS
    (``SystemUtils.anon_memory_usage``: ``RssAnon``, else the
    ``Anonymous`` lines of ``smaps_rollup`` or ``smaps``, named in
    ``source``; None where the kernel gives neither) and its whole RSS
    (``rss_*``, file pages included) every ``period`` seconds; the dict it
    yields holds the levels when it opened (``base``) and the highest
    samples (``peak``)."""
    import threading

    from trie_semantic_search_tpu_torch.utils import SystemUtils

    def source() -> str:
        with open("/proc/self/status") as f:
            if "RssAnon:" in f.read():
                return "RssAnon"
        for name in ("smaps_rollup", "smaps"):
            try:
                with open(f"/proc/self/{name}") as f:
                    if any(line.startswith("Anonymous:") for line in f):
                        return f"{name} Anonymous"
            except OSError:
                continue
        return "not measured: this kernel reports no anonymous RSS"

    anon = SystemUtils.anon_memory_usage() or 0
    rss = SystemUtils.memory_usage() or 0
    rec = {"base": anon, "peak": anon, "rss_base": rss, "rss_peak": rss, "source": source()}
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(period):
            rec["peak"] = max(rec["peak"], SystemUtils.anon_memory_usage() or 0)
            rec["rss_peak"] = max(rec["rss_peak"], SystemUtils.memory_usage() or 0)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield rec
    finally:
        stop.set()
        t.join()
        rec["peak"] = max(rec["peak"], SystemUtils.anon_memory_usage() or 0)
        rec["rss_peak"] = max(rec["rss_peak"], SystemUtils.memory_usage() or 0)


def rss_line(rss: dict) -> str:
    """The anonymous and whole RSS peaks above their levels before, for
    the log."""
    return (f"anonymous RSS ({rss['source']}) peak {(rss['peak'] - rss['base']) / 2**30:.2f} GiB above "
            f"the {rss['base'] / 2**30:.2f} GiB before; whole RSS (file pages included) peak "
            f"{(rss['rss_peak'] - rss['rss_base']) / 2**30:.2f} GiB above the "
            f"{rss['rss_base'] / 2**30:.2f} GiB before")


def rows_equal(torch, a_segs, b_segs, n: int, step: int = 1 << 20) -> bool:
    """Whether two bf16 rescore stores hold the same bits in their first
    ``n`` rows, whatever their segment boundaries."""

    def rows(segs, lo, hi):
        out, base = [], 0
        for s in segs:
            s_lo, s_hi = max(lo, base), min(hi, base + s.shape[0])
            if s_lo < s_hi:
                out.append(s[s_lo - base : s_hi - base])
            base += s.shape[0]
        return torch.cat(out).view(torch.int16)

    return all(torch.equal(rows(a_segs, lo, min(lo + step, n)), rows(b_segs, lo, min(lo + step, n)))
               for lo in range(0, n, step))


#: phase S1: input rows per slab of the streaming ANN build
S1_SLAB_ROWS = 262_144


def stream_ann_phase(torch, np, sk, ann, host, nprobe: int, q, gv, gi, work: Path,
                     save_dir_s: float) -> tuple[dict, dict]:
    """Phase S1, the ANN streaming build at full size: phase A's host rows
    written to ``<work>/s1/vectors.npy`` and memmapped, then
    ``PartitionedANN.build_streaming`` from phase A's centroids with
    ``S1_SLAB_ROWS``-row slabs into a memmap emit directory, host-deferred.
    Checks the free disk first (the input and the emit files). The
    anonymous RSS is sampled above its level before the build. The first
    search promotes the arrays to the card (launch counts reset just
    before, read just after: path ``stream_ann``); the promoted
    ``part_rows``, ``part_int8``, ``part_scale`` and rescore rows must be
    bitwise phase A's ``build`` arrays, and the search phase A's results;
    every probe and rescore call is held against its plain version.
    ``save_dir`` must adopt the emit directory by a rename (the array
    files keep their inodes), and ``load_dir`` of it must serve the same.
    Returns the details and the launch counts."""
    from trie_semantic_search_tpu_torch.core.config import AnnConfig
    from trie_semantic_search_tpu_torch.index.ann import PartitionedANN

    dev = torch.device("cuda")
    root = work / "s1"
    root.mkdir()
    P, m = (int(x) for x in ann.part_rows.shape)
    N, D = host.shape
    emit_bytes = P * m * (D + 8) + 2 * N * D
    need = host.nbytes + emit_bytes + (1 << 30)
    free = shutil.disk_usage(root).free
    log(f"  free disk {free / 2**30:.1f} GiB, needed {need / 2**30:.1f} GiB (input "
        f"{host.nbytes / 2**30:.1f}, emit files {emit_bytes / 2**30:.1f}, 1 GiB spare)")
    if free < need:
        raise AssertionError(f"phase S1 needs {need} bytes of free disk under {root}, has {free}")
    out: dict = {"free_disk_bytes": free}
    t0 = time.perf_counter()
    np.save(root / "vectors.npy", host)
    out["write_input_s"] = time.perf_counter() - t0
    mm = np.load(root / "vectors.npy", mmap_mode="r")
    cents = ann.centroids.cpu().numpy()
    s1 = PartitionedANN(AnnConfig(), device=dev)
    t0 = time.perf_counter()
    with anon_rss_peak() as rss:
        s1.build_streaming(mm, reuse_centroids=cents, slab_rows=S1_SLAB_ROWS,
                           emit_dir=root / "ann.mmap.emit", device_resident=False)
    out["build_s"] = time.perf_counter() - t0
    out["stages_s"] = dict(s1.build_seconds)
    out["rss"] = rss
    if not s1._host_deferred or isinstance(s1.part_int8, torch.Tensor):
        raise AssertionError("build_streaming(device_resident=False) left tensors on the card")
    log(f"  input written in {out['write_input_s']:.1f} s; build_streaming {out['build_s']:.1f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in out["stages_s"].items())
        + "; " + rss_line(rss))

    # the first search promotes the arrays (counts reset just before)
    with kept_calls(sk, ("probe_candidates_cuda", "gather_rescore_cuda")) as calls:
        sk.reset_launch_counts()
        sv, si = s1.search(q, 10, nprobe=nprobe)
        torch.cuda.synchronize()
        launches = dict(sk.LAUNCHES)
    out["promote_s"] = s1.promote_seconds
    if launches["probe_candidates"] <= 0 or launches["gather_rescore"] <= 0:
        raise AssertionError(f"the streamed index's search did not run the probe and rescore kernels: "
                             f"{launches}")
    same = {
        "part_rows": torch.equal(s1.part_rows, ann.part_rows),
        "part_int8": torch.equal(s1.part_int8, ann.part_int8),
        "part_scale": torch.equal(s1.part_scale.view(torch.int32), ann.part_scale.view(torch.int32)),
        "centroids": torch.equal(s1.centroids, ann.centroids),
        "rescore_rows": rows_equal(torch, s1.corpus_bf16, ann.corpus_bf16, N),
    }
    out["bitwise"] = same
    out["segments"] = [[int(s.shape[0]) for s in a.corpus_bf16] for a in (ann, s1)]
    if not all(same.values()) or s1._replicated != ann._replicated:
        raise AssertionError(f"the streamed layout differs from phase A's build: {same}")
    if not (np.array_equal(sv.view(np.int32), gv.view(np.int32)) and np.array_equal(si, gi)):
        raise AssertionError("the streamed index serves other results than phase A's build")
    out["plain_err"] = hold_against_plain(torch, sk, calls)
    log(f"  first search promoted the arrays in {out['promote_s']:.1f} s; part_rows, part_int8, "
        f"part_scale, centroids and the {N} rescore rows bitwise phase A's build (rescore segments "
        f"{out['segments'][0]} vs {out['segments'][1]} rows); its results at nprobe {nprobe} bitwise "
        f"phase A's; launches on the stream_ann path {launches}; {held_summary(calls)} against the "
        f"plain versions: probe bitwise, rescore within {out['plain_err']['gather_rescore']:.3g}")
    del calls

    emit = root / "ann.mmap.emit"
    inodes = {f.name: f.stat().st_ino for f in emit.iterdir()}
    t0 = time.perf_counter()
    s1.save_dir(root / "ann.mmap")
    out["save_dir_s"] = time.perf_counter() - t0
    adopted = {f.name: f.stat().st_ino for f in (root / "ann.mmap").iterdir()}
    if emit.exists() or any(adopted.get(k) != v for k, v in inodes.items()):
        raise AssertionError("save_dir rewrote the emit files instead of adopting the directory")
    t0 = time.perf_counter()
    back = PartitionedANN.load_dir(root / "ann.mmap", device=dev)
    torch.cuda.synchronize()
    out["load_dir_s"] = time.perf_counter() - t0
    bv, bi = back.search(q, 10, nprobe=nprobe)
    if not (np.array_equal(bv.view(np.int32), sv.view(np.int32)) and np.array_equal(bi, si)):
        raise AssertionError("the adopted directory serves other results after load_dir")
    log(f"  save_dir adopted the emit directory by a rename in {out['save_dir_s']:.2f} s (phase A's "
        f"save_dir of the same arrays: {save_dir_s:.2f} s); load_dir {out['load_dir_s']:.1f} s serves "
        "the same results")
    del back, s1, mm
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return out, launches


#: phase B: cases in the store the pipeline builds from, and of them named
PIPE_CASES, PIPE_NAMES = 32_768, 4096


def pipeline_config(work: Path):
    """Phase B's config: its store and artifact paths under ``work``, mean
    pooling."""
    from trie_semantic_search_tpu_torch.core.config import Config

    cfg = Config()
    cfg.storage.db_path = str(work / "pipeline.sqlite")
    cfg.trie.index_path = str(work / "trie")
    cfg.vector.hnsw.index_path = str(work / "vec")
    cfg.vector.pooling = "mean"
    return cfg


def pipeline_phase(torch, np, seed: int, work: Path, keep: dict | None = None) -> dict:
    """Phase B, the build pipeline through the entry points a user calls:
    a sqlite store of ``PIPE_CASES`` fixture cases (four sentences each),
    ``build_indexes(storage, cfg, device="cuda")`` with mean pooling and no
    embedder (a corpus vocab and the seeded MiniLM-L6 at full width),
    ``save_artifacts``, ``load_artifacts(cfg, device="cuda")``, then
    ``SearchEngine.search_batch`` at B=8 and 64 over the loaded artifacts,
    which must return what an engine over the in-memory indexes returns,
    with name queries led by a case-name or exact hit. Every trie must
    have been built by the native host library. ``keep`` receives the
    in-memory build (phase P reads it)."""
    from trie_semantic_search_tpu_torch.core.types import CaseMetadata, SearchConfig
    from trie_semantic_search_tpu_torch.index.builder import build_indexes, load_artifacts, save_artifacts
    from trie_semantic_search_tpu_torch.search.engine import MatchType, SearchEngine, SearchQuery
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    cfg = pipeline_config(work)
    out: dict = {}
    t0 = time.perf_counter()
    write_cases_fast(cfg.storage.db_path,
                     fixture_cases(np, CaseMetadata, range(PIPE_CASES), PIPE_CASES, PIPE_NAMES, seed))
    out["store_s"] = time.perf_counter() - t0
    storage = StorageManager(cfg.storage)
    built = build_indexes(storage, cfg, device="cuda")
    torch.cuda.synchronize()
    out["trie_backend"] = require_native("phase B build_indexes", [built.trie.backend])[0]
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
        f"{out['trie_freeze_s']:.1f} + ANN build {ann_s:.1f} (P={out['partitions']} m={out['capacity']}); "
        f"trie builder {out['trie_backend']}")
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
    if keep is not None:
        keep.update(built=built, names=names)
    del in_memory, from_disk, loaded, built
    torch.cuda.empty_cache()
    return out


#: phase P: rows of phase A's corpus, queries, k; the chunked top-k's
#: chunks; query batch of the trie checks; texts embedded one by one
P_ROWS, P_QUERIES, P_K, P_CHUNKS, P_TRIE_B, P_EMBED = 1 << 20, 64, K, 8, 64, 8
#: phase P: the least cosine between a text embedded alone and its row of
#: an 8-text batch (bf16 encoder; the batches' shapes differ)
P_EMBED_MIN_COS = 0.999


def surface_phase(torch, np, seed: int, built, names: dict) -> dict:
    """Phase P, the rest of the public surface on the card at full width:
    ``brute_force_topk`` over the first ``P_ROWS`` rows of phase A's corpus
    (:func:`corpus_slabs`, drawn on the card again) for B=64 queries (rows
    plus noise) at k=32, equal to ``exact_topk(cosine_scores(...))``, also
    below a recall target of 1; ``chunked_topk`` over those scores equal to
    ``exact_topk``; ``segment_max_dedup`` of the top-k by case (four rows a
    case) on the card equal to its CPU result; over phase B's three tries
    (``built``), ``FrozenTrie.search_batch`` and ``walk_and_gather`` (the
    module function, with the postings' weights) on the card concatenated
    equal to ``TrieIndex.search_batch_rows``, the unranked
    ``walk_and_gather`` on the card equal to the CPU's; and
    ``VectorIndex.generate_embedding`` with a cold memo equal to
    ``generate_embeddings([text])`` bitwise and within ``P_EMBED_MIN_COS``
    of its row of an 8-text batch. Each op's time (CUDA events)."""
    from trie_semantic_search_tpu_torch.index.trie import TrieIndex, word_tokens
    from trie_semantic_search_tpu_torch.ops import scoring, topk, trie_kernels

    dev = torch.device("cuda")
    out: dict = {}
    t0 = time.perf_counter()
    parts = []
    for _, _, v in corpus_slabs(torch, P_PARTS, M_SLOTS, DIM, seed, dev):
        parts.append(v.reshape(-1, DIM))
        if sum(x.shape[0] for x in parts) >= P_ROWS:
            break
    corpus = torch.cat(parts)[:P_ROWS].contiguous()
    del parts
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    pick = torch.randint(0, P_ROWS, (P_QUERIES,), generator=g, device=dev)
    q = scoring.l2_normalize(corpus[pick] + 0.1 * torch.randn((P_QUERIES, DIM), generator=g, device=dev) / DIM**0.5)
    torch.cuda.synchronize()
    out["draw_s"] = time.perf_counter() - t0

    bv, bi = scoring.brute_force_topk(q, corpus, P_K)
    scores = scoring.cosine_scores(q, corpus)
    ev, ei = topk.exact_topk(scores, P_K)
    av, ai = scoring.brute_force_topk(q, corpus, P_K, recall_target=0.95)
    cv, ci = topk.chunked_topk(scores, P_K, num_chunks=P_CHUNKS)
    if not (torch.equal(bi, ei) and torch.equal(bv, ev) and torch.equal(ai, ei) and torch.equal(av, ev)):
        raise AssertionError("brute_force_topk differs from exact_topk(cosine_scores(...))")
    if not (torch.equal(ci, ei) and torch.equal(cv, ev)):
        raise AssertionError("chunked_topk differs from exact_topk")
    if not bool((bi == pick[:, None]).any(dim=1).all()):
        raise AssertionError("a query's own row is not in its brute-force top-k")
    out["brute_ms"] = cuda_ms(torch, lambda: scoring.brute_force_topk(q, corpus, P_K), 5)
    out["chunked_ms"] = cuda_ms(torch, lambda: topk.chunked_topk(scores, P_K, num_chunks=P_CHUNKS), 5)
    out["exact_ms"] = cuda_ms(torch, lambda: topk.exact_topk(scores, P_K), 5)
    del scores

    seg = (bi // CHUNKS_PER_CASE).to(torch.int32)
    seg[:, ::7] = -1  # invalid ids
    n_seg = P_ROWS // CHUNKS_PER_CASE
    dd = topk.segment_max_dedup(bv, seg, n_seg)
    dd_cpu = topk.segment_max_dedup(bv.cpu(), seg.cpu(), n_seg)
    if not torch.equal(dd.cpu(), dd_cpu):
        raise AssertionError("segment_max_dedup on the card differs from the CPU's")
    kept = int(torch.isfinite(dd).sum())
    out.update(dedup_kept=kept, dedup_ms=cuda_ms(torch, lambda: topk.segment_max_dedup(bv, seg, n_seg), 5))
    log(f"  {P_ROWS} of phase A's rows (D={DIM}) drawn on the card in {out['draw_s']:.1f} s; B={P_QUERIES} "
        f"k={P_K}: brute_force_topk (also at recall_target 0.95) equal to exact_topk(cosine_scores), "
        f"{out['brute_ms']:.2f} ms; chunked_topk ({P_CHUNKS} chunks) equal to exact_topk, "
        f"{out['chunked_ms']:.2f} ms (exact_topk {out['exact_ms']:.2f} ms); segment_max_dedup over "
        f"{n_seg} cases on the card equal to the CPU's ({kept} of {dd.numel()} kept), {out['dedup_ms']:.3f} ms")
    del corpus, q, bv, bi, ev, ei, av, ai, cv, ci, dd

    trie = built.trie
    rng = np.random.default_rng(seed + 13)
    named = sorted(names)[:8]
    texts = (texts_for(rng, names, WORDS, P_TRIE_B - 16) + [citation(c) for c in named]
             + [" ".join(case_text(c).split()[6:10]) for c in named])  # names, words, citations, phrases
    want_rows, want_valid = trie.search_batch_rows(texts)
    B = len(texts)
    Bpad = max(8, 1 << (B - 1).bit_length())
    pad = [[] for _ in range(Bpad - B)]
    lower = [word_tokens(t) for t in texts] + pad
    raw = [t.split() for t in texts] + pad
    got_r, got_v, mod_r, mod_v, nodes = [], [], [], [], 0
    for f, toks, prefix in ((trie.name_trie, lower, False), (trie.citation_trie, raw, False),
                            (trie.content_trie, lower, True)):
        ids = f.encode_queries(toks, TrieIndex.MAX_QUERY_TOKENS)
        n, r, v = f.search_batch(ids, 64, prefix, device=dev)
        if not np.array_equal(f.walk(ids, device=dev), n):
            raise AssertionError("FrozenTrie.walk differs from search_batch's nodes")
        a = f.device(dev)
        mn, mr, mv = trie_kernels.walk_and_gather(
            None, None, a["edge_targets"], a["post_offsets"], a["post_rows"], a["is_end"],
            torch.as_tensor(ids, device=dev), 64, keys=(a["edge_keys"], a["key_mult"]),
            post_weight=a["post_weight"], subtree_end=a["subtree_end"] if prefix else None)
        got_r.append(r)
        got_v.append(v)
        mod_r.append(mr.cpu().numpy())
        mod_v.append(mv.cpu().numpy())
        t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
        cpu = trie_kernels.walk_and_gather(t(f.edge_offsets), t(f.edge_tokens), t(f.edge_targets),
                                           t(f.post_offsets), t(f.post_case), t(f.is_end), t(ids), 64)
        card = trie_kernels.walk_and_gather(*(x.to(dev) for x in (
            t(f.edge_offsets), t(f.edge_tokens), t(f.edge_targets), t(f.post_offsets), t(f.post_case),
            t(f.is_end), t(ids))), 64)
        if not all(torch.equal(x.cpu(), y) for x, y in zip(card, cpu)):
            raise AssertionError("walk_and_gather on the card differs from the CPU's")
        nodes += int((n >= 0).sum())
    for rows, valid, what in ((got_r, got_v, "FrozenTrie.search_batch"), (mod_r, mod_v, "walk_and_gather")):
        if not (np.array_equal(np.concatenate(rows, 1)[:B], want_rows)
                and np.array_equal(np.concatenate(valid, 1)[:B], want_valid)):
            raise AssertionError(f"{what} over phase B's tries differs from TrieIndex.search_batch_rows")
    out.update(trie_queries=B, trie_hits=int(want_valid.sum()), trie_nodes=nodes)
    log(f"  phase B's three tries, {B} queries: FrozenTrie.search_batch and walk_and_gather (weighted) on "
        f"the card equal TrieIndex.search_batch_rows ({out['trie_hits']} postings); FrozenTrie.walk equal "
        "to their nodes; the unranked walk_and_gather on the card equal to the CPU's")

    vec = built.vector
    etexts = [f"{names[c]} {case_text(c)}" for c in sorted(names)[:P_EMBED]]
    vec.cache = type(vec.cache)(max_size=1000)
    ones = [vec.generate_embedding(t) for t in etexts]
    vec.cache = type(vec.cache)(max_size=1000)
    singles = [vec.generate_embeddings([t])[0] for t in etexts]
    vec.cache = type(vec.cache)(max_size=1000)
    batch = vec.generate_embeddings(etexts)
    if not all(np.array_equal(a, b) for a, b in zip(ones, singles)):
        raise AssertionError("generate_embedding differs from generate_embeddings([text])")
    cos = float(min(float(np.dot(a, b)) for a, b in zip(ones, batch)))
    diff = float(max(np.abs(a - b).max() for a, b in zip(ones, batch)))
    if cos < P_EMBED_MIN_COS or any(vec.generate_embedding(t) is None for t in etexts):
        raise AssertionError(f"generate_embedding vs its row of an {P_EMBED}-text batch: cosine {cos}")
    out.update(embed_min_cos=cos, embed_max_diff=diff, embedder_stats=vec.embedder.get_stats())
    log(f"  VectorIndex.generate_embedding of {P_EMBED} texts (cold memo) equal to generate_embeddings([text]) "
        f"bitwise; against their rows of one {P_EMBED}-text batch: least cosine {cos:.6f} (bound "
        f"{P_EMBED_MIN_COS}), largest difference {diff:.3g}; Embedder.get_stats {out['embedder_stats']}")
    torch.cuda.empty_cache()
    return out


#: phase S2: shards in the killed build's manifest before the SIGKILL; the
#: vectors' tolerance against phase B's (the port's tests hold a streamed
#: build's vectors against a one-shot build's within it)
S2_KILL_SHARDS, S2_VECTOR_TOL = 6, 1e-5


def streaming_cli_killed(toml: Path, wd: Path, shards: int, log_path: Path, keep: Path,
                         extra: tuple[str, ...] = (), limit: float = 600.0) -> tuple[float, float, int]:
    """``cli build-index --streaming --work-dir wd *extra`` as a
    subprocess, SIGKILLed once its manifest records ``shards`` shards; its
    log goes to ``log_path`` and is copied to ``keep``. Returns the start
    and kill times and its exit code."""
    import signal

    from trie_semantic_search_tpu_torch.index.streaming import _Manifest

    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "trie_semantic_search_tpu_torch.cli", "-c", str(toml), "build-index",
             "--streaming", "--work-dir", str(wd), *extra], cwd=HERE, stdout=logf,
            stderr=subprocess.STDOUT)
    try:
        while len(_Manifest.load(wd / "manifest.json").shards) < shards:
            if proc.poll() is not None:
                raise AssertionError(f"build-index --streaming exited {proc.returncode} before "
                                     f"{shards} shards: {log_path.read_text()[-3000:]}")
            if time.perf_counter() - t0 > limit:
                raise AssertionError(f"no {shards} shards within {limit:.0f} s")
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        t_kill = time.perf_counter()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.copy(log_path, keep)
    return t0, t_kill, proc.returncode


def engine_vs_oracle(np, cfg, storage, steps: list[dict], nprobe: int, out: dict):
    """Over the saved artifacts: ``load_artifacts`` and ``SearchEngine``,
    then the tuner's probes through ``search_batch`` (``min_similarity``
    -1), each top 10 cases against the exact case-level oracle's, beside
    the ANN alone at the tuned ``nprobe`` from the sweep's ``steps``. The
    figures go to ``out``; returns the engine and the loaded artifacts."""
    from trie_semantic_search_tpu_torch.core.types import SearchConfig
    from trie_semantic_search_tpu_torch.index import tuning
    from trie_semantic_search_tpu_torch.index.builder import load_artifacts
    from trie_semantic_search_tpu_torch.search.engine import SearchEngine, SearchQuery

    t0 = time.perf_counter()
    trie, vector, columns = load_artifacts(cfg, device="cuda")
    engine = SearchEngine(cfg, storage, trie, vector, columns, device="cuda")
    out["load_s"] = time.perf_counter() - t0
    texts, embs = tuner_probes(storage, cfg, vector)
    chunk_case = np.asarray(vector.refs)[:, 0]
    oracle = tuning.case_level_oracle(vector.vectors, chunk_case, embs, 10)
    res = engine.search_batch([SearchQuery(query=t, config=SearchConfig(min_similarity=-1.0)) for t in texts])
    row_of = columns.row_of_case
    eng = [len({row_of[x.case_metadata.id] for x in rs} & set(o)) / len(o) for rs, o in zip(res, oracle)]
    at_pick = next(st for st in steps if st["nprobe"] == nprobe)
    out.update(probes=len(texts), engine_overlap_mean=float(np.mean(eng)),
               engine_overlap_min=float(np.min(eng)), ann_recall_mean=at_pick["mean"],
               ann_recall_min=at_pick["min"])
    log(f"  load_artifacts {out['load_s']:.1f} s; the tuner's {len(texts)} probes through "
        f"SearchEngine.search_batch at B={len(texts)}: top 10 cases vs the exact case-level oracle, "
        f"overlap mean {out['engine_overlap_mean']:.4f} min {out['engine_overlap_min']:.4f} (the ANN "
        f"alone at nprobe {nprobe}: mean {at_pick['mean']:.4f} min {at_pick['min']:.4f})")
    return engine, trie, vector, columns


def stream_build_phase(torch, np, sk, work: Path, out_dir: Path) -> tuple[dict, dict, dict]:
    """Phase S2, the operator's streaming build over phase B's store, killed
    and resumed. Phase B's saved encoder is copied into a new vector
    directory (so nothing is pretrained); ``cli build-index --streaming``
    runs as a subprocess (shards of 8,192 chunks, content spill on,
    ``tune_on_build`` on) and gets SIGKILL once its manifest records
    ``S2_KILL_SHARDS`` shards; ``StreamingIndexBuilder(...).build(resume=
    True)`` then finishes it in this process (launch counts reset just
    before, read just after: path ``stream_build``; every probe and rescore
    call of its tuner held against the plain versions, the pick checked
    against the sweep's steps). Checks: it resumed past row 0 and embedded
    only the chunks after the watermark; the three tries (the content trie
    spill-built) are bitwise phase B's, the refs equal, the vectors within
    ``S2_VECTOR_TOL``. Over the loaded artifacts: the tuner's probes
    through ``SearchEngine`` at B=64 against the exact case-level oracle;
    ``evaluate_engine`` and ``evaluate_stages`` in this process (path
    ``eval``, every call held); ``eval-retrieval --control`` as
    subprocesses over phase B's and the streamed artifacts. Returns the
    details and the launch counts of both paths."""
    import concurrent.futures

    from trie_semantic_search_tpu_torch.core.config import Config
    from trie_semantic_search_tpu_torch.index.streaming import StreamingIndexBuilder, _Manifest
    from trie_semantic_search_tpu_torch.index.trie import TrieIndex
    from trie_semantic_search_tpu_torch.models import quality
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    root = work / "s2"
    (root / "vec").mkdir(parents=True)
    shutil.copy(work / "vec" / "tokenizer.json", root / "vec" / "tokenizer.json")
    shutil.copytree(work / "vec" / "encoder", root / "vec" / "encoder")
    cfg = Config()
    cfg.storage.db_path = str(work / "pipeline.sqlite")
    cfg.trie.index_path = str(root / "trie")
    cfg.vector.hnsw.index_path = str(root / "vec")
    toml = root / "config.toml"
    cfg.save_to_file(toml)
    wd = root / "work"
    out: dict = {}

    t0, t_kill, rc = streaming_cli_killed(toml, wd, S2_KILL_SHARDS, root / "build.log",
                                          out_dir / "s2_build.log")
    at_kill = _Manifest.load(wd / "manifest.json")
    out.update(killed_after_s=t_kill - t0, returncode=rc, kill_shards=len(at_kill.shards),
               kill_row=at_kill.next_row, kill_chunks=at_kill.chunks,
               killed_backends=require_native("S2's killed build-index --streaming",
                                              trie_backends((root / "build.log").read_text())))
    log(f"  build-index --streaming SIGKILLed {out['killed_after_s']:.1f} s after its start (exit "
        f"{rc}); the manifest records {len(at_kill.shards)} shards, watermark row "
        f"{at_kill.next_row}, {at_kill.chunks} chunks; checkpoint {at_kill.trie_ckpt}")

    storage = StorageManager(cfg.storage)
    sb = StreamingIndexBuilder(storage, cfg, work_dir=wd, device="cuda")
    embedded: list[int] = []
    write = sb._write_shard

    def counted(manifest, texts, refs):
        embedded.append(len(texts))
        write(manifest, texts, refs)

    sb._write_shard = counted
    with (logged_records("tss_torch.index.tuning") as records,
          logged_records("tss_torch.spill") as spilled,
          kept_calls(sk, ("probe_candidates_cuda", "gather_rescore_cuda")) as calls):
        sk.reset_launch_counts()
        t_resume = time.perf_counter()
        built = sb.build(resume=True)
        torch.cuda.synchronize()
        launches = dict(sk.LAUNCHES)
    routes = [m.getMessage().rsplit(", ", 1)[1].rstrip(")") for m in spilled
              if m.getMessage().startswith("spill finalize")]
    out["trie_backend"] = require_native("S2's resumed build", [built.trie.backend])[0]
    out["csr_route"] = require_native("S2's spill CSR pass", routes)[0]
    out["kill_to_resume_s"] = t_resume - t_kill
    out["resume_s"] = time.perf_counter() - t_resume
    r, ann = built.report, built.vector.ann
    out.update(cases=r.cases, chunks=r.content_chunks, shards=r.shards,
               resumed_from_row=r.resumed_from_row, embedded_chunks=r.embedded_chunks,
               chunks_per_s=r.chunks_per_second, embed_s=r.embed_seconds, finalize_s=r.finalize_seconds,
               peak_rss_bytes=r.peak_rss_bytes, peak_anon_rss_bytes=r.peak_anon_rss_bytes,
               partitions=int(ann.part_rows.shape[0]), capacity=int(ann.part_rows.shape[1]),
               nprobe=ann.tuned_nprobe, launches=launches)
    if not (0 < r.resumed_from_row == at_kill.next_row and r.cases == PIPE_CASES
            and r.content_chunks == CHUNKS_PER_CASE * PIPE_CASES
            and sum(embedded) == r.embedded_chunks == r.content_chunks - at_kill.chunks):
        raise AssertionError(f"resume: from row {r.resumed_from_row} (watermark {at_kill.next_row}), "
                             f"{r.cases} cases, {r.content_chunks} chunks, embedded {sum(embedded)} "
                             f"({r.embedded_chunks} reported; {at_kill.chunks} before the kill)")
    fin = r.finalize_seconds
    log(f"  resumed {out['kill_to_resume_s']:.1f} s after the kill from row {r.resumed_from_row}: "
        f"{r.cases} cases, {r.content_chunks} chunks in {r.shards} shards, embedded only the "
        f"{r.embedded_chunks} chunks after the watermark ({r.chunks_per_second:.0f} chunks/s, embed "
        f"{r.embed_seconds:.1f} s); build {out['resume_s']:.1f} s, of which the finalize: spill run sort "
        f"{fin['run_sort']:.2f} s, merge {fin['merge']:.2f} s, CSR {fin['csr']:.2f} s; store fill "
        f"{fin['store_fill']:.2f} s; ANN {fin['ann']:.2f} s (P={out['partitions']} m={out['capacity']}); "
        f"tune {fin.get('tune', 0.0):.2f} s; peak RSS {r.peak_rss_bytes / 2**30:.2f} GiB, anonymous "
        + (f"{r.peak_anon_rss_bytes / 2**30:.2f} GiB" if r.peak_anon_rss_bytes else "not measured")
        + f"; trie builders {out['trie_backend']} (the killed build's {out['killed_backends']}), spill CSR "
        f"pass {out['csr_route']}")
    oracle_s, steps, settled = tuner_steps(records)
    out.update(sweep=steps, settled=settled, tune_oracle_s=oracle_s,
               rule=check_pick(steps, ann.tuned_nprobe, 0.95, cfg.vector.hnsw.tune_min_recall or None))
    if launches["probe_candidates"] <= 0 or launches["gather_rescore"] <= 0:
        raise AssertionError(f"the resumed build's tuner did not run the probe and rescore kernels: "
                             f"{launches}")
    out["plain_err"] = hold_against_plain(torch, sk, calls)
    log(f"  tuned nprobe {ann.tuned_nprobe} in {len(steps)} steps ({out['rule']}); launches on the "
        f"stream_build path {launches}; the tuner's {held_summary(calls)} against the plain "
        f"versions: probe bitwise, rescore within {out['plain_err']['gather_rescore']:.3g}")
    del calls

    ref = TrieIndex.load_from_disk(work / "trie", cfg.trie, device="cpu")
    for name in ("name_trie", "content_trie", "citation_trie"):
        a, b = getattr(built.trie, name), getattr(ref, name)
        if a.vocab != b.vocab or not all(np.array_equal(getattr(a, f), getattr(b, f))
                                         for f in a._ARRAY_FIELDS):
            raise AssertionError(f"the streamed {name} differs from phase B's")
    with np.load(work / "vec" / "refs.npz") as z:
        if not np.array_equal(np.asarray(built.vector.refs), z["refs"]):
            raise AssertionError("the streamed refs differ from phase B's")
    vb, va, step = np.load(work / "vec" / "vectors.npy", mmap_mode="r"), built.vector.vectors, 1 << 16
    if va.shape != vb.shape:
        raise AssertionError(f"the streamed vectors are {va.shape}, phase B's {vb.shape}")
    out["vector_max_diff"] = max(float(np.abs(va[lo : lo + step] - vb[lo : lo + step]).max())
                                 for lo in range(0, len(vb), step))
    if not out["vector_max_diff"] <= S2_VECTOR_TOL:
        raise AssertionError(f"the streamed vectors differ from phase B's by {out['vector_max_diff']}")
    log(f"  name, content (spill-built) and citation tries bitwise phase B's, refs equal, vectors "
        f"within {out['vector_max_diff']:.3g} of phase B's (tolerance {S2_VECTOR_TOL})")

    engine, trie, vector, columns = engine_vs_oracle(np, cfg, storage, steps, ann.tuned_nprobe, out)

    tp = engine._text_processor
    docs = []
    for row, _meta, text in storage.iter_cases_rowid():
        if len(docs) >= 2000:
            break
        if text:
            docs.append((row, tp.extract_sentences(tp.normalize_text(text))))
    probes = quality.build_probes(docs, max_probes=256)
    with kept_calls(sk, ("probe_candidates_cuda", "gather_rescore_cuda")) as calls:
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        trained = quality.evaluate_engine(engine, columns, probes)
        stages = quality.evaluate_stages(engine, columns, probes)
        torch.cuda.synchronize()
        eval_launches = dict(sk.LAUNCHES)
    out["eval"] = dict(seconds=time.perf_counter() - t0, probes=len(probes), trained=trained, stages=stages,
                       launches=eval_launches)
    if eval_launches["probe_candidates"] <= 0 or eval_launches["gather_rescore"] <= 0:
        raise AssertionError(f"the evaluation did not run the probe and rescore kernels: {eval_launches}")
    out["eval"]["plain_err"] = hold_against_plain(torch, sk, calls)
    log(f"  evaluate_engine + evaluate_stages of {len(probes)} probes in {out['eval']['seconds']:.1f} s: "
        f"engine MRR {trained['all']['mrr']}, exact_full {stages['exact_full']['all']['mrr']}, ann_only "
        f"{stages.get('ann_only', {}).get('all', {}).get('mrr')} at nprobe {stages['tuned_nprobe']}; "
        f"launches on the eval path {eval_launches}; {held_summary(calls)} against the plain "
        f"versions: probe bitwise, rescore within {out['eval']['plain_err']['gather_rescore']:.3g}")
    del calls, engine, trie, vector, columns, built, sb
    storage.close()
    torch.cuda.empty_cache()

    bcfg = Config.from_file(toml)
    bcfg.trie.index_path, bcfg.vector.hnsw.index_path = str(work / "trie"), str(work / "vec")
    btoml = root / "phase_b.toml"
    bcfg.save_to_file(btoml)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = {k: pool.submit(run_cli, ["eval-retrieval", "--control"], t, 600)
                for k, t in (("phase_b", btoml), ("streamed", toml))}
        evals = {k: (json.loads(j.result()[0]), j.result()[1]) for k, j in jobs.items()}
    out["eval_retrieval"] = {k: dict(v, seconds=s) for k, (v, s) in evals.items()}
    for k, (e, sec) in evals.items():
        st = e["stages"]
        log(f"  eval-retrieval --control over the {k} artifacts ({sec:.1f} s, {e['probes']} probes): "
            f"trained MRR {e['trained']['all']['mrr']} recall@10 {e['trained']['all']['recall_at_10']}; "
            f"stages exact_full {st['exact_full']['all']['mrr']}, ann_only "
            f"{st.get('ann_only', {}).get('all', {}).get('mrr')} at tuned nprobe {st['tuned_nprobe']}; "
            f"trained_direct {e['trained_direct']['all']['mrr']}, random_control "
            f"{e['random_control']['all']['mrr']}")
    shutil.rmtree(wd)
    return out, launches, eval_launches


#: phase I: fixture cases fed to ingest by default (each row % 16 == 0 has
#: no court and fails validation; one in eight is named); planted rejects
#: and duplicates. The duplicate check scans the whole table twice per
#: stored case, so the ingest time grows with the square of the count:
#: 8,192 cases keep the script inside its time limit (with
#: ``--ingest-cases 16384`` it ran 1,151 s on an H100 host, phase I 661 s).
#: At 4,096 the tuned build's ANN has m = 320 slots, off the probe
#: kernel's 128-slot rule, so its tuner would run no kernel
ING_CASES, ING_PLANTED = 8192, 64
#: payloads the second ``ingest_bulk`` feeds again (each is checked
#: against the whole table twice, so all of them took 45-70 s)
ING_REINGEST = 1024
#: phase I: duplicate-check scans timed on the table at the end of each
#: eighth of the ingest
ING_SCANS = 20
#: phase I: the tuner's target case recall@10
ING_TUNE_RECALL = 0.95


def ingest_cases(np, CaseMetadata, n_cases: int, seed: int) -> tuple[list, int]:
    """Phase I's payloads: the fixture cases of rows ``0 .. n_cases - 1``
    (the names, citations and texts :func:`fixture_cases` makes, one in
    eight named) under new ids; ``ING_PLANTED`` cases that fail validation (half with a text under
    the 100 characters, half dated a year ahead) spread over the run; and
    ``ING_PLANTED`` exact copies, under new ids, of cases that pass, each
    at least 500 cases after its original. Returns the payloads and the
    number of fixture cases that must fail (no court)."""
    cases = list(fixture_cases(np, CaseMetadata, range(n_cases), n_cases, n_cases // 8, seed))
    for c, (meta, _) in enumerate(cases):
        meta.id = uuid.UUID(int=(9 << 96) + c)
    rng = np.random.default_rng(seed + 11)
    courtless = sum(1 for meta, _ in cases if not meta.court)
    originals = rng.choice([c for c in range(n_cases - 600) if cases[c][0].court], ING_PLANTED,
                           replace=False)
    dups = {}
    for i, c in enumerate(originals):
        meta, text = cases[c]
        copy = CaseMetadata(id=uuid.UUID(int=(10 << 96) + i), name=meta.name, citation=meta.citation,
                            court=meta.court, decision_date=meta.decision_date,
                            word_count=meta.word_count)
        dups.setdefault(int(c) + 500, []).append((copy, text))
    future = dt.date.today() + dt.timedelta(days=365)
    bad = {}
    for i in range(ING_PLANTED):
        short = i % 2 == 0
        meta = CaseMetadata(id=uuid.UUID(int=(11 << 96) + i), name=f"Rejected filing {i}",
                            citation=f"{i + 1} F. {i + 7} (2001)", court=COURTS[1 + i % 15],
                            decision_date=dt.date(2001, 1, 1) if short else future)
        bad[(i * n_cases) // ING_PLANTED] = (meta, "Too short." if short else case_text(i))
    out = []
    for c, payload in enumerate(cases):
        out.append(payload)
        out.extend(dups.get(c, []))
        if c in bad:
            out.append(bad[c])
    return out, courtless


def tuner_probes(storage, cfg, vector) -> tuple[list[str], object]:
    """The tuner's probes as ``build_indexes`` makes them: the texts that
    ``tuning.build_probe_embeddings`` embeds with ``vector``'s encoder, and
    their embeddings."""
    from trie_semantic_search_tpu_torch.index import tuning
    from trie_semantic_search_tpu_torch.text.processor import TextProcessor

    texts: list[str] = []

    def embed(batch):
        texts.extend(batch)
        return vector.generate_embeddings(batch)

    return texts, tuning.build_probe_embeddings(storage, TextProcessor(cfg.text_processing), embed)


def ingest_phase(torch, np, sk, n_cases: int, seed: int, work: Path) -> tuple[dict, dict]:
    """Phase I, the operator's pipeline from an empty store: the payloads
    of :func:`ingest_cases` (``n_cases`` fixture cases) through
    ``IngestionManager.ingest_bulk("mock")`` (a ``MockDataSource``) into a
    fresh store and cache directory, with the ``[ingestion]`` defaults but
    no pause between batches; the counts checked against the fixture; one
    duplicate check timed at each eighth (left out of the rates); a second
    ``ingest_bulk`` of the first ``ING_REINGEST`` payloads, which must store
    nothing and skip as duplicates those that passed validation; then
    ``build_indexes(tune_recall=0.95, device="cuda")`` over the ingested
    store (launch counts reset just before, read just after: path
    ``tune``), the sweep's steps and routes, the pick checked against them
    and every probe and rescore call of the sweep against its plain
    version, the tuned nprobe's case recall@10 against the oracle (equal to
    the sweep's at that step), the probes served through
    ``SearchEngine.search_batch`` at B=64, and ``save_artifacts`` →
    ``load_artifacts``, which must keep the tuned nprobe and serve name
    queries their case first. Returns the details and the ``tune``
    launch counts."""
    import asyncio

    from trie_semantic_search_tpu_torch.core.config import Config
    from trie_semantic_search_tpu_torch.core.types import CaseMetadata, SearchConfig
    from trie_semantic_search_tpu_torch.index import tuning
    from trie_semantic_search_tpu_torch.index.builder import build_indexes, load_artifacts, save_artifacts
    from trie_semantic_search_tpu_torch.ingest import IngestionManager, JobStatus
    from trie_semantic_search_tpu_torch.ingest.sources import MockDataSource
    from trie_semantic_search_tpu_torch.search.engine import SearchEngine, SearchQuery
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    cfg = Config()
    cfg.storage.db_path = str(work / "ingest.sqlite")
    cfg.trie.index_path = str(work / "ingest_trie")
    cfg.vector.hnsw.index_path = str(work / "ingest_vec")
    cfg.vector.pooling = "mean"
    cfg.ingestion.cache.disk_cache_path = str(work / "ingest_cache")
    cfg.ingestion.rate_limit_delay_ms = 0
    ing = cfg.ingestion
    out: dict = {"settings": dict(
        batch_size=ing.batch_size, max_concurrent_jobs=ing.max_concurrent_jobs,
        rate_limit_delay_ms=ing.rate_limit_delay_ms, retry_attempts=ing.retry_attempts,
        max_memory_usage_mb=ing.max_memory_usage_mb, validation=dataclasses.asdict(ing.validation),
        cache=dataclasses.asdict(ing.cache))}
    log(f"  [ingestion] settings: {out['settings']}")
    payloads, courtless = ingest_cases(np, CaseMetadata, n_cases, seed)
    fed = len(payloads)
    storage = StorageManager(cfg.storage)
    mgr = IngestionManager(cfg, storage)
    mgr.register_source(MockDataSource(cases=payloads))
    marks: list[tuple[float, int]] = []  # each batch's end (scans left out) and size
    scans: list[tuple[int, float]] = []  # (stored rows, ms a duplicate check) at each eighth
    spent = [0.0]  # seconds of those scans
    batch_run = mgr.pipeline._process_batch

    async def timed_batch(batch):  # no worker runs between two batches
        await batch_run(batch)
        marks.append((time.perf_counter() - spent[0], len(batch)))
        if len(scans) < 8 and sum(n for _, n in marks) >= (len(scans) + 1) * fed / 8:
            t = time.perf_counter()
            for i in range(ING_SCANS):  # misses: each scans every row
                storage.find_case_id(f"no such case {i}", "")
            ms = (time.perf_counter() - t) / ING_SCANS * 1e3
            scans.append((storage.get_stats().total_cases, ms))
            spent[0] += time.perf_counter() - t

    mgr.pipeline._process_batch = timed_batch

    async def twice():  # one event loop: the pipeline's semaphore binds to it
        t0 = time.perf_counter()
        job = await mgr.ingest_bulk("mock")
        t1 = time.perf_counter()
        first = mgr.pipeline.stats
        mgr.register_source(MockDataSource(cases=payloads[:ING_REINGEST]))
        again = await mgr.ingest_bulk("mock")
        return job, first, again, t0, t1, time.perf_counter()

    job, first, again, t0, t1, t2 = asyncio.run(twice())
    t1 -= spent[0]
    out["ingest_s"], out["reingest_s"] = t1 - t0, t2 - spent[0] - t1
    marks = [mk for mk in marks if mk[0] <= t1]
    done, rates, t_prev, n_prev = 0, [], t0, 0
    for t, n in marks:
        done += n
        if done >= (len(rates) + 1) * fed / 8:
            rates.append((done - n_prev) / (t - t_prev))
            t_prev, n_prev = t, done
    stored = storage.get_stats().total_cases
    want = dict(processed=n_cases - courtless, failed_validation=courtless + ING_PLANTED,
                skipped_duplicates=ING_PLANTED, failed_processing=0)
    have = {k: getattr(first, k) for k in want}
    out.update(fed=fed, job_status=job.status.value, counts=have, stored=stored,
               cases_per_s=fed / out["ingest_s"], eighth_cases_per_s=rates, cache_hits=first.cache_hits,
               cache=dataclasses.asdict(mgr.cache.get_stats()), eighth_scans=scans, scan_ms=scans[-1][1])
    log(f"  ingest_bulk of {fed} cases in {out['ingest_s']:.1f} s ({out['cases_per_s']:.1f} cases/s; "
        f"by eighth: {', '.join(f'{r:.1f}' for r in rates)}); job {job.status.value}, {have}, "
        f"{stored} stored; pipeline cache hits {first.cache_hits}; cache {out['cache']}")
    log("  one duplicate check (find_case_id, a miss) at the end of each eighth: " + ", ".join(
        f"{rows} rows {ms:.3f} ms ({ms * 1e6 / max(rows, 1):.0f} ns a row)" for rows, ms in scans))
    if job.status != JobStatus.COMPLETED or have != want or stored != want["processed"]:
        raise AssertionError(f"ingest: job {job.status.value} {job.error}, counts {have} (want {want}), "
                             f"{stored} stored")
    second = {k: getattr(mgr.pipeline.stats, k) for k in want}
    out["reingest_counts"] = second
    again_fed = payloads[:ING_REINGEST]
    passed = sum(1 for meta, _ in again_fed if meta.court and meta.id.int >> 96 != 11)
    log(f"  ingest_bulk of the first {len(again_fed)} payloads again in {out['reingest_s']:.1f} s: job "
        f"{again.status.value}, {second} ({passed} of them passed validation)")
    if (again.status != JobStatus.COMPLETED or second["processed"]
            or second["skipped_duplicates"] != passed
            or second["failed_validation"] != len(again_fed) - passed
            or storage.get_stats().total_cases != stored):
        raise AssertionError(f"the second ingest stored something or skipped other cases: {second}")

    with (logged_records("tss_torch.index.tuning") as records,
          kept_calls(sk, ("probe_candidates_cuda", "gather_rescore_cuda")) as calls):
        sk.reset_launch_counts()
        built = build_indexes(storage, cfg, tune_recall=ING_TUNE_RECALL, device="cuda")
        torch.cuda.synchronize()
        launches = dict(sk.LAUNCHES)
    out["trie_backend"] = require_native("phase I build_indexes", [built.trie.backend])[0]
    r, ann = built.report, built.vector.ann
    oracle_s, steps, settled = tuner_steps(records)
    ann_s = sum(ann.build_seconds.values())
    nprobe = ann.tuned_nprobe
    out.update(build_s=r.seconds, vocab_s=r.vocab_seconds, embed_s=r.embed_seconds,
               text_and_trie_s=r.seconds - r.vocab_seconds - r.embed_seconds - r.freeze_seconds
               - r.tune_seconds, trie_freeze_s=r.freeze_seconds - ann_s, ann_build_s=ann_s,
               tune_s=r.tune_seconds, tune_probe_s=r.tune_probe_seconds, tune_oracle_s=oracle_s,
               tune_sweep_s=sum(st["s"] for st in steps), chunks=ann.num_vectors,
               partitions=int(ann.part_rows.shape[0]), capacity=int(ann.part_rows.shape[1]),
               sweep=steps, settled=settled, nprobe=nprobe, launches=launches)
    log(f"  build_indexes(tune_recall={ING_TUNE_RECALL}) {r.seconds:.1f} s = vocab {r.vocab_seconds:.1f} + "
        f"text processing and trie inserts {out['text_and_trie_s']:.1f} + embed {r.embed_seconds:.1f} "
        f"({ann.num_vectors / r.embed_seconds:.0f} chunks/s) + trie freeze {out['trie_freeze_s']:.1f} + "
        f"ANN build {ann_s:.1f} (P={out['partitions']} m={out['capacity']}) + tune "
        f"{r.tune_seconds:.2f} (probe embedding {r.tune_probe_seconds:.2f}, oracle {oracle_s:.2f}, "
        f"sweep {out['tune_sweep_s']:.2f})")
    for st in steps:
        log(f"    nprobe {st['nprobe']:5d} route {st['route']:6s} case recall@10 mean {st['mean']:.4f} "
            f"min {st['min']:.4f} tie-aware min {st['tie_min']:.4f}  {st['s']:.3f} s")
    out["rule"] = check_pick(steps, nprobe, ING_TUNE_RECALL, cfg.vector.hnsw.tune_min_recall or None)
    log(f"  launches on the tune path: {launches}; the pick follows from the steps ({out['rule']})"
        f"{'; ' + settled[0] if settled else ''}")
    if launches["probe_candidates"] <= 0 or launches["gather_rescore"] <= 0:
        raise AssertionError(f"the tuned build did not run the probe and rescore kernels: {launches}")
    out["plain_err"] = hold_against_plain(torch, sk, calls)
    log(f"  the sweep's {held_summary(calls)} against the plain versions: probe bitwise equal, "
        f"rescore within {out['plain_err']['gather_rescore']:.3g}")
    del calls

    texts, embs = tuner_probes(storage, cfg, built.vector)
    chunk_case = np.asarray(built.vector.refs)[:, 0]
    oracle = tuning.case_level_oracle(built.vector.vectors, chunk_case, embs, 10)
    served = tuning._served_cases(ann, chunk_case, embs, 10, nprobe)
    per = [len(set(s) & set(o)) / len(o) for s, o in zip(served, oracle)]
    at_pick = next(st for st in steps if st["nprobe"] == nprobe)
    if (float(np.mean(per)), float(np.min(per))) != (at_pick["mean"], at_pick["min"]):
        raise AssertionError(f"case recall@10 at nprobe {nprobe} is {np.mean(per)} mean, {np.min(per)} "
                             f"min over the tuner's probes; the sweep measured {at_pick}")
    engine = SearchEngine(cfg, storage, built.trie, built.vector, built.columns, device="cuda")
    qs = [SearchQuery(query=t, config=SearchConfig(min_similarity=-1.0)) for t in texts]
    t0 = time.perf_counter()
    res = engine.search_batch(qs)
    out["engine_B64_ms"] = (time.perf_counter() - t0) * 1e3
    row_of = built.columns.row_of_case
    eng = [len({row_of[x.case_metadata.id] for x in rs} & set(o)) / len(o) for rs, o in zip(res, oracle)]
    out.update(probes=len(texts), recall_mean=float(np.mean(per)), recall_min=float(np.min(per)),
               engine_overlap_mean=float(np.mean(eng)), engine_overlap_min=float(np.min(eng)))
    log(f"  tuned nprobe {nprobe} (P={out['partitions']}): case recall@10 vs the oracle over {len(texts)} "
        f"probes (the tuner's; as its sweep measured) mean {out['recall_mean']:.4f} min {out['recall_min']:.4f}; SearchEngine.search_batch "
        f"B={len(qs)} of the probes in {out['engine_B64_ms']:.1f} ms, its top 10 cases overlap the "
        f"oracle's by mean {out['engine_overlap_mean']:.4f} min {out['engine_overlap_min']:.4f}")

    t0 = time.perf_counter()
    save_artifacts(built, cfg)
    out["save_s"] = time.perf_counter() - t0
    loaded = load_artifacts(cfg, device="cuda")
    if loaded[1].ann.tuned_nprobe != nprobe:
        raise AssertionError(f"the loaded ANN has nprobe {loaded[1].ann.tuned_nprobe}, tuned {nprobe}")
    from_disk = SearchEngine(cfg, storage, *loaded, device="cuda")
    names, (court_ids, _) = case_names(np, n_cases, n_cases // 8, seed), case_columns(np, n_cases)
    named = [names[c] for c in sorted(names) if court_ids[c]]  # the stored named cases
    for B in (8, 64):
        names = named[:: max(1, len(named) // B)][:B]
        res = from_disk.search_batch([SearchQuery(query=n) for n in names])
        missed = [n for n, rs in zip(names, res) if not rs or rs[0].case_metadata.name != n]
        if missed:
            raise AssertionError(f"B={B}: name queries not led by their case: {missed[:3]}")
    log(f"  save_artifacts {out['save_s']:.1f} s; load_artifacts keeps nprobe {nprobe}; name queries at "
        "B=8 and 64 over the loaded artifacts lead with their case")
    storage.close()
    del engine, from_disk, loaded, built
    torch.cuda.empty_cache()
    return out, launches


#: phase T: the store's cases and sentences per case; S2-style shards of
#: the operator's build and the shards before its SIGKILL
TRAIN_CASES, TRAIN_SENTS, TRAIN_SHARD_CHUNKS, TRAIN_KILL_SHARDS = 8192, 8, 2048, 6
#: the streaming builder's pretraining defaults: steps, cases sampled by rowid
TRAIN_STEPS, TRAIN_SAMPLE = 300, 2000
#: T0: batch and length, AdamW steps (warmup 1); the loss's relative
#: tolerance and each gradient leaf's, relative to the leaf's largest
#: magnitude (f32 with TF32 off on both: cuBLAS and the CPU's BLAS sum in
#: other orders; the embedding gather's backward adds with atomics)
T0_B, T0_L, T0_STEPS, T0_LOSS_RTOL, T0_GRAD_RTOL = 32, 64, 3, 1e-5, 1e-4
#: T1's steps under torch.profiler (reading a profile takes seconds per
#: 10,000 events; a step has about 3,200 device events)
T1_PROFILED = 2
#: T: the largest share of in-batch negatives the Jaccard mask may drop
#: before the corpus counts as not exercising the loss
MASK_DROP_LIMIT = 0.5
_DIGIT_LETTERS = str.maketrans("0123456789", "abcdefghij")


def train_texts(np, seed: int) -> list[str]:
    """Phase T's case texts: ``TRAIN_SENTS`` seeded sentences each of four
    words of the training synonym lexicon, four of ``WORDS`` (their digits
    spelled as letters), three view stopwords, shuffled; the only digits
    are the case number, in the first sentence. Distinct sentences share
    few tokens, so the Jaccard mask keeps most in-batch negatives (the
    fixture's ``case_text`` is one template that scrubbing makes identical)."""
    from trie_semantic_search_tpu_torch.models.train import _VIEW_STOPWORDS, TRAIN_SYNONYM_GROUPS

    lex = np.asarray(sorted({w for g in TRAIN_SYNONYM_GROUPS for w in g}), dtype=object)
    words = np.asarray([w.translate(_DIGIT_LETTERS) for w in WORDS], dtype=object)
    stops = np.asarray(sorted(_VIEW_STOPWORDS), dtype=object)
    rng = np.random.default_rng(seed + 11)
    shape = (TRAIN_CASES, TRAIN_SENTS)
    toks = np.concatenate([lex[rng.integers(0, len(lex), shape + (4,))],
                           words[rng.integers(0, len(words), shape + (4,))],
                           stops[rng.integers(0, len(stops), shape + (3,))]], axis=2)
    toks = rng.permuted(toks, axis=2)
    texts = []
    for c in range(TRAIN_CASES):
        sents = [" ".join(t) + "." for t in toks[c]]
        sents[0] = f"In case {c} {sents[0]}"
        texts.append(" ".join(s[0].upper() + s[1:] for s in sents))
    return texts


def train_store(np, CaseMetadata, db_path: str, seed: int) -> None:
    """Phase T's sqlite store of ``TRAIN_CASES`` cases (``write_cases_fast``)."""
    court_ids, dates = case_columns(np, TRAIN_CASES)
    write_cases_fast(db_path, (
        (CaseMetadata(id=uuid.UUID(int=c + 1), name=f"Trainee {c} v. State", citation="",
                      court=COURTS[court_ids[c]], decision_date=EPOCH + dt.timedelta(days=int(dates[c])),
                      word_count=len(text.split())), text)
        for c, text in enumerate(train_texts(np, seed))))


def t0_card_vs_cpu(torch, np, tok, model_config, pairs) -> dict:
    """T0: one batch through the port's step on the card and on the CPU
    from the same seeded parameters at f32 compute (TF32 off): the loss,
    the accuracy, every gradient leaf, the global norm before and after the
    clip, then the parameters after ``T0_STEPS`` AdamW steps (warmup 1, the
    first at learning rate 0). The parameters' tolerance is the sum of the
    steps' learning rates: Adam divides by sqrt(v), so where a gradient is
    f32 noise an element's update can move by up to the learning rate."""
    from trie_semantic_search_tpu_torch.models import minilm, train

    it = train.batches_from_pairs(pairs, tok, T0_B, T0_L, false_negative_jaccard=0.5, device="cpu")
    batches = [next(it) for _ in range(T0_STEPS)]
    devs = {"cpu": "cpu", "card": "cuda"}
    models = {d: minilm.MiniLM(model_config, device=dev, seed=0, compute_dtype=torch.float32)
              for d, dev in devs.items()}
    for (k, a), (_, b) in zip(models["cpu"].leaves(), models["card"].leaves()):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f"the seeded init differs between the CPU and the card at {k}")
    tcfg = train.TrainConfig(warmup_steps=1, total_steps=T0_STEPS)
    opts = {d: train.make_optimizer(tcfg, m) for d, m in models.items()}
    param_tol = sum(tcfg.learning_rate * opts["cpu"].factor(s) for s in range(T0_STEPS))
    out: dict = {"steps": [], "grad_rtol": T0_GRAD_RTOL, "loss_rtol": T0_LOSS_RTOL, "param_tol": param_tol}
    with models["cpu"].trainable(), models["card"].trainable():
        for step, batch in enumerate(batches):
            res = {}
            for d, model in models.items():
                t = time.perf_counter()
                loss, acc = train.loss_and_grads(model, {k: v.to(devs[d]) for k, v in batch.items()},
                                                 tcfg.temperature)
                grads = [p.grad.detach().cpu().clone() for _, p in model.leaves()] if step == 0 else None
                g_norm = opts[d].step()
                clipped = torch.sqrt(sum(torch.sum(torch.square(p.grad)) for _, p in model.leaves()))
                if d == "card":
                    torch.cuda.synchronize()
                res[d] = dict(loss=float(loss), acc=float(acc), g_norm=float(g_norm), clipped=float(clipped),
                              grads=grads, s=time.perf_counter() - t)
            c, g = res["cpu"], res["card"]
            row = {k: (c[k], g[k]) for k in ("loss", "acc", "g_norm", "clipped", "s")}
            if not (abs(g["loss"] - c["loss"]) <= T0_LOSS_RTOL * abs(c["loss"])
                    and abs(g["acc"] - c["acc"]) <= 1 / T0_B + 1e-9
                    and abs(g["g_norm"] - c["g_norm"]) <= T0_GRAD_RTOL * c["g_norm"]
                    and abs(g["clipped"] - c["clipped"]) <= T0_GRAD_RTOL * c["clipped"]):
                raise AssertionError(f"T0 step {step}: card vs CPU {row}")
            if step == 0:  # each leaf's largest difference as a share of its tolerance
                shares = []
                for (k, _), a, b in zip(models["cpu"].leaves(), c["grads"], g["grads"]):
                    d, top = float((a - b).abs().max()), float(a.abs().max())
                    shares.append((d / (T0_GRAD_RTOL * top + 1e-9), k, d, top))
                    if not d <= T0_GRAD_RTOL * top + 1e-9:
                        raise AssertionError(f"T0: the gradient of {k} differs by {d:.3g} (largest {top:.3g})")
                out["grad_worst"] = sorted(shares, reverse=True)[:3]
            out["steps"].append(row)
    diffs = sorted(((float((a.detach() - b.detach().cpu()).abs().max()), k)
                    for (k, a), (_, b) in zip(models["cpu"].leaves(), models["card"].leaves())), reverse=True)
    n_off = sum(int(((a.detach() - b.detach().cpu()).abs() > 1e-6).sum())
                for (_, a), (_, b) in zip(models["cpu"].leaves(), models["card"].leaves()))
    out.update(param_max_diff=diffs[0][0], param_worst=diffs[:3], params_off_1e6=n_off,
               params=sum(p.numel() for p in models["cpu"].parameters()))
    if not diffs[0][0] <= param_tol:
        raise AssertionError(f"T0: after {T0_STEPS} AdamW steps the parameters differ by {diffs[:3]}")
    return out


def t1_pretrain(torch, np, storage, cfg, tok, docs) -> dict:
    """T1: ``pretrain_encoder_guarded`` at its defaults (B=32, max_len 64,
    views, Jaccard 0.5, scrubbing, bf16 compute) for ``TRAIN_STEPS`` steps
    on the full-width encoder over ``docs``, its loop timed by wrapping
    ``pretrain_encoder``; the loss and accuracy it logs; the guardrail's
    pick, checked against its MRRs and, when it keeps ``"init"``, against
    a copy of the init bitwise. Beside it, timed alone: the pair mining,
    ``TRAIN_STEPS`` batches drawn on the host (tokenize, mask, copy to the
    card), and ``T1_PROFILED`` steps of the loop under ``torch.profiler`` (the card's
    busy share) and on pre-drawn batches (a step without its batch)."""
    from torch.profiler import ProfilerActivity, profile

    from trie_semantic_search_tpu_torch.models import minilm, train
    from trie_semantic_search_tpu_torch.models.embedder import Embedder

    out: dict = {}
    t = time.perf_counter()
    pairs = train.mine_view_pairs(docs, scrub_digits=True)
    out.update(pairs=len(pairs), mine_s=time.perf_counter() - t)
    it = train.batches_from_pairs(pairs, tok, 32, 64, false_negative_jaccard=0.5, device="cuda")
    t = time.perf_counter()
    drawn = [next(it) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    out["host_batches_s"] = time.perf_counter() - t
    drops = [float((~b["neg_mask"]).sum()) / (32 * 31) for b in drawn[:10]]
    out["mask_drop_share"] = float(np.mean(drops))
    log(f"  {len(pairs)} view pairs from {len(docs)} cases in {out['mine_s']:.2f} s; the Jaccard mask "
        f"drops {out['mask_drop_share']:.4f} of the off-diagonal pairs in the first 10 batches "
        f"(limit {MASK_DROP_LIMIT}); {TRAIN_STEPS} batches drawn alone in {out['host_batches_s']:.2f} s")
    if out["mask_drop_share"] > MASK_DROP_LIMIT:
        raise AssertionError(f"the mask drops {out['mask_drop_share']:.3f} of the negatives: the corpus "
                             "does not exercise the loss")

    emb = Embedder(cfg.vector.model, tokenizer=tok, device="cuda")
    init = {k: v.detach().clone() for k, v in emb.model.state_dict().items()}
    loops: list[float] = []
    orig = train.pretrain_encoder

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rep = orig(*a, **k)
        torch.cuda.synchronize()
        loops.append(time.perf_counter() - t)
        return rep

    train.pretrain_encoder = timed
    try:
        with logged_records("tss_torch.train") as records:
            t = time.perf_counter()
            rep = train.pretrain_encoder_guarded(emb, docs, steps=TRAIN_STEPS, max_len=64)
            out["guarded_s"] = time.perf_counter() - t
    finally:
        train.pretrain_encoder = orig
    loop_s = loops[0] - out["mine_s"]
    out.update(report=rep, pretrain_s=loops[0], loop_s=loop_s, steps_per_s=TRAIN_STEPS / loop_s,
               host_share=out["host_batches_s"] / loop_s, guardrail_s=out["guarded_s"] - loops[0],
               curve=[r.args[:4] for r in records if r.msg.startswith("pretrain step")])
    g = rep["guardrail"]
    now = emb.model.state_dict()
    same = all(torch.equal(now[k], v) for k, v in init.items())
    if g["kept"] == "init":
        if not (g["trained_mrr"] < g["init_mrr"] and same):
            raise AssertionError(f"the guardrail kept 'init' ({g}); weights equal to the init: {same}")
    elif not (g["trained_mrr"] >= g["init_mrr"] and not same):
        raise AssertionError(f"the guardrail kept the trained weights ({g}); weights equal to the init: {same}")
    log(f"  pretrain_encoder_guarded: {TRAIN_STEPS} steps in {loop_s:.2f} s ({out['steps_per_s']:.1f} steps/s; "
        f"host batches {out['host_share']:.3f} of it, pair mining {out['mine_s']:.2f} s before it), "
        f"guardrail {out['guardrail_s']:.2f} s; loss/acc " + ", ".join(
            f"{s}: {loss:.4f}/{acc:.3f}" for s, _, loss, acc in out["curve"]))
    log(f"  guardrail: trained MRR {g['trained_mrr']} vs init {g['init_mrr']} over {g['probes']} probes: "
        f"kept {g['kept']} (the weights {'equal' if same else 'differ from'} the init copy)")

    model = minilm.MiniLM(emb.model_config, device="cuda", seed=1)
    opt = train.make_optimizer(train.TrainConfig(total_steps=40, warmup_steps=2), model)
    with model.trainable():
        for b in drawn[:3]:  # warm
            train.train_step(model, opt, b, 0.05)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in drawn[3:23]:
            train.train_step(model, opt, b, 0.05)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t) / 20 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(T1_PROFILED):
                train.train_step(model, opt, next(it), 0.05)
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            wall_ms = (t_end - t) * 1e3
    on_dev = [e for e in prof.key_averages() if on_device(e)]
    device_ms = sum(dev_us(e) for e in on_dev) / 1e3
    out.update(profile_wall_ms=wall_ms / T1_PROFILED, profile_device_ms=device_ms / T1_PROFILED,
               busy_share=device_ms / wall_ms, kernels_per_step=sum(e.count for e in on_dev) / T1_PROFILED,
               profile_read_s=time.perf_counter() - t_end)
    log(f"  a step on drawn batches {out['step_ms']:.2f} ms; {T1_PROFILED} steps of the loop under torch.profiler: "
        f"{out['profile_wall_ms']:.2f} ms a step, device {out['profile_device_ms']:.2f} ms (busy "
        f"{out['busy_share']:.3f}), {out['kernels_per_step']:.0f} device events a step (the profile read in "
        f"{out['profile_read_s']:.1f} s)")
    del model, opt, drawn, emb
    torch.cuda.empty_cache()
    return out


#: T3: the meshes of the sharded step (dp, mp), the one whose bf16 steps
#: are timed (dp x tp), those steps, and the ones profiled (reading a
#: profile costs seconds per 10,000 events: a sharded step has about 10,000
#: device events and several times as many host ones)
T3_MESHES, T3_BF16_MESH, T3_STEPS, T3_PROFILED = ((2, 2), (4, 1)), (2, 2), 50, 1


def t0_param_tol() -> float:
    """T0's bound on the parameters after its steps (warmup 1): the steps'
    summed learning rates (where a gradient is f32 noise, Adam can move an
    element by up to the learning rate)."""
    from trie_semantic_search_tpu_torch.models import train

    cfg = train.TrainConfig(warmup_steps=1, total_steps=T0_STEPS)
    return sum(cfg.learning_rate * train.warmup_cosine_factor(s, cfg.warmup_steps, cfg.total_steps)
               for s in range(T0_STEPS))


def t3_sharded(torch, np, tok, model_config, pairs) -> dict:
    """T3: the sharded step (``make_sharded_train_step``) of the full-width
    encoder on each of ``T3_MESHES`` over :func:`mesh_devices` (four
    shards on ``cuda:0``, or four cards). T0's batches (B=32, L=64, its
    ``neg_mask`` left out: the sharded batch holds ``ids_a``, ``mask_a``,
    ``ids_b``, ``mask_b`` only) through ``T0_STEPS`` steps at f32 against
    T0's single-device step on the card: each loss within ``T0_LOSS_RTOL``,
    the parameters after the steps within T0's bound. Then, on
    ``T3_BF16_MESH``, ``T3_STEPS`` bf16 steps on drawn batches (3 more to
    warm): steps/s, a step's ms against its device ms under
    ``torch.profiler`` (``T3_PROFILED`` steps), device events a step, the
    losses finite."""
    from torch.profiler import ProfilerActivity, profile

    from trie_semantic_search_tpu_torch.core.config import MeshConfig
    from trie_semantic_search_tpu_torch.models import minilm, train
    from trie_semantic_search_tpu_torch.parallel.mesh import make_mesh

    def sharded_batch(b):
        return {k: b[k] for k in train.SHARDED_BATCH_KEYS}

    it = train.batches_from_pairs(pairs, tok, T0_B, T0_L, false_negative_jaccard=0.5, device="cuda")
    batches = [sharded_batch(next(it)) for _ in range(T0_STEPS)]
    tcfg = train.TrainConfig(warmup_steps=1, total_steps=T0_STEPS)
    ref = minilm.MiniLM(model_config, device="cuda", seed=0, compute_dtype=torch.float32)
    init = {k: v.clone() for k, v in ref.state_dict().items()}
    opt = train.make_optimizer(tcfg, ref)
    with ref.trainable():
        ref_losses = [float(train.train_step(ref, opt, b, tcfg.temperature)[0]) for b in batches]
    want = ref.state_dict()
    devices = mesh_devices(torch, torch.device("cuda"))
    out: dict = {"param_tol": t0_param_tol(), "ref_losses": ref_losses, "devices": [str(d) for d in devices]}
    per_mesh = 3 + T3_STEPS + T3_PROFILED
    drawn = [sharded_batch(next(it)) for _ in range(per_mesh)]
    for dp, mp in T3_MESHES:
        mesh = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp), devices=devices)
        step = train.make_sharded_train_step(mesh, model_config, tcfg, tcfg.temperature)
        state = step.init(minilm.MiniLM(model_config, device="cuda", compute_dtype=torch.float32).load_params(init))
        t = time.perf_counter()
        losses = [float(step(state, b)[0]) for b in batches]
        f32_s = time.perf_counter() - t
        got = step.gather(state).state_dict()
        diffs = sorted(((float((got[k] - want[k]).abs().max()), k) for k in want), reverse=True)
        row = dict(losses=losses, f32_s=f32_s, param_max_diff=diffs[0][0], param_worst=diffs[:3],
                   leaves=len(state.leaves()))
        if not (all(abs(a - b) <= T0_LOSS_RTOL * abs(b) for a, b in zip(losses, ref_losses))
                and diffs[0][0] <= out["param_tol"]):
            raise AssertionError(f"T3 {dp}x{mp}: losses {losses} vs one device {ref_losses}, parameters off "
                                 f"by {diffs[:3]} (bound {out['param_tol']})")
        out[f"{dp}x{mp}"] = row
        log(f"    T3 {dp}x{mp} over {sorted(set(out['devices']))} ({row['leaves']} parameter slices): f32 losses "
            + ", ".join(f"{a:.6f}" for a in losses) + " (one device " + ", ".join(f"{b:.6f}" for b in ref_losses)
            + f"), parameters after {T0_STEPS} steps within {diffs[0][0]:.3g} of one device's (bound "
            f"{out['param_tol']:.3g}; {diffs[:3]})")
        del step, state
        if (dp, mp) != T3_BF16_MESH:
            continue
        bstep = train.make_sharded_train_step(mesh, model_config,
                                              train.TrainConfig(total_steps=per_mesh, warmup_steps=2))
        bstate = bstep.init(minilm.MiniLM(model_config, device="cuda", seed=1))
        mine = drawn
        for b in mine[:3]:
            bstep(bstate, b)
        torch.cuda.synchronize()
        t = time.perf_counter()
        bl = [bstep(bstate, b)[0] for b in mine[3 : 3 + T3_STEPS]]
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t_prof = time.perf_counter()
            for b in mine[3 + T3_STEPS :]:
                bstep(bstate, b)
            torch.cuda.synchronize()
            t = time.perf_counter()
            wall_ms = (t - t_prof) * 1e3 / T3_PROFILED
        on_dev = [e for e in prof.key_averages() if on_device(e)]
        read_s = time.perf_counter() - t
        bl = [float(x) for x in bl]
        if not np.isfinite(bl).all():
            raise AssertionError(f"T3 {dp}x{mp}: bf16 losses not finite: {bl}")
        row.update(bf16_steps=T3_STEPS, steps_per_s=T3_STEPS / loop_s, step_ms=loop_s / T3_STEPS * 1e3,
                   profile_wall_ms=wall_ms, profile_device_ms=sum(dev_us(e) for e in on_dev) / 1e3 / T3_PROFILED,
                   kernels_per_step=sum(e.count for e in on_dev) / T3_PROFILED, profile_read_s=read_s,
                   bf16_loss_first_last=(bl[0], bl[-1]))
        row["busy_share"] = row["profile_device_ms"] / wall_ms
        log(f"    T3 {dp}x{mp} bf16: {T3_STEPS} steps at {row['steps_per_s']:.1f} steps/s, a step "
            f"{row['step_ms']:.2f} ms; {T3_PROFILED} under torch.profiler {wall_ms:.2f} ms a step, device "
            f"{row['profile_device_ms']:.2f} ms (busy {row['busy_share']:.3f}), {row['kernels_per_step']:.0f} "
            f"device events a step (the profile read in {read_s:.1f} s); loss {bl[0]:.4f} -> {bl[-1]:.4f}")
        del bstep, bstate
        torch.cuda.empty_cache()
    return out


def train_phase(torch, np, sk, seed: int, work: Path, out_dir: Path) -> tuple[dict, dict]:
    """Phase T, pretraining. Its own store of ``TRAIN_CASES`` cases
    (:func:`train_texts`), the corpus vocab and the 2,000-case sample the
    streaming builder takes; T0 (:func:`t0_card_vs_cpu`), T1
    (:func:`t1_pretrain`); then T2, the operator's path: ``cli
    build-index --streaming --shard-chunks 2048`` over that store with an
    empty vector directory (it pretrains ``TRAIN_STEPS`` steps, saves the
    encoder, streams), SIGKILLed at ``TRAIN_KILL_SHARDS`` shards, then
    resumed in this process (counts reset just before, read just after:
    path ``pretrain_build``). The resume must pretrain nothing, leave the
    saved encoder's files' sha256 as they were, embed only the chunks
    after the watermark, and finish the tuner (its probe and rescore calls
    held against the plain versions; the pick checked against its steps)
    and the quality gate; the tuner's probes are then served through
    ``SearchEngine`` at B=64. Returns the details and the path's counts."""
    import hashlib

    from trie_semantic_search_tpu_torch.core.config import Config
    from trie_semantic_search_tpu_torch.core.types import CaseMetadata
    from trie_semantic_search_tpu_torch.index.streaming import StreamingIndexBuilder, _Manifest, _sample_docs
    from trie_semantic_search_tpu_torch.models import minilm, train
    from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer, train_wordpiece_vocab
    from trie_semantic_search_tpu_torch.storage.store import StorageManager
    from trie_semantic_search_tpu_torch.text.processor import TextProcessor

    root = work / "train"
    root.mkdir()
    cfg = Config()
    cfg.storage.db_path = str(root / "train.sqlite")
    cfg.trie.index_path = str(root / "trie")
    cfg.vector.hnsw.index_path = str(root / "vec")
    toml = root / "config.toml"
    cfg.save_to_file(toml)
    out: dict = {}
    t = time.perf_counter()
    train_store(np, CaseMetadata, cfg.storage.db_path, seed)
    out["store_s"] = time.perf_counter() - t
    storage = StorageManager(cfg.storage)
    tp = TextProcessor(cfg.text_processing)
    t = time.perf_counter()
    vocab = train_wordpiece_vocab((text for i, (_r, _m, text) in zip(range(10_000), storage.iter_cases_rowid())
                                   if text), vocab_size=8192)
    tok = WordPieceTokenizer(vocab)
    docs = _sample_docs(storage, tp, TRAIN_SAMPLE)
    out.update(vocab_s=time.perf_counter() - t, vocab=len(tok), sample_cases=len(docs))
    model_config = minilm.config_for_model_type(cfg.vector.model.model_type, vocab_size=max(len(tok), 128),
                                                max_position=cfg.vector.model.max_sequence_length)
    log(f"  store of {TRAIN_CASES} cases ({TRAIN_SENTS} sentences each) {out['store_s']:.1f} s; corpus vocab "
        f"{len(tok)} and the {len(docs)}-case sample {out['vocab_s']:.1f} s; MiniLM hidden "
        f"{model_config.hidden_size}, {model_config.num_layers} layers, {model_config.num_heads} heads, "
        f"intermediate {model_config.intermediate_size}")

    log(f"  T0: one batch (B={T0_B}, L={T0_L}) on the card vs the CPU at f32 (TF32 off), then {T0_STEPS} "
        "AdamW steps (warmup 1)")
    t = time.perf_counter()
    out["t0"] = t0 = t0_card_vs_cpu(torch, np, tok, model_config, train.mine_view_pairs(docs, scrub_digits=True))
    out["t0"]["seconds"] = time.perf_counter() - t
    for i, r in enumerate(t0["steps"]):
        log(f"    step {i + 1}: loss {r['loss'][0]:.6f} / {r['loss'][1]:.6f}, acc {r['acc'][0]:.4f} / "
            f"{r['acc'][1]:.4f}, global norm {r['g_norm'][0]:.6f} / {r['g_norm'][1]:.6f}, clipped "
            f"{r['clipped'][0]:.6f} / {r['clipped'][1]:.6f} (CPU / card); seconds {r['s'][0]:.2f} / {r['s'][1]:.3f}")
    log(f"    tolerances: loss {T0_LOSS_RTOL} relative; each gradient leaf {T0_GRAD_RTOL} of its largest "
        f"magnitude + 1e-9 (the norms {T0_GRAD_RTOL} relative); the leaves nearest theirs (share of the "
        f"tolerance, leaf, max diff, largest): " + "; ".join(
            f"{sh:.3g} {k} {d:.3g} {top:.3g}" for sh, k, d, top in t0["grad_worst"]) + "; parameters after "
        f"{T0_STEPS} steps {t0['param_tol']:.3g} (the steps' summed learning rates): max "
        f"{t0['param_max_diff']:.3g} ({t0['param_worst']}), {t0['params_off_1e6']} of {t0['params']} "
        f"elements off by more than 1e-6; T0 {t0['seconds']:.1f} s")

    log(f"  T3: the sharded step on {T3_MESHES} (dp, mp) meshes against T0's single-device step on the card, "
        f"then {T3_STEPS} bf16 steps on {T3_BF16_MESH}")
    t = time.perf_counter()
    out["t3"] = t3_sharded(torch, np, tok, model_config, train.mine_view_pairs(docs, scrub_digits=True))
    out["t3"]["seconds"] = time.perf_counter() - t
    log(f"    T3 {out['t3']['seconds']:.1f} s")

    log(f"  T1: {TRAIN_STEPS} steps of pretrain_encoder_guarded at its defaults (bf16) on the sample")
    out["t1"] = t1_pretrain(torch, np, storage, cfg, tok, docs)
    storage.close()

    def encoder_sha() -> dict[str, str]:
        vec = root / "vec"
        return {str(f.relative_to(vec)): hashlib.sha256(f.read_bytes()).hexdigest()
                for f in sorted(vec.rglob("*")) if f.is_file()}

    wd = root / "work"
    t0s, t_kill, rc = streaming_cli_killed(toml, wd, TRAIN_KILL_SHARDS, root / "build.log",
                                           out_dir / "t2_build.log",
                                           extra=("--shard-chunks", str(TRAIN_SHARD_CHUNKS)))
    text = (root / "build.log").read_text()
    killed_backends = require_native("T2's killed build-index --streaming", trie_backends(text))
    at_kill = _Manifest.load(wd / "manifest.json")
    saved = encoder_sha()
    stamps = [(ln[:19], ln) for ln in text.splitlines() if "pretrain step" in ln or "pooling selection" in ln
              or "streaming-build pretraining" in ln]
    rep_line = next((ln for _, ln in stamps if "streaming-build pretraining" in ln), None)
    if rep_line is None or not any(k.startswith("encoder/") for k in saved):
        raise AssertionError(f"the killed build logged no pretraining or saved no encoder: {text[-3000:]}")
    # the logged steps (every 50th) and their 1 s stamps: the loop's rate in the CLI
    logged = [(int(ln.split("pretrain step ", 1)[1].split("/", 1)[0]), dt.datetime.fromisoformat(s))
              for s, ln in stamps if "pretrain step" in ln]
    span_s = (logged[-1][1] - logged[0][1]).total_seconds() if len(logged) > 1 else None
    out["t2"] = t2 = dict(killed_after_s=t_kill - t0s, returncode=rc, kill_shards=len(at_kill.shards),
                          kill_row=at_kill.next_row, kill_chunks=at_kill.chunks,
                          logged_steps=[n for n, _ in logged], logged_span_s=span_s,
                          steps_per_s=(logged[-1][0] - logged[0][0]) / span_s if span_s else None,
                          pretrain_report=rep_line.split("streaming-build pretraining: ", 1)[1],
                          encoder_files=sorted(saved), killed_backends=killed_backends)
    log(f"  T2: build-index --streaming --shard-chunks {TRAIN_SHARD_CHUNKS} over the empty vector directory "
        f"SIGKILLed {t2['killed_after_s']:.1f} s after its start (exit {rc}) at {len(at_kill.shards)} shards, "
        f"watermark row {at_kill.next_row} ({at_kill.chunks} chunks); its log stamps pretraining steps "
        f"{logged[0][0] if logged else None}..{logged[-1][0] if logged else None} {span_s} s apart (1 s stamps: "
        f"{t2['steps_per_s']} steps/s); report {t2['pretrain_report']}")

    storage = StorageManager(cfg.storage)
    guarded: list = []
    orig = train.pretrain_encoder_guarded

    def counting(*a, **k):
        guarded.append(1)
        return orig(*a, **k)

    train.pretrain_encoder_guarded = counting
    try:
        sb = StreamingIndexBuilder(storage, cfg, work_dir=wd, shard_chunks=TRAIN_SHARD_CHUNKS, device="cuda")
    finally:
        train.pretrain_encoder_guarded = orig
    embedded: list[int] = []
    write = sb._write_shard

    def counted(manifest, texts, refs):
        embedded.append(len(texts))
        write(manifest, texts, refs)

    sb._write_shard = counted
    with (logged_records("tss_torch.index.tuning") as records,
          logged_records("tss_torch.train") as trained,
          kept_calls(sk, ("probe_candidates_cuda", "gather_rescore_cuda")) as calls):
        sk.reset_launch_counts()
        t_resume = time.perf_counter()
        built = sb.build(resume=True)
        torch.cuda.synchronize()
        launches = dict(sk.LAUNCHES)
    t2.update(kill_to_resume_s=t_resume - t_kill, resume_s=time.perf_counter() - t_resume, launches=launches,
              trie_backend=require_native("T2's resumed build", [built.trie.backend])[0])
    r, ann = built.report, built.vector.ann
    after = encoder_sha()
    quality_path = root / "vec" / "quality.json"
    if guarded or trained or {k: after.get(k) for k in saved} != saved:
        raise AssertionError(f"the resume pretrained ({len(guarded)} calls, {len(trained)} records) or changed "
                             f"the saved encoder: {[k for k in saved if after.get(k) != saved[k]]}")
    if not (0 < r.resumed_from_row == at_kill.next_row and r.cases == TRAIN_CASES
            and sum(embedded) == r.embedded_chunks == r.content_chunks - at_kill.chunks > 0):
        raise AssertionError(f"T2 resume: from row {r.resumed_from_row} (watermark {at_kill.next_row}), "
                             f"{r.cases} cases, {r.content_chunks} chunks, embedded {sum(embedded)}")
    if not quality_path.exists():
        raise AssertionError("the resumed build ran no quality gate (no quality.json)")
    quality = json.loads(quality_path.read_text())
    oracle_s, steps, settled = tuner_steps(records)
    t2.update(cases=r.cases, chunks=r.content_chunks, shards=r.shards, resumed_from_row=r.resumed_from_row,
              embedded_chunks=r.embedded_chunks, chunks_per_s=r.chunks_per_second, nprobe=ann.tuned_nprobe,
              finalize_s=r.finalize_seconds, sweep=steps, settled=settled, tune_oracle_s=oracle_s,
              rule=check_pick(steps, ann.tuned_nprobe, 0.95, cfg.vector.hnsw.tune_min_recall or None),
              quality_gate=dict(mode=quality["mode"], degraded=quality["degraded"],
                                trained_mrr=quality["trained"]["all"]["mrr"],
                                control_mrr=quality["control"]["all"]["mrr"]))
    if launches["probe_candidates"] <= 0 or launches["gather_rescore"] <= 0:
        raise AssertionError(f"the resumed build's tuner did not run the probe and rescore kernels: {launches}")
    t2["plain_err"] = hold_against_plain(torch, sk, calls)
    log(f"  resumed {t2['kill_to_resume_s']:.1f} s after the kill from row {r.resumed_from_row}: no pretraining, "
        f"the {len(saved)} encoder files' sha256 unchanged; embedded only the {r.embedded_chunks} chunks after "
        f"the watermark of {r.content_chunks} ({r.chunks_per_second:.0f} chunks/s); build {t2['resume_s']:.1f} s; "
        f"tuned nprobe {ann.tuned_nprobe} in {len(steps)} steps ({t2['rule']}); quality gate {t2['quality_gate']}; "
        f"trie builders {t2['trie_backend']} (the killed build's {killed_backends})")
    log(f"  launches on the pretrain_build path {launches}; the tuner's {held_summary(calls)} against the plain "
        f"versions: probe bitwise, rescore within {t2['plain_err']['gather_rescore']:.3g}")
    del calls
    engine, *_ = engine_vs_oracle(np, cfg, storage, steps, ann.tuned_nprobe, t2)
    del engine, built, sb
    storage.close()
    torch.cuda.empty_cache()
    shutil.rmtree(wd)
    return out, launches


# ---------------------------------------------------------------------------
# phase M: sharded serving
# ---------------------------------------------------------------------------


#: phase M: shards on the one card (one shard per card when more are
#: visible), the probe's nprobe, the recall floor against the exact stream
MESH_SHARDS, MESH_NPROBE, MESH_RECALL = 4, 64, 0.97
#: M3: rows of the ShardedCorpusIndex searched, of the one saved and
#: loaded (``savez_compressed`` of f16 rows is the time), queries, k
M3_ROWS, M3_SAVE_ROWS, M3_QUERIES, M3_K = 1 << 20, 1 << 15, 64, 10
#: the kernel launchers whose calls on the ``sharded`` path are held
MESH_HELD = ("probe_candidates_cuda", "gather_rescore_cuda", "fused_scan_cuda")


def mesh_devices(torch, dev) -> list:
    """The mesh of phase M: ``MESH_SHARDS`` shards on ``dev``, or one shard
    per card when ``dev`` is a card and more than one is visible."""
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev] * MESH_SHARDS


def serving_batches(np, rng, names, words, courts, sizes=((8, False), (64, False), (256, False), (64, True))):
    """The main path's batches: ``(B, filtered, texts, court filters,
    date ranges)``; a filtered batch puts two courts on every other query
    and a date range on two of every three."""
    out = []
    for B, filtered in sizes:
        texts = texts_for(rng, names, words, B)
        cf = [[courts[1 + i % 15], courts[2 + (i + 3) % 14]] if filtered and i % 2 == 0 else None
              for i in range(B)]
        dr = [(dt.date(1960, 1, 1), dt.date(1990, 12, 31)) if filtered and i % 3 != 1 else None
              for i in range(B)]
        out.append((B, filtered, texts, cf, dr))
    return out


def held_counts(calls) -> dict:
    """Kept calls by launcher, for the log."""
    out: dict = {}
    for name, _, _ in calls:
        out[name.removesuffix("_cuda")] = out.get(name.removesuffix("_cuda"), 0) + 1
    return out


def serve_kept(torch, sk, fused, batches, recall_target: float):
    """Each batch once through ``query_batch`` with the kernel launchers'
    calls kept, the counts set to 0 just before and read just after.
    Returns the records (with wall ms), the counts and the kept calls."""
    records = []
    with kept_calls(sk, MESH_HELD) as calls:
        sk.reset_launch_counts()
        for B, filtered, texts, cf, dr, q in batches:
            mode = "stream" if fused._layout_brute_batch(B) else (
                "probe" if fused.ann_mode == "sharded-partitioned" else "scan")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fused.query_batch(q, texts, cf, dr, [0.0] * B, [2.0] * B, k=K,
                                    overfetch=serving_settings()[0], recall_target=recall_target)
            torch.cuda.synchronize()
            records.append(dict(B=B, filtered=filtered, mode=mode, texts=texts, cf=cf, dr=dr, q=q,
                                res=res, query_ms=(time.perf_counter() - t0) * 1e3))
        launches = dict(sk.LAUNCHES)
    return records, launches, calls


def held_in_background(torch, sk, calls):
    """:func:`hold_against_plain` over ``calls`` in a thread of its own,
    whose Python launches the plain versions while the caller's host-bound
    work (numpy, which releases the interpreter lock) runs; returns a
    future of ``(largest differences, held counts, seconds)``. Its failure
    raises from ``result()``."""
    import concurrent.futures

    def job():
        t0 = time.perf_counter()
        return hold_against_plain(torch, sk, calls), held_counts(calls), time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(job)
    finally:
        pool.shutdown(wait=False)


def profile_sharded(torch, fused, rec) -> dict:
    """One more run of a batch under ``torch.profiler``: the device ms of
    each shard's stage (the ranges ``sharded shard <s>``), of the merge on
    the first device (``sharded merge``) and of the whole batch, and the
    wall ms."""
    from torch.profiler import ProfilerActivity, profile

    B = rec["B"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.query_batch(rec["q"], rec["texts"], rec["cf"], rec["dr"], [0.0] * B, [2.0] * B, k=K,
                          overfetch=serving_settings()[0], recall_target=serving_settings()[1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def total(e) -> float:
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    shards, merge = {}, 0.0
    for e in prof.events():
        if e.name.startswith("sharded shard "):
            s = int(e.name.rsplit(" ", 1)[1])
            shards[s] = shards.get(s, 0.0) + total(e) / 1e3
        elif e.name == "sharded merge":
            merge += total(e) / 1e3
    device_ms = sum(dev_us(e) for e in prof.key_averages() if on_device(e)) / 1e3
    return dict(B=B, mode=rec["mode"], wall_ms=wall_ms, device_ms=device_ms,
                shard_device_ms=[shards.get(s, 0.0) for s in range(len(shards))],
                merge_device_ms=merge)


def tie_aware_equal(np, want, got, k: int) -> tuple[int, list]:
    """Position by position, ``got``'s case rows and scores (bits) against
    ``want``'s, but for members of a tie at the k-th score, whose cases may
    differ. Returns the queries compared and the tie members that differ
    (query, case rows) for the log; raises on any other difference."""
    wv, _, wc, ws = want
    gv, _, gc, gs = got
    differ = []
    for b in range(wv.shape[0]):
        kth = wv[b, k - 1]
        above = wv[b] > kth
        if not (np.array_equal(gc[b, above], wc[b, above]) and np.array_equal(gs[b, above], ws[b, above])
                and np.array_equal(gv[b].view(np.int32), wv[b].view(np.int32))):
            raise AssertionError(f"query {b}: sharded and single-device results differ above the "
                                 f"k-th score {kth}: {gc[b].tolist()} vs {wc[b].tolist()}")
        tie = ~above
        if not np.array_equal(gc[b, tie], wc[b, tie]):
            if not np.isfinite(kth):
                raise AssertionError(f"query {b}: the dead slots differ")
            differ.append((b, sorted(set(gc[b, tie].tolist()) ^ set(wc[b, tie].tolist()))))
    return wv.shape[0], differ


def mesh_phase(torch, np, sk, fused, vi, host, cents, names, words, courts, seed: int, out_dir: Path):
    """Phase M1-M3 over phase A's rows (the served corpus: 5,242,880 chunks,
    four per case) on a mesh of :func:`mesh_devices`, the rows in a seeded
    random order: in generation order each shard would hold whole clusters
    (a cluster's 1,024 rows are adjacent), which a corpus stored in ingest
    order does not, and the per-shard capacity cap of
    ``build_sharded_partitions`` (2.5 times a shard's mean fill) would spill
    a third of the rows. Then M5 (:func:`distributed_phase`) over the
    first ``M5_ROWS`` of those rows. Returns the details, the launch counts
    of M1's and M2's serving runs (summed: the path ``sharded``) and each
    kernel's largest difference from its plain version over the held calls
    (M5's processes' included)."""
    from trie_semantic_search_tpu_torch.core.config import AnnConfig, MeshConfig, VectorConfig
    from trie_semantic_search_tpu_torch.index.ann import PartitionedANN
    from trie_semantic_search_tpu_torch.index.vector import VectorIndex
    from trie_semantic_search_tpu_torch.parallel.mesh import make_mesh
    from trie_semantic_search_tpu_torch.search.fused import FusedHybridSearch

    dev = vi.device
    mesh = make_mesh(MeshConfig(), devices=mesh_devices(torch, dev))
    S = mesh.shape["data"]
    N = host.shape[0]
    t0 = time.perf_counter()
    rows = np.random.default_rng(seed + 6).permutation(N).astype(np.int32)
    host = host[rows]  # served row i is generated row rows[i]
    refs = np.stack([rows // CHUNKS_PER_CASE, rows % CHUNKS_PER_CASE], axis=1)
    out_perm_s = time.perf_counter() - t0
    cfg = VectorConfig()
    cfg.hnsw = AnnConfig(num_probes=MESH_NPROBE)
    ann = PartitionedANN(cfg.hnsw, device=dev)  # phase A's centroids, for the shards to share
    ann.centroids, ann.num_vectors = torch.tensor(cents, device=dev), N
    vm = VectorIndex(cfg, embedder=vi.embedder, device=dev)
    vm.set_frozen(refs, host, ann)
    eps = serving_settings()[2]
    out: dict = {"shards": S, "devices": [str(d) for d in mesh.data_devices], "permute_s": out_perm_s}
    rng = np.random.default_rng(seed + 7)
    batches = [(B, f, texts, cf, dr, vi.embedder.embed(texts).embedding)
               for B, f, texts, cf, dr in serving_batches(np, rng, names, words, courts)]
    err = {"probe_candidates": 0.0, "gather_rescore": 0.0, "fused_scan": 0.0}
    launches = {}

    def add(counts: dict) -> None:
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c

    def fold(e: dict) -> None:
        for n, x in e.items():
            err[n] = max(err[n], x)

    # M1: sharded-partitioned, phase A's centroids
    t0 = time.perf_counter()
    with anon_rss_peak() as rss:
        f1 = FusedHybridSearch(fused.trie_index, vm, fused.columns, ann_mode="partitioned", mesh=mesh,
                               flat_escalate_eps=eps)
        torch.cuda.synchronize()
    m1 = dict(init_s=time.perf_counter() - t0, stages_s=f1.sp_build_seconds, m_local=f1.sp_m,
              nprobe=f1.sp_nprobe, rss=rss, partitions=int(f1.sp_centroids.shape[0]))
    if not (f1.ann_mode == "sharded-partitioned" and f1.sp_m % 128 == 0 and f1.sp_nprobe == MESH_NPROBE):
        raise AssertionError(f"M1 built {f1.ann_mode} with m={f1.sp_m}, nprobe={f1.sp_nprobe}")
    part_gb = sum(t.numel() for t in f1.sp_int8) / 1e9
    log(f"  M1 FusedHybridSearch(mesh={S} shards on {sorted(set(out['devices']))}) "
        f"{m1['init_s']:.1f} s; build_sharded_partitions " + ", ".join(
            f"{k} {v:.2f} s" for k, v in m1["stages_s"].items())
        + f"; P={m1['partitions']} m_local={f1.sp_m}, part_int8 {part_gb:.2f} GB on the card; " + rss_line(rss))
    t0 = time.perf_counter()
    recs, c1, calls = serve_kept(torch, sk, f1, batches, serving_settings()[1])
    m1["serve_s"] = time.perf_counter() - t0
    add(c1)
    if min(c1["probe_candidates"], c1["gather_rescore"], c1["fused_scan"]) <= 0 or c1["fused_scan_dp4a"]:
        raise AssertionError(f"M1 did not launch the probe, rescore and fused scan kernels: {c1}")
    t0 = time.perf_counter()
    hits = []
    m1["batches"] = []
    for rec in recs:
        r10 = check_and_recall(np, fused, rec)
        hits.append((r10, rec["B"]))
        m1["batches"].append(dict(B=rec["B"], filtered=rec["filtered"], mode=rec["mode"],
                                  query_ms=rec["query_ms"], recall_at_10=r10))
        log(f"  M1 B={rec['B']} {rec['mode']} filtered={rec['filtered']}: query ms "
            f"{rec['query_ms']:.1f}, recall@10 vs the single-device exact stream {r10:.4f}")
    m1["recall_at_10"] = sum(r * b for r, b in hits) / sum(b for _, b in hits)
    m1["recall_s"] = time.perf_counter() - t0
    if m1["recall_at_10"] < MESH_RECALL:
        raise AssertionError(f"M1 recall@10 {m1['recall_at_10']:.4f} < {MESH_RECALL}")
    m1["profile"] = [profile_sharded(torch, f1, r) for r in recs if not r["filtered"] and r["B"] in (64, 256)]
    for p in m1["profile"]:
        log(f"  M1 profile B={p['B']} {p['mode']}: wall {p['wall_ms']:.2f} ms, device {p['device_ms']:.2f} ms; "
            f"per shard device ms {[round(x, 3) for x in p['shard_device_ms']]}, merge "
            f"{p['merge_device_ms']:.3f} ms")
    log(f"  M1 recall@10 over {sum(b for _, b in hits)} queries {m1['recall_at_10']:.4f} (floor "
        f"{MESH_RECALL}); {m1['serve_s']:.1f} s serving, {m1['recall_s']:.1f} s references")
    out["m1"] = m1
    held1 = held_in_background(torch, sk, calls)  # beside M2's host-bound build
    del f1, recs, calls

    # M2: sharded brute, the fused scan per shard at 0.97, exact at 1.0
    t0 = time.perf_counter()
    f2 = FusedHybridSearch(fused.trie_index, vm, fused.columns, ann_mode="brute", mesh=mesh,
                           flat_escalate_eps=eps)
    torch.cuda.synchronize()
    m2 = dict(init_s=time.perf_counter() - t0)
    if f2.ann_mode != "sharded":
        raise AssertionError(f"M2 built {f2.ann_mode}")
    e1, m1["held"], m1["hold_s"] = held1.result()
    fold(e1)
    log(f"  M1 launches {c1}; held {m1['held']} against the plain versions in {m1['hold_s']:.1f} s "
        f"(probe and fused scan bitwise, rescore within {e1['gather_rescore']:.3g})")
    torch.cuda.empty_cache()
    # B=64 unfiltered and filtered: holding a call costs the plain scan of
    # a whole shard, whatever the batch
    m2_batches = [b for b in batches if b[0] == 64]
    t0 = time.perf_counter()
    recs, c2, calls = serve_kept(torch, sk, f2, m2_batches, serving_settings()[1])
    m2["serve_s"] = time.perf_counter() - t0
    add(c2)
    if c2["fused_scan"] <= 0 or c2["fused_scan_dp4a"] or c2["probe_candidates"] or c2["gather_rescore"]:
        raise AssertionError(f"M2 launched other than the fused scan: {c2}")
    held2 = held_in_background(torch, sk, calls)  # beside the single-device build below
    del calls
    m2["batches"] = [dict(B=r["B"], filtered=r["filtered"], query_ms=r["query_ms"]) for r in recs]
    log(f"  M2 FusedHybridSearch(mesh, brute) {m2['init_s']:.1f} s; launches {c2}; query ms " + ", ".join(
        f"B={r['B']}{' filtered' if r['filtered'] else ''} {r['query_ms']:.1f}" for r in recs))
    t0 = time.perf_counter()
    one = FusedHybridSearch(fused.trie_index, vm, fused.columns, ann_mode="brute")
    compared, differ = 0, []
    for B, filtered, texts, cf, dr, q in m2_batches:
        args = (q, texts, cf, dr, [0.0] * B, [2.0] * B)
        kw = dict(k=K, overfetch=serving_settings()[0], recall_target=1.0)
        n, d = tie_aware_equal(np, one.query_batch(*args, **kw), f2.query_batch(*args, **kw), K)
        compared += n
        differ += [(B, filtered, b, cases) for b, cases in d]
    m2.update(exact_s=time.perf_counter() - t0, exact_compared=compared, exact_tie_differences=differ)
    log(f"  M2 at recall_target=1.0: {compared} queries position by position equal to the single-device "
        f"exact scan (FusedHybridSearch brute, {time.perf_counter() - t0:.1f} s with its build); tie "
        f"members at the k-th score that differ: {differ or 'none'}")
    e2, m2["held"], m2["hold_s"] = held2.result()
    fold(e2)
    log(f"  M2 held {m2['held']} bitwise against the plain version in {m2['hold_s']:.1f} s")
    out["m2"] = m2
    del f2, one, recs
    torch.cuda.empty_cache()

    out["m3"], m3_ref = sharded_index_check(torch, np, host, seed, dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["m5"] = distributed_phase(torch, np, host[:M5_ROWS], refs[:M5_ROWS], cents, fused, batches, m3_ref,
                                  seed, out_dir)
    out["m5"]["seconds"] = time.perf_counter() - t0
    fold(out["m5"].pop("plain_err"))
    return out, launches, err


def sharded_index_check(torch, np, host, seed: int, dev) -> tuple[dict, dict]:
    """M3: ``ShardedCorpusIndex`` over the first ``M3_ROWS`` rows of phase A
    on ``MESH_SHARDS`` shards, int8 and bf16, against one exact top-k over
    the whole matrix on the card (int8: bitwise; bf16: values within 1e-6
    and every row inside the reference's k-th score less 1e-6); then one of
    ``M3_SAVE_ROWS`` rows saved and loaded on a mesh of 2, which must serve
    bitwise what the same file serves on the phase's mesh (the overlap
    with the top 10 served before the save is printed: the file holds f16
    rows, so the int8 codes loaded from it may round otherwise). Returns
    the details and, for M5, the queries and both searches' results."""
    from trie_semantic_search_tpu_torch.core.config import MeshConfig
    from trie_semantic_search_tpu_torch.index.sharded import ShardedCorpusIndex
    from trie_semantic_search_tpu_torch.ops.scoring import cosine_scores, cosine_scores_int8, quantize_int8
    from trie_semantic_search_tpu_torch.ops.topk import exact_topk
    from trie_semantic_search_tpu_torch.parallel.mesh import make_mesh

    out: dict = {"rows": M3_ROWS, "save_rows": M3_SAVE_ROWS}
    mesh = make_mesh(MeshConfig(), devices=mesh_devices(torch, dev))
    rng = np.random.default_rng(seed + 8)
    q = host[rng.choice(M3_ROWS, M3_QUERIES, replace=False)] + 0.01 * rng.standard_normal(
        (M3_QUERIES, host.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = host[:M3_ROWS]
    # normalised as the index normalises its input (numpy, on the host)
    vn = torch.as_tensor(rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True), 1e-12), device=dev)
    qt = torch.as_tensor(q, device=dev)
    ref = {"q": q}
    for use_int8 in (True, False):
        t0 = time.perf_counter()
        idx = ShardedCorpusIndex(mesh, use_int8=use_int8)
        idx.build(host[:M3_ROWS])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gv, gi = idx.search_brute(q, M3_K)
        search_ms = (time.perf_counter() - t0) * 1e3
        if use_int8:
            cq, cs = quantize_int8(vn)
            rv, ri = exact_topk(cosine_scores_int8(qt, cq, cs), M3_K)
            if not (np.array_equal(gi, ri.cpu().numpy())
                    and np.array_equal(gv.view(np.int32), rv.cpu().numpy().view(np.int32))):
                raise AssertionError("M3: the sharded int8 scan differs from the one-card exact top-k")
            e = 0.0
        else:
            scores = cosine_scores(qt, vn.to(torch.bfloat16))
            rv, _ = exact_topk(scores, M3_K)
            rv = rv.cpu().numpy()
            e = float(np.abs(gv - rv).max())
            mine = torch.gather(scores, 1, torch.as_tensor(gi, device=dev).long()).cpu().numpy()
            if not (e <= 1e-6 and (mine >= rv[:, -1:] - 1e-6).all()):
                raise AssertionError(f"M3: the sharded bf16 scan differs from the one-card top-k by {e}")
        out["int8" if use_int8 else "bf16"] = dict(build_s=build_s, search_ms=search_ms, max_abs_err=e)
        ref["int8" if use_int8 else "bf16"] = (gv, gi)
        log(f"  M3 ShardedCorpusIndex(int8={use_int8}) of {M3_ROWS} rows on {mesh.shape['data']} shards: "
            f"build {build_s:.1f} s, search_brute B={M3_QUERIES} k={M3_K} {search_ms:.1f} ms, equal to "
            f"the one-card exact top-k ({'bitwise' if use_int8 else f'values within {e:.3g}'})")
        del idx
    del vn
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="m3_") as tmp:
        path = Path(tmp) / "ann.npz"
        idx = ShardedCorpusIndex(mesh)
        idx.build(host[:M3_SAVE_ROWS])
        before = idx.search_brute(q, M3_K)
        t0 = time.perf_counter()
        idx.save(path)
        out["save_s"], out["npz_mb"] = time.perf_counter() - t0, path.stat().st_size / 2**20
        del idx
        t0 = time.perf_counter()
        two = ShardedCorpusIndex.load(path, make_mesh(MeshConfig(), devices=[dev] * 2))
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        got = two.search_brute(q, M3_K)
        want = ShardedCorpusIndex.load(path, mesh).search_brute(q, M3_K)
    if not (np.array_equal(got[1], want[1]) and np.array_equal(got[0].view(np.int32), want[0].view(np.int32))):
        raise AssertionError("M3: the saved index serves other results on a mesh of 2 than of "
                             f"{mesh.shape['data']}")
    # the file holds f16 rows, so the loaded int8 codes may differ from the
    # ones quantised from the f32 rows by a rounding
    out["saved_vs_built_recall_at_10"] = float(np.mean(
        [len(set(a) & set(b)) / M3_K for a, b in zip(got[1], before[1])]))
    log(f"  M3 save of {M3_SAVE_ROWS} rows {out['save_s']:.1f} s ({out['npz_mb']:.0f} MiB), load on a mesh of "
        f"2 {out['load_s']:.1f} s: bitwise the results of the same file on {mesh.shape['data']} shards; "
        f"recall@10 against the index before the save (f32 rows, the file's are f16) "
        f"{out['saved_vs_built_recall_at_10']:.4f}")
    return out, ref


#: M5: processes of the job, rows served, seconds a process may take to
#: join and the whole phase to finish its processes
M5_WORLD, M5_ROWS, M5_JOIN_S, M5_TIMEOUT_S = 2, 1 << 20, 300, 480
#: M5's serving runs: (name, ``FusedHybridSearch`` mode, B, filtered)
M5_PLAN = (("partitioned B=64", "partitioned", 64, False), ("partitioned B=256", "partitioned", 256, False),
           ("partitioned B=64 filtered", "partitioned", 64, True), ("brute B=64", "brute", 64, False))
#: M5's train step: full-width MiniLM at f32 on a 2x2 mesh (dp across the
#: processes), one step at the schedule's peak (no warmup), on a seeded batch
M5_TRAIN_B, M5_TRAIN_L, M5_TRAIN = 32, 64, dict(warmup_steps=0, total_steps=3)


def m5_devices(torch, rank: int) -> list:
    """Process ``rank``'s two shards: two cards of its own when the host
    has a pair for every process (the backend is then NCCL), else both on
    ``cuda:0``, shared with the other process (gloo)."""
    if torch.cuda.device_count() >= 2 * M5_WORLD:
        return [torch.device("cuda", 2 * rank), torch.device("cuda", 2 * rank + 1)]
    return [torch.device("cuda", 0)] * 2


def m5_fused(torch, np, work: Path, mesh, dev) -> dict:
    """Both M5 searches over the rows in ``work`` on ``mesh``: the served
    state (phase 3's trie, the case columns, the rows with phase A's
    centroids) and a ``FusedHybridSearch`` per mode, keyed by mode."""
    from trie_semantic_search_tpu_torch.core.config import AnnConfig, VectorConfig
    from trie_semantic_search_tpu_torch.index.ann import PartitionedANN
    from trie_semantic_search_tpu_torch.index.trie import TrieIndex
    from trie_semantic_search_tpu_torch.index.vector import VectorIndex
    from trie_semantic_search_tpu_torch.models.embedder import Embedder
    from trie_semantic_search_tpu_torch.models.minilm import MiniLM, MiniLMConfig
    from trie_semantic_search_tpu_torch.models.tokenizer import WordPieceTokenizer, train_wordpiece_vocab
    from trie_semantic_search_tpu_torch.search.fused import FusedHybridSearch

    rows, refs, cents = (np.load(work / f"{n}.npy") for n in ("rows", "refs", "cents"))
    trie = TrieIndex.load_from_disk(work / "trie", device=dev)
    columns = serving_columns(np, P_PARTS * M_SLOTS // CHUNKS_PER_CASE)
    cfg = VectorConfig()
    cfg.hnsw = AnnConfig(num_probes=MESH_NPROBE)
    ann = PartitionedANN(cfg.hnsw, device=dev)
    ann.centroids, ann.num_vectors = torch.tensor(cents, device=dev), rows.shape[0]
    # the query vectors come with the batches: a small encoder stands in
    tok = WordPieceTokenizer(train_wordpiece_vocab(WORDS, vocab_size=1024, min_frequency=1))
    small = MiniLM(MiniLMConfig(vocab_size=1024, num_layers=1, max_position=64), device=dev)
    vm = VectorIndex(cfg, embedder=Embedder(tokenizer=tok, model=small, device=dev), device=dev)
    vm.set_frozen(refs, rows, ann)
    return {mode: FusedHybridSearch(trie, vm, columns, ann_mode=mode, mesh=mesh,
                                    flat_escalate_eps=serving_settings()[2])
            for mode in ("partitioned", "brute")}


def m5_serve(fused: dict, batches: dict) -> dict:
    """M5_PLAN's batches through ``query_batch`` at the serving settings."""
    out = {}
    for name, mode, B, filtered in M5_PLAN:
        texts, cf, dr, q = batches[(B, filtered)]
        out[name] = fused[mode].query_batch(q, texts, cf, dr, [0.0] * B, [2.0] * B, k=K,
                                            overfetch=serving_settings()[0],
                                            recall_target=serving_settings()[1])
    return out


def m5_train(torch, np, mesh, seed: int) -> tuple[float, dict]:
    """M5's train step on ``mesh``: the loss and the parameters after it."""
    from trie_semantic_search_tpu_torch.models import minilm, train

    cfg = minilm.MiniLMConfig()
    rng = np.random.default_rng(seed + 9)
    batch = {}
    for side in ("a", "b"):
        ids = rng.integers(1, cfg.vocab_size, (M5_TRAIN_B, M5_TRAIN_L)).astype(np.int32)
        mask = (np.arange(M5_TRAIN_L)[None, :] < rng.integers(8, M5_TRAIN_L + 1, (M5_TRAIN_B, 1))).astype(np.int32)
        batch[f"ids_{side}"], batch[f"mask_{side}"] = ids * mask, mask
    step = train.make_sharded_train_step(mesh, cfg, train.TrainConfig(**M5_TRAIN))
    state = step.init(minilm.MiniLM(cfg, device=mesh.first_device, seed=seed, compute_dtype=torch.float32))
    loss, _ = step(state, batch)
    return float(loss), {k: v.cpu().numpy() for k, v in step.gather(state).state_dict().items()}


def m5_child(torch, np, sk, rank: int, port: int, work: Path, seed: int) -> int:
    """One process of M5: joins the job (``make_distributed_mesh``, a 4x1
    mesh of two shards per process), builds both searches from the rows
    in ``work``, serves M5_PLAN (counts set to 0 just before, read just
    after; every probe, rescore and fused-scan call kept and then held
    against its plain version), searches ``ShardedCorpusIndex`` over the
    rows in int8 and bf16, runs M5's train step on a 2x2 mesh of the same
    job, leaves the job, and writes ``rank<r>.npz`` and ``rank<r>.json``."""
    from trie_semantic_search_tpu_torch.core.config import MeshConfig
    from trie_semantic_search_tpu_torch.index.sharded import ShardedCorpusIndex
    from trie_semantic_search_tpu_torch.parallel.mesh import make_distributed_mesh, shutdown_distributed

    t_start = time.perf_counter()
    sk.exact_float32()
    sk.load_library()
    devs = m5_devices(torch, rank)
    address, timeout = f"127.0.0.1:{port}", dt.timedelta(seconds=M5_JOIN_S)
    info: dict = {"rank": rank, "devices": [str(d) for d in devs]}
    arrays: dict = {}
    try:
        mesh = make_distributed_mesh(MeshConfig(), address, M5_WORLD, rank, devices=devs, timeout=timeout)
        info.update(join_s=time.perf_counter() - t_start, backend=mesh.backend, local_rows=mesh.local_data_rows,
                    shape=mesh.shape)
        t = time.perf_counter()
        fused = m5_fused(torch, np, work, mesh, devs[0])
        torch.cuda.synchronize()
        info["build_s"] = time.perf_counter() - t
        with open(work / "batches.pkl", "rb") as f:
            batches = pickle.load(f)
        with kept_calls(sk, MESH_HELD) as calls:
            sk.reset_launch_counts()
            t = time.perf_counter()
            served = m5_serve(fused, batches)
            torch.cuda.synchronize()
            info["serve_s"] = time.perf_counter() - t
            info["launches"] = dict(sk.LAUNCHES)
        t = time.perf_counter()
        info["plain_err"], info["held"] = hold_against_plain(torch, sk, calls), held_counts(calls)
        info["hold_s"] = time.perf_counter() - t
        del calls, fused
        torch.cuda.empty_cache()
        for name, outs in served.items():
            arrays.update({f"{name}/{i}": a for i, a in enumerate(outs)})
        rows, q3 = np.load(work / "rows.npy"), np.load(work / "q3.npy")
        t = time.perf_counter()
        for use_int8 in (True, False):
            idx = ShardedCorpusIndex(mesh, use_int8=use_int8)
            idx.build(rows)
            v, i = idx.search_brute(q3, M3_K)
            arrays[f"index {'int8' if use_int8 else 'bf16'}/0"], arrays[f"index {'int8' if use_int8 else 'bf16'}/1"] = v, i
            del idx
        info["index_s"] = time.perf_counter() - t
        t = time.perf_counter()
        tmesh = make_distributed_mesh(MeshConfig(model_parallel=2), address, M5_WORLD, rank, devices=devs)
        info["train_loss"], params = m5_train(torch, np, tmesh, seed)
        info["train_s"], info["train_local_rows"] = time.perf_counter() - t, tmesh.local_data_rows
        arrays.update({f"train/{k}": v for k, v in params.items()})
    finally:
        shutdown_distributed()
    info["seconds"] = time.perf_counter() - t_start
    np.savez(work / f"rank{rank}.npz", **arrays)
    (work / f"rank{rank}.json").write_text(json.dumps(info, default=str))
    return 0


def distributed_phase(torch, np, rows, refs, cents, fused, batches, m3_ref, seed: int, out_dir: Path) -> dict:
    """M5, the mesh across processes. ``M5_ROWS`` rows of phase M (M1's
    seeded order), phase A's centroids, phase 3's trie, M1's B=64, B=256
    and filtered 64 batches (their query vectors) and M3's queries go to a
    directory; ``M5_WORLD`` processes of this script (:func:`m5_child`)
    join a job on a free port of 127.0.0.1, each owning two shards of the
    4x1 mesh (:func:`m5_devices`). Meanwhile this process serves the same
    batches on a single-process mesh of four shards (phase M's) and runs
    the same train step on a 2x2 mesh of them. Every process's case rows,
    chunk rows, sources and score bits must equal this process's; its
    ``ShardedCorpusIndex`` results M3's bitwise; its train loss this one's
    within ``T0_LOSS_RTOL`` and its parameters within T0's bound (the
    steps' summed learning rates); each process must have launched the
    probe, the rescore and the fused scan (path ``distributed``), every
    call equal to its plain version. A process that fails, or outlives
    ``M5_TIMEOUT_S`` (then every process is killed), fails the phase."""
    from trie_semantic_search_tpu_torch.core.config import MeshConfig
    from trie_semantic_search_tpu_torch.parallel.mesh import make_mesh

    out: dict = {"rows": int(rows.shape[0]), "processes": M5_WORLD}
    plan_batches = {(B, f): (texts, cf, dr, q) for B, f, texts, cf, dr, q in batches
                    if any((B, f) == (b, fl) for _, _, b, fl in M5_PLAN)}
    with tempfile.TemporaryDirectory(prefix="m5_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        for name, a in (("rows", rows), ("refs", refs), ("cents", cents), ("q3", m3_ref["q"])):
            np.save(work / f"{name}.npy", np.ascontiguousarray(a))
        with open(work / "batches.pkl", "wb") as f:
            pickle.dump(plan_batches, f)
        fused.trie_index.save_to_disk(work / "trie")
        out["write_s"] = time.perf_counter() - t0
        port = free_port()
        logs = [open(out_dir / f"m5_rank{r}.log", "w") for r in range(M5_WORLD)]
        procs = [subprocess.Popen([sys.executable, str(HERE / "chip_smoke.py"), "--seed", str(seed),
                                   "--m5-rank", str(r), "--m5-port", str(port), "--m5-dir", str(work)],
                                  stdout=logs[r], stderr=subprocess.STDOUT, cwd=HERE)
                 for r in range(M5_WORLD)]
        t_spawn = time.perf_counter()
        try:
            dev = torch.device("cuda")
            mesh = make_mesh(MeshConfig(), devices=mesh_devices(torch, dev))
            t = time.perf_counter()
            want = {k: tuple(np.asarray(a) for a in v) for k, v in m5_serve(m5_fused(torch, np, work, mesh, dev),
                                                                            plan_batches).items()}
            want["index int8"], want["index bf16"] = m3_ref["int8"], m3_ref["bf16"]
            out["reference_serve_s"] = time.perf_counter() - t
            t = time.perf_counter()
            tmesh = make_mesh(MeshConfig(model_parallel=2), devices=mesh_devices(torch, dev))
            loss, params = m5_train(torch, np, tmesh, seed)
            out["reference_train_s"] = time.perf_counter() - t
            torch.cuda.empty_cache()
            for p in procs:
                p.wait(timeout=max(1.0, M5_TIMEOUT_S - (time.perf_counter() - t_spawn)))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"M5: a process outlived {M5_TIMEOUT_S} s (logs: chiprun_out/m5_rank*.log)") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        out["wall_s"] = time.perf_counter() - t_spawn
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            tails = {r: (out_dir / f"m5_rank{r}.log").read_text()[-2000:] for r, _ in bad}
            raise AssertionError(f"M5: processes exited non-zero {bad}: {tails}")
        tol = t0_param_tol()
        ranks, err = [], {"probe_candidates": 0.0, "gather_rescore": 0.0, "fused_scan": 0.0}
        for r in range(M5_WORLD):
            info = json.loads((work / f"rank{r}.json").read_text())
            with np.load(work / f"rank{r}.npz") as z:
                got = {k: z[k] for k in z.files}
            for name, arrs in want.items():
                for i, a in enumerate(arrs):
                    g = got[f"{name}/{i}"]
                    if not (g.dtype == a.dtype and g.shape == a.shape and np.array_equal(g.view(np.uint8),
                                                                                         a.view(np.uint8))):
                        raise AssertionError(f"M5 rank {r}: {name} output {i} differs from the single-process mesh's")
            pdiff = max(float(np.abs(got[f"train/{k}"] - v).max()) for k, v in params.items())
            if not (abs(info["train_loss"] - loss) <= T0_LOSS_RTOL * abs(loss) and pdiff <= tol):
                raise AssertionError(f"M5 rank {r}: train loss {info['train_loss']} vs {loss}, parameters off "
                                     f"by {pdiff} (bound {tol})")
            c = info["launches"]
            if min(c["probe_candidates"], c["gather_rescore"], c["fused_scan"]) <= 0 or c["fused_scan_dp4a"]:
                raise AssertionError(f"M5 rank {r} did not launch the probe, rescore and fused scan: {c}")
            for k, e in info.pop("plain_err").items():
                err[k] = max(err[k], e)
            info["train_param_max_diff"] = pdiff
            ranks.append(info)
            log(f"  M5 rank {r} ({info['backend']}, shards {info['local_rows']} on {info['devices']}): joined in "
                f"{info['join_s']:.1f} s, both searches built in {info['build_s']:.1f} s, served {len(M5_PLAN)} "
                f"batches in {info['serve_s']:.2f} s, held {info['held']} against the plain versions in "
                f"{info['hold_s']:.1f} s; index int8 and bf16 {info['index_s']:.1f} s; train step (rows "
                f"{info['train_local_rows']} of 2x2) {info['train_s']:.1f} s, loss {info['train_loss']:.6f} "
                f"(one process {loss:.6f}), parameters within {pdiff:.3g} of one process's (bound {tol:.3g}); "
                f"process {info['seconds']:.1f} s")
            log(f"  M5 launches on the distributed path, rank {r}: {c}")
    out.update(ranks=ranks, launches=[i["launches"] for i in ranks], plain_err=err, train_loss=loss,
               param_tol=tol)
    log(f"  M5: every rank's {len(want)} outputs ({', '.join(want)}) bitwise the single-process mesh's; "
        f"rows written in {out['write_s']:.1f} s, reference {out['reference_serve_s']:.1f} s + train "
        f"{out['reference_train_s']:.1f} s, processes done {out['wall_s']:.1f} s after their start; "
        f"plain-version differences {err}")
    return out


def mesh_engine_phase(torch, np, sk, seed: int, work: Path, dev):
    """M4: ``SearchEngine(mesh=)`` over phase B's saved artifacts loaded
    with the mesh (``load_artifacts(mesh=)``: the vector index a
    ``ShardedCorpusIndex`` rebuilt from the saved vectors; the fused state
    sharded-partitioned, k-means on the card), ``search_batch`` at B=8 and
    64 (the counts set to 0 just before, read just after; every kernel
    call held): every name query has its case first, and recall@10 of the
    served cases against the engine without a mesh at recall_target 1.0
    is at least ``MESH_RECALL``."""
    from trie_semantic_search_tpu_torch.core.config import MeshConfig
    from trie_semantic_search_tpu_torch.core.types import SearchConfig
    from trie_semantic_search_tpu_torch.index.builder import load_artifacts
    from trie_semantic_search_tpu_torch.index.sharded import ShardedCorpusIndex
    from trie_semantic_search_tpu_torch.parallel.mesh import make_mesh
    from trie_semantic_search_tpu_torch.search.engine import MatchType, SearchEngine, SearchQuery
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    cfg = pipeline_config(work)
    cfg.search.enable_query_cache = False
    mesh = make_mesh(MeshConfig(), devices=mesh_devices(torch, dev))
    out: dict = {}
    t0 = time.perf_counter()
    storage = StorageManager(cfg.storage)
    loaded = load_artifacts(cfg, device=dev, mesh=mesh)
    if not isinstance(loaded[1].ann, ShardedCorpusIndex):
        raise AssertionError(f"load_artifacts(mesh=) gave a {type(loaded[1].ann).__name__}")
    engine = SearchEngine(cfg, storage, *loaded, device=dev, mesh=mesh)
    fused = engine._get_fused()
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0, mode=fused.ann_mode, m_local=fused.sp_m,
               partitions=int(fused.sp_centroids.shape[0]), nprobe=fused.sp_nprobe)
    exact_cfg = pipeline_config(work)
    exact_cfg.search.enable_query_cache = False
    exact_cfg.search.fused_recall_target = 1.0
    exact = SearchEngine(exact_cfg, storage, *load_artifacts(exact_cfg, device=dev), device=dev)
    names = case_names(np, PIPE_CASES, PIPE_NAMES, seed)
    rng = np.random.default_rng(seed + 9)
    hits, first, out["batches"] = [], 0, []
    with kept_calls(sk, MESH_HELD) as calls:
        sk.reset_launch_counts()
        runs = []
        for B in (8, 64):
            texts = texts_for(rng, names, WORDS, B)
            qs = [SearchQuery(query=t, config=SearchConfig(min_similarity=-1.0)) for t in texts]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = engine.search_batch(qs)
            runs.append((B, qs, got, (time.perf_counter() - t1) * 1e3))
        launches = dict(sk.LAUNCHES)
    if min(launches["probe_candidates"], launches["gather_rescore"]) <= 0 or launches["fused_scan_dp4a"]:
        raise AssertionError(f"M4 did not launch the probe and rescore kernels: {launches}")
    e = hold_against_plain(torch, sk, calls)
    out["held"] = held_counts(calls)
    del calls
    for B, qs, got, ms in runs:
        check_results(MatchType, set(names.values()), qs, got)
        want = exact.search_batch(qs)
        for q, g, w in zip(qs, got, want):
            if q.query in set(names.values()):
                if not g or g[0].case_metadata.name != q.query:
                    raise AssertionError(f"M4: name query {q.query!r} not led by its case")
                first += 1
            ws = {r.case_metadata.id for r in w[:10]}
            if ws:
                hits.append(len(ws & {r.case_metadata.id for r in g[:10]}) / len(ws))
        out["batches"].append(dict(B=B, wall_ms=ms))
    out["recall_at_10"] = float(np.mean(hits))
    out["name_queries_first"] = first
    log(f"  M4 load_artifacts(mesh) + SearchEngine(mesh) {out['init_s']:.1f} s ({out['mode']}, P="
        f"{out['partitions']} m_local={out['m_local']} nprobe={out['nprobe']}); search_batch "
        + ", ".join(f"B={b['B']} {b['wall_ms']:.1f} ms" for b in out["batches"])
        + f"; {first} name queries led by their case; recall@10 vs the engine without a mesh at "
        f"recall_target 1.0 {out['recall_at_10']:.4f}; launches {launches}; held {out['held']}")
    if out["recall_at_10"] < MESH_RECALL:
        raise AssertionError(f"M4 recall@10 {out['recall_at_10']:.4f} < {MESH_RECALL}")
    storage.close()
    del engine, exact, loaded, fused
    torch.cuda.empty_cache()
    return out, launches, e


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

    batches = serving_batches(np, np.random.default_rng(seed + 1), names, words, courts)
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
    records, the launch counts of exactly these batches, the stats and the
    engine (its store still open, for phase H1)."""
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
    for rec in records:
        del rec["json"]
    return warm_s, records, launches, stats, engine


#: phase H1: the loadtest's size and the queries repeated singly after it
HTTP_REQUESTS, HTTP_CONCURRENCY, HTTP_REPEATS = 1024, 64, 64
#: phase H1: score tolerance between a query served alone and in a
#: coalesced batch, on the same query embedding (the embedding cache holds
#: it): the device step's bf16 rescore bound, as between card and CPU
HTTP_SCORE_TOL = 1e-5
#: phase H1: the engine's spans read over the loadtest
HTTP_SPANS = ("search_batch", "fused_embed", "fused_device")
#: phase H2: cases stored while ``serve`` runs, then indexed incrementally
H2_NEW_CASES = 64


def plant_rows(torch, engine, texts) -> dict[str, int]:
    """Make each text a semantic hit: its query embedding (the encoder's,
    past the embedding cache) replaces one corpus row, in the nearest of
    its 8 nearest partitions with a slot left, in the int8 block, its
    scale and the bf16 rescore segment. The seeded encoder's cosines to
    the synthetic corpus lie near 0, under the default ``min_similarity``
    of 0.5 that an HTTP request cannot change, so without this a semantic
    query answers nothing. Returns text -> planted case row."""
    vi = engine.vector_index
    ann = vi.ann
    q = torch.as_tensor(vi.embedder.embed(list(texts)).embedding, device=ann.centroids.device)
    near = torch.topk(q @ ann.centroids.T, k=min(8, ann.centroids.shape[0]), dim=1).indices.tolist()
    m = ann.part_rows.shape[1]
    seg_rows = rescore_seg_rows(q.shape[1])
    used: dict[int, int] = {}
    out = {}
    for t, parts, v in zip(texts, near, q):
        p = next(p for p in parts if used.get(p, 0) < m)
        j = used.get(p, 0)
        used[p] = j + 1
        row = int(ann.part_rows[p, j])
        scale = v.abs().amax() / 127.0
        ann.part_int8[p, j] = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
        ann.part_scale[p, j] = scale
        si, so = divmod(row, seg_rows)
        ann.corpus_bf16[si][so] = v.to(torch.bfloat16)
        out[t] = row // CHUNKS_PER_CASE
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sk_:
        sk_.bind(("127.0.0.1", 0))
        return sk_.getsockname()[1]


def same_results(a, b, tol: float) -> float:
    """Case ids, order and match types equal; returns the largest score
    difference, which must be within ``tol``."""
    ids = lambda rs: [(r.case_metadata.id, r.match_type) for r in rs]  # noqa: E731
    if ids(a) != ids(b):
        raise AssertionError(f"results differ: {ids(a)} vs {ids(b)}")
    worst = max((abs(x.score - y.score) for x, y in zip(a, b)), default=0.0)
    if worst > tol:
        raise AssertionError(f"scores differ by {worst} > {tol}")
    return worst


def http_phase(torch, np, engine, names, seed: int) -> tuple[dict, dict]:
    """Phase H1: ``ApiServer`` (default ``[server]``: batch_max 64, window
    2 ms, two batches in flight) over the engine phase's ``SearchEngine``,
    bound through aiohttp's ``AppRunner`` on 127.0.0.1 in an event loop on
    its own thread. Drives /health, POST /search (8 case names, 8 semantic
    queries: each reply equals ``search_batch([q])`` with the query cache
    cleared), GET /search, /graphql, /completions, /stats and three 400s,
    then the port's ``loadtest`` (1,024 distinct queries at concurrency 64
    after its warm pass, the caches cleared between the two), then serves
    64 of its queries alone and holds them against what the burst served.
    Returns the record and the launch counts of the HTTP requests alone."""
    import asyncio
    import copy
    import threading

    import aiohttp
    from aiohttp import web

    from trie_semantic_search_tpu_torch.api.server import ApiServer
    from trie_semantic_search_tpu_torch.cli import build_parser, run_loadtest
    from trie_semantic_search_tpu_torch.core.metrics import metrics
    from trie_semantic_search_tpu_torch.core.types import AppState
    from trie_semantic_search_tpu_torch.ops import scan_kernels as sk
    from trie_semantic_search_tpu_torch.search.engine import SearchQuery

    rec: dict = {}
    rng = np.random.default_rng(seed + 4)
    named = list(names.values())
    name_qs = [named[i] for i in rng.choice(len(named), 8, replace=False)]
    sem_qs = [f"semantic probe {i} " + " ".join(rng.choice(WORDS, 5)) for i in range(8)]
    la = build_parser().parse_args([
        "loadtest", "--requests", str(HTTP_REQUESTS), "--concurrency", str(HTTP_CONCURRENCY),
        "--timeout", "300"])
    load_qs = [la.query_template.format(i=i) for i in range(HTTP_REQUESTS)]
    # only the 8 semantic queries are planted: the encoder's embeddings of
    # the loadtest's queries lie close to theirs (cosine above 0.5), so the
    # loadtest's queries are semantic hits of these rows; planting each of
    # them too would make their top-k boundaries flat and escalate them
    t0 = time.perf_counter()
    planted = plant_rows(torch, engine, sem_qs)
    rec["plant_s"] = time.perf_counter() - t0
    engine.query_cache.clear()

    # the default [server] section but the per-client rate limit (1,000 a
    # minute), which would refuse most of a loadtest sent from one client
    config = copy.deepcopy(engine.config)
    config.server.rate_limit_rpm = 10**9
    server = ApiServer(AppState(config=config, search_engine=engine, storage=engine.storage))
    cfg = config.server
    la.url = f"http://127.0.0.1:{free_port()}"
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="http-server", daemon=True)
    thread.start()
    runner = web.AppRunner(server.app, access_log=None)
    on_loop = lambda coro: asyncio.run_coroutine_threadsafe(coro, loop).result(120)  # noqa: E731
    on_loop(runner.setup())
    on_loop(web.TCPSite(runner, "127.0.0.1", int(la.url.rsplit(":", 1)[1])).start())
    log(f"  serving on {la.url}: batch_max {cfg.batch_max}, window {cfg.batch_window_ms} ms, "
        f"inflight {cfg.batch_inflight}, max pending {cfg.batch_max_pending}, rate limit "
        f"{cfg.rate_limit_rpm}/min; {len(planted)} semantic rows planted in {rec['plant_s']:.1f} s")

    async def call(s, method, path, want, **kw):
        async with s.request(method, path, **kw) as r:
            body = await r.json() if r.content_type == "application/json" else await r.text()
            if r.status != want:
                raise AssertionError(f"{method} {path} {kw}: {r.status}, want {want}: {body}")
            return body

    async def drive() -> list:
        async with aiohttp.ClientSession(base_url=la.url) as s:
            h = await call(s, "GET", "/health", 200)
            if set(h["components"].values()) != {"healthy"}:
                raise AssertionError(f"/health: {h}")
            posts = [await call(s, "POST", "/search", 200, json={"query": q}) for q in name_qs + sem_qs]
            await call(s, "GET", "/search", 200, params={"query": name_qs[0], "limit": "5"})
            gql = await call(s, "POST", "/graphql", 200, json={
                "query": f'{{ search(query: "{sem_qs[0]}", limit: 3) {{ caseName score matchType }} }}'})
            if gql["data"]["search"][0]["matchType"] != "semantic":
                raise AssertionError(f"/graphql: {gql}")
            comps = await call(s, "GET", "/completions", 200, params={"prefix": name_qs[1].split()[0]})
            if not comps["completions"]:
                raise AssertionError(f"/completions: {comps}")
            await call(s, "GET", "/stats", 200)
            await call(s, "POST", "/search", 400, json={"query": "a"})
            await call(s, "POST", "/search", 400, data=b"not json")
            await call(s, "GET", "/search", 400)
            return posts

    async def batching() -> dict:
        async with aiohttp.ClientSession(base_url=la.url) as s:
            return (await call(s, "GET", "/stats", 200))["batching"]

    def clear_caches() -> None:
        # between the loadtest's warm pass and its measured run: the warm
        # pass sent the run's first 64 queries, which would otherwise come
        # back from the query cache without reaching the batcher or the card
        engine.query_cache.clear()
        engine.vector_index.cache.clear()

    # the counts of the http path: set to 0 just before the first request
    # and read just after the loadtest, before any direct search_batch call
    sk.reset_launch_counts()
    try:
        posts = asyncio.run(drive())
        b0 = asyncio.run(batching())
        spans0 = {n: (metrics.histogram(n).count, metrics.histogram(n).total_ms) for n in HTTP_SPANS}
        t0 = time.perf_counter()
        rec["loadtest"] = asyncio.run(run_loadtest(la, after_warm=clear_caches))
        rec["loadtest_s"] = time.perf_counter() - t0
        b1 = asyncio.run(batching())
        launches = dict(sk.LAUNCHES)
        # the engine's own spans over the loadtest (warm pass included):
        # batches, ms per batch, and the batch workers' busy share of the wall
        rec["spans"] = {}
        for n, (c0, ms0) in spans0.items():
            c, ms = metrics.histogram(n).count - c0, metrics.histogram(n).total_ms - ms0
            rec["spans"][n] = dict(count=c, ms_per_batch=ms / max(c, 1),
                                   busy_workers=ms / (rec["loadtest_s"] * 1e3))
    finally:
        on_loop(runner.cleanup())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
        loop.close()
    if thread.is_alive():
        raise AssertionError("the HTTP server's thread did not stop")
    lt = rec["loadtest"]
    if lt["errors"] or lt["by_status"] != {"200": HTTP_REQUESTS}:
        raise AssertionError(f"loadtest replies: {lt}")
    batches, items = b1["batches"] - b0["batches"], b1["items"] - b0["items"]
    rec.update(batches=batches, items=items, mean_batch=items / max(batches, 1),
               ghosts=b1["ghosts_dropped"], shed=b1["shed"], batch_failures=b1["batch_failures"])
    if rec["mean_batch"] <= 1.0:
        raise AssertionError(f"the batcher did not coalesce: {items} items in {batches} batches")

    # what the burst served (the query cache holds each coalesced batch's
    # results) against the same queries served alone, on the same query
    # embeddings (the embedding cache holds the last 1,000; the queries
    # are taken from the run's second half). This comes before the checks
    # of the single replies below, which clear the query cache.
    step = (HTTP_REQUESTS // 2) // HTTP_REPEATS
    qs = [SearchQuery(query=load_qs[i], max_results=5)
          for i in range(HTTP_REQUESTS // 2, HTTP_REQUESTS, step)][:HTTP_REPEATS]
    burst = [engine.query_cache.get(engine._cache_key(q)) for q in qs]
    if any(b is None for b in burst) or any(engine.vector_index.cache.get(q.query) is None for q in qs):
        raise AssertionError("a loadtest query is not in the query or embedding cache")
    worst, served = 0.0, 0
    for q, b in zip(qs, burst):
        engine.query_cache.clear()
        alone = engine.search_batch([q])[0]
        worst = max(worst, same_results(alone, b, HTTP_SCORE_TOL))
        served += len(alone)
        if not alone or alone[0].match_type.value != "semantic":
            raise AssertionError(f"{q.query!r}: no semantic hit first: {alone[:1]}")

    # each single reply of drive() against search_batch([q]) with the query
    # cache cleared (the server has stopped meanwhile)
    for q, body in zip(name_qs + sem_qs, posts):
        engine.query_cache.clear()
        want = engine.search_batch([SearchQuery(query=q)])[0]
        served_ids = [(uuid.UUID(r["case_metadata"]["id"]), r["match_type"]) for r in body["results"]]
        if served_ids != [(r.case_metadata.id, r.match_type.value) for r in want] or any(
                abs(r["score"] - w.score) > HTTP_SCORE_TOL for r, w in zip(body["results"], want)):
            raise AssertionError(f"POST /search {q!r} differs from search_batch([q])")
        top = want[0] if want else None
        if q in planted:
            ok = top is not None and top.match_type.value == "semantic" and \
                engine.columns.row_of_case[top.case_metadata.id] == planted[q]
        else:
            ok = top is not None and top.case_metadata.name == q and \
                top.match_type.value in ("case_name", "exact")
        if not ok:
            raise AssertionError(f"POST /search {q!r}: top hit {top and top.case_metadata.name}")
    rec["post_checks"] = len(posts)
    rec.update(single_vs_burst=len(qs), single_vs_burst_results=served,
               single_vs_burst_max_score_diff=worst, escalated=engine.get_stats().escalated_queries)
    return rec, launches


def run_cli(args: list[str], toml: Path, timeout: float, stderr: list | None = None) -> tuple[str, float]:
    """``python3 -m trie_semantic_search_tpu_torch.cli -c toml *args``:
    its stdout and seconds (its stderr, the log, appended to ``stderr``
    when given); fails unless it exits 0."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "trie_semantic_search_tpu_torch.cli", "-c", str(toml),
                          *args], cwd=HERE, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"cli {args} exited {out.returncode}: {out.stderr[-3000:]}")
    if stderr is not None:
        stderr.append(out.stderr)
    return out.stdout, time.perf_counter() - t0


def cli_phase(np, seed: int, work: Path, out_dir: Path) -> dict:
    """Phase H2: the CLI lifecycle over phase B's store and artifacts. A
    TOML config; ``config-dump``, ``check-health``, ``search`` and
    ``completions`` as subprocesses (started together); then ``serve`` in
    the background until its log says "warmup complete"; /health and
    POST /search; 64 new cases stored (ids after the old ones, so the
    incremental branch runs); ``POST /admin/reindex?mode=incremental``;
    /stats polled until they are indexed; a new case found by name;
    ``quality.json`` beside the vectors; SIGINT, exit 0, "shutting down"
    in the log. Each step's seconds. :func:`cli_fresh_lifecycle` runs in a
    thread beside the ``serve`` lifecycle (its own store, no server)."""
    import concurrent.futures
    import signal
    import urllib.request

    from trie_semantic_search_tpu_torch.core.config import Config
    from trie_semantic_search_tpu_torch.core.types import CaseMetadata
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    cfg = Config()
    cfg.storage.db_path = str(work / "pipeline.sqlite")
    cfg.storage.backup.backup_dir = str(work / "backups")
    cfg.trie.index_path = str(work / "trie")
    cfg.vector.hnsw.index_path = str(work / "vec")
    cfg.vector.pooling = "mean"
    cfg.server.port = free_port()
    toml = work / "serve.toml"
    cfg.save_to_file(toml)
    names = case_names(np, PIPE_CASES, PIPE_NAMES, seed)
    name = names[min(names)]
    prefix = " ".join(name.split()[:2])
    rec: dict = {"steps_s": {}}
    steps = rec["steps_s"]

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = {k: pool.submit(run_cli, a, toml, 600) for k, a in (
            ("config-dump", ["config-dump"]), ("check-health", ["check-health"]),
            ("search", ["search", name, "--limit", "5"]), ("completions", ["completions", prefix]))}
        outs = {k: j.result() for k, j in jobs.items()}
    for k, (_, sec) in outs.items():
        steps[k] = sec
    if outs["config-dump"][0] != Config.from_file(toml).to_toml() + "\n":
        raise AssertionError("config-dump is not the config's TOML")
    if json.loads(outs["check-health"][0])["status"] != "healthy":
        raise AssertionError(f"check-health: {outs['check-health'][0]}")
    hits = json.loads(outs["search"][0])
    if not hits or hits[0]["case_metadata"]["name"] != name or hits[0]["match_type"] not in ("case_name", "exact"):
        raise AssertionError(f"cli search {name!r}: {hits[:1]}")
    comps = json.loads(outs["completions"][0])
    if not comps or not all(c.startswith(prefix.lower().replace(".", "")) for c in comps):
        raise AssertionError(f"cli completions {prefix!r}: {comps}")
    log(f"  config-dump {steps['config-dump']:.1f} s, check-health {steps['check-health']:.1f} s, "
        f"search {steps['search']:.1f} s ({len(hits)} hits, {name!r} first), completions "
        f"{steps['completions']:.1f} s ({len(comps)}), all four started together")

    # the fresh-store commands (their own store, no server) run beside the
    # serve lifecycle
    fresh_pool = concurrent.futures.ThreadPoolExecutor(1)
    fresh = fresh_pool.submit(cli_fresh_lifecycle, work / "h2_fresh")
    fresh_pool.shutdown(wait=False)
    log_path = work / "serve.log"
    base = f"http://127.0.0.1:{cfg.server.port}"

    def get(path, data=None, timeout=120):
        req = urllib.request.Request(base + path, data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())

    def wait_for(what, cond, limit):
        t0 = time.perf_counter()
        while not cond():
            if proc.poll() is not None:
                raise AssertionError(f"serve exited {proc.returncode} before {what}: "
                                     f"{log_path.read_text()[-3000:]}")
            if time.perf_counter() - t0 > limit:
                raise AssertionError(f"no {what} within {limit} s")
            time.sleep(0.2)
        return time.perf_counter() - t0

    t_start = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([sys.executable, "-m", "trie_semantic_search_tpu_torch.cli", "-c",
                                 str(toml), "serve"], cwd=HERE, stdout=logf, stderr=subprocess.STDOUT)
    try:
        steps["serve_listening"] = wait_for(
            "listening", lambda: "API server listening" in log_path.read_text(), 300)
        wait_for("warmup complete", lambda: "warmup complete" in log_path.read_text(), 600)
        steps["serve_warm"] = time.perf_counter() - t_start
        status, h = get("/health")
        if status != 200 or h["status"] != "healthy":
            raise AssertionError(f"serve /health: {status} {h}")
        status, body = get("/search", json.dumps({"query": name}).encode())
        if status != 200 or body["results"][0]["case_metadata"]["name"] != name:
            raise AssertionError(f"serve POST /search {name!r}: {status} {body['results'][:1]}")
        before = get("/stats")[1]["engine"]["total_cases_indexed"]

        t0 = time.perf_counter()
        store = StorageManager(cfg.storage)
        new_rows = range(PIPE_CASES, PIPE_CASES + H2_NEW_CASES)
        new_names = {c: f"newly filed w{c % 500} v. state {c}" for c in new_rows}
        court_ids, dates = case_columns(np, PIPE_CASES + H2_NEW_CASES)
        for c in new_rows:
            meta = case_meta(CaseMetadata, c, new_names, court_ids, dates)
            store.store_case_metadata(meta)
            store.store_case_text(meta.id, case_text(c))
        store.close()
        steps["store_new_cases"] = time.perf_counter() - t0
        req = urllib.request.Request(base + "/admin/reindex?mode=incremental", data=b"", method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as r:
            if r.status != 202 or json.loads(r.read())["mode"] != "incremental":
                raise AssertionError("reindex was not started")
        steps["reindex"] = wait_for(
            "the incremental reindex",
            lambda: get("/stats")[1]["engine"]["total_cases_indexed"] == before + H2_NEW_CASES, 600)
        new_name = new_names[PIPE_CASES + H2_NEW_CASES // 2]
        status, body = get("/search", json.dumps({"query": new_name}).encode())
        if status != 200 or body["results"][0]["case_metadata"]["name"] != new_name:
            raise AssertionError(f"new case {new_name!r} not found first: {body['results'][:1]}")
        quality = json.loads((work / "vec" / "quality.json").read_text())
        if "incremental reindex complete" not in log_path.read_text():
            raise AssertionError("the log does not record the incremental reindex")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        steps["shutdown_stopped"] = wait_for(
            "'stopped' in the log", lambda: "tss_torch.cli: stopped" in log_path.read_text(), 120)
        rc = proc.wait(timeout=120)
        steps["shutdown"] = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.copy(log_path, out_dir / "h2_serve.log")
    text = log_path.read_text()
    if rc != 0 or "shutting down" not in text:
        raise AssertionError(f"serve exited {rc} on SIGINT; 'shutting down' logged: {'shutting down' in text}")
    rec["update_log"] = next(ln for ln in text.splitlines() if "incremental update:" in ln)
    rec["reindex_backends"] = require_native("H2's incremental reindex in serve", trie_backends(text))
    rec["fresh"] = fresh.result()
    rec.update(cases_before=before, cases_after=before + H2_NEW_CASES, new_case=new_name,
               quality_gate=dict(mode=quality["mode"], degraded=quality["degraded"],
                                 trained_mrr=quality["trained"]["all"]["mrr"],
                                 control_mrr=quality["control"]["all"]["mrr"], probes=quality["probes"]))
    return rec


def cli_fresh_lifecycle(root: Path) -> dict:
    """H2 from an empty store, as an operator starts: a TOML with the
    default ``[vector] pooling = "auto"``, then ``ingest --source mock``
    (the 3 landmark cases stored), ``ingest --source mock`` again (all 3
    skipped), ``build-index --pretrain-steps 20`` (its log must carry the
    pretraining report), ``build-index --tune-recall 0.95`` (the pooling picked on
    probe merit, its record read from the build's log; with 3 cases the
    tuner is skipped, as in the JAX package) and ``search "miranda v.
    arizona"`` (Miranda first, a case-name or exact hit), one after
    another. Each command's seconds and last output line, and the pooling
    record."""
    from trie_semantic_search_tpu_torch.core.config import Config

    root.mkdir()
    cfg = Config()
    cfg.storage.db_path = str(root / "db.sqlite")
    cfg.trie.index_path = str(root / "trie")
    cfg.vector.hnsw.index_path = str(root / "vec")
    if cfg.vector.pooling != "auto":
        raise AssertionError(f"the default pooling is {cfg.vector.pooling!r}, not 'auto'")
    toml = root / "config.toml"
    cfg.save_to_file(toml)
    steps = {}
    plan = (
        ("ingest", ["ingest", "--source", "mock"],
         lambda o: json.loads(o.splitlines()[-1])["processed"] == 3),
        ("ingest again", ["ingest", "--source", "mock"],
         lambda o: (lambda d: d["skipped"] == 3 and d["processed"] == 0)(json.loads(o.splitlines()[-1]))),
        ("build-index --pretrain-steps 20", ["build-index", "--pretrain-steps", "20"],
         lambda o: json.loads(o.splitlines()[-1])["cases"] == 3),
        ("build-index --tune-recall 0.95", ["build-index", "--tune-recall", "0.95"],
         lambda o: json.loads(o.splitlines()[-1])["cases"] == 3),
        ("search", ["search", "miranda v. arizona"],
         lambda o: (lambda h: h[0]["case_metadata"]["name"] == "Miranda v. Arizona"
                    and h[0]["match_type"] in ("case_name", "exact"))(json.loads(o))),
    )
    for key, argv, ok in plan:
        logs: list[str] = []
        out, sec = run_cli(argv, toml, 600, stderr=logs)
        if not ok(out):
            raise AssertionError(f"cli {argv} from an empty store: {out[-2000:]}")
        first = json.loads(out)[0] if key == "search" else None
        steps[key] = dict(s=sec, out=out.splitlines()[-1] if first is None else
                          f"{first['case_metadata']['name']} ({first['match_type']})")
        log(f"  fresh store: {key} exit 0 in {sec:.1f} s: {steps[key]['out']}")
        if key.startswith("build-index"):
            steps[key]["trie_backends"] = require_native(f"H2's {key}", trie_backends(logs[0]))
        if key.startswith("build-index --pretrain"):
            rep = [ln.split("encoder pretraining: ", 1)[1] for ln in logs[0].splitlines()
                   if "encoder pretraining: " in ln]
            if not rep or "'steps': 20" not in rep[-1]:
                raise AssertionError(f"build-index --pretrain-steps 20 logged no pretraining report: "
                                     f"{logs[0][-2000:]}")
            steps["pretraining"] = rep[-1]
            log(f"  fresh store: pretraining report {rep[-1]}")
        elif key.startswith("build-index"):
            pick = [ln.split("pooling selection: ", 1)[1] for ln in logs[0].splitlines()
                    if "pooling selection: " in ln]
            if not pick:
                raise AssertionError(f"the build with pooling 'auto' logged no pooling selection: "
                                     f"{logs[0][-2000:]}")
            steps["pooling"] = pick[-1]
            log(f"  fresh store: pooling 'auto' picked {pick[-1]}")
    return steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["kernels", "wide", "int8-ablations", "stream", "train", "mesh", "build"],
                    help="kernels: the device, kernel build, small-reference and kernel phases "
                         "only (no index builds, serving, profile, store or engine); wide: phase 4W "
                         "alone (the DeepSeek-V2-Lite cell's kernels at D=2048 and its routed experts); "
                         "int8-ablations: the device time of each ablation build of the int8 "
                         "top-k's wgmma variant at its timed case; stream: the build phases only "
                         "(A with S1, B with S2 and the evaluation), with no kernel timing, "
                         "serving, store or engine; train: phase T alone (pretraining, its own "
                         "store; the sharded step T3 included) after the kernel build and the small "
                         "reference; mesh: the sharded phases M1-M5 (M5: two processes) after the card "
                         "state, phase A (without S1 and the case tuner) and phase B; build: phase A "
                         "(without S1 and the case tuner), phase B and phase P")
    ap.add_argument("--ingest-cases", type=int, default=ING_CASES,
                    help="fixture cases phase I ingests (at least 1,024; its time grows with the "
                         "square of the count)")
    # one process of phase M5's job (the script starts them itself)
    ap.add_argument("--m5-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--m5-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--m5-dir", default=None, help=argparse.SUPPRESS)
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

    if args.m5_rank is not None:
        return m5_child(torch, np, sk, args.m5_rank, args.m5_port, Path(args.m5_dir), args.seed)
    if args.only in ("kernels", "wide", "int8-ablations"):
        return run(torch, np, sk, args.seed, "", None, only=args.only)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.only:
            return run(torch, np, sk, args.seed, str(Path(tmp) / "cases.sqlite"), None, only=args.only)
        db_path = str(Path(tmp) / "cases.sqlite")
        n_cases = P_PARTS * M_SLOTS // CHUNKS_PER_CASE
        store = multiprocessing.get_context("spawn").Process(
            target=build_store, args=(db_path, n_cases, N_NAMES, args.seed))
        store.start()
        try:
            return run(torch, np, sk, args.seed, db_path, store, ingest_cases=args.ingest_cases)
        finally:
            if store.is_alive():
                store.terminate()
            store.join()


def run(torch, np, sk, seed: int, db_path: str, store, only: str | None = None,
        ingest_cases: int = ING_CASES) -> int:
    t_start = time.perf_counter()
    card = gpu_line()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    sk.exact_float32()
    import threading

    from trie_semantic_search_tpu_torch import native

    host_build = threading.Thread(target=native.available)  # g++ beside nvcc
    host_build.start()
    lib = sk.load_library()
    log(f"kernel library: {lib.path.name} built in {lib.build_seconds:.2f} s")
    host_build.join()
    if not native.available():
        raise AssertionError("the native host library did not build (g++): see the log above")
    log(f"native host library: {native.LIBRARY_PATH.parent.name}/{native.LIBRARY_PATH.name} built and "
        f"loaded in {native.BUILD_SECONDS:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    detail = {"gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_seconds": lib.build_seconds, "build_log": lib.log,
              "native_build_seconds": native.BUILD_SECONDS}

    log("phase: small-input reference (CPU plain versions vs card kernels)")
    detail["small_reference_max_score_diff"] = small_reference(torch, np, seed)
    log(f"  agree; max score difference {detail['small_reference_max_score_diff']:.3g}")

    out_dir = Path.cwd() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    work = Path(db_path).parent

    def note_errs(kernels, *errs) -> None:
        for err in errs:
            for k, e in err.items():
                if k in kernels:
                    kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], e)

    def build_phases(kernels, paths, state: dict | None = None, full: bool = True) -> None:
        """A (with S1 and the case tuner when ``full``), then with the
        serving ``state`` of phase 3 the sharded phases M1-M3, B, M4 after
        B (it serves B's artifacts), and S2 when ``full``."""
        log(f"phase: build: ANN at full size ({P_PARTS * M_SLOTS} rows, D={DIM}; counts reset just "
            "before the recall search, read just after)")
        keep = {} if state is not None else None
        detail["build_ann"], paths["build"], tuner, streamed = ann_build_phase(
            torch, np, seed, work, keep, full)
        note_errs(kernels, detail["build_ann"]["plain_err"])
        if full:
            paths["case_tuner"], paths["stream_ann"] = tuner, streamed
            note_errs(kernels, detail["build_ann"]["case_tuner"]["plain_err"],
                      detail["build_ann"]["stream_ann"]["plain_err"])
        if state is not None:
            devs = mesh_devices(torch, state["vi"].device)
            log(f"phase: M1-M3 and M5, sharded serving over phase A's rows in a seeded order ({len(devs)} shards "
                f"on {sorted({str(d) for d in devs})}; counts reset just before each serving run, "
                "read just after)")
            t0 = time.perf_counter()
            detail["mesh"], paths["sharded"], err = mesh_phase(
                torch, np, sk, state["fused"], state["vi"], keep.pop("host"), keep.pop("centroids"),
                state["names"], WORDS, COURTS, seed, out_dir)
            note_errs(kernels, err)
            for r, counts in enumerate(detail["mesh"]["m5"]["launches"]):
                paths[f"distributed rank {r}"] = counts
            detail["mesh"]["seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            log(f"  {card}: phase M1-M3 and M5 {detail['mesh']['seconds']:.1f} s")
        log("phase: build: pipeline end to end (build_indexes -> save_artifacts -> load_artifacts "
            "-> SearchEngine)")
        kept: dict = {}
        detail["build_pipeline"] = pipeline_phase(torch, np, seed, work, kept)
        log(f"phase: P, the rest of the public surface on the card ({P_ROWS} of phase A's rows, phase B's "
            "tries and encoder)")
        t0 = time.perf_counter()
        detail["surface"] = surface_phase(torch, np, seed, kept.pop("built"), kept.pop("names"))
        detail["surface"]["seconds"] = time.perf_counter() - t0
        log(f"  {card}: phase P {detail['surface']['seconds']:.1f} s")
        if state is not None:
            log("phase: M4, SearchEngine(mesh) over phase B's artifacts loaded with the mesh (counts "
                "reset just before the batches, read just after)")
            t0 = time.perf_counter()
            detail["mesh"]["m4"], launches, err = mesh_engine_phase(torch, np, sk, seed, work,
                                                                    state["vi"].device)
            paths["sharded"] = {n: c + launches[n] for n, c in paths["sharded"].items()}
            note_errs(kernels, err)
            detail["mesh"]["m4"]["seconds"] = time.perf_counter() - t0
            log(f"  {card}: phase M4 {detail['mesh']['m4']['seconds']:.1f} s; launches on the sharded "
                f"path (M1 + M2 + M4) {paths['sharded']}")
        if not full:
            return
        log(f"phase: S2, build-index --streaming over phase B's store ({PIPE_CASES} cases), SIGKILLed "
            f"at {S2_KILL_SHARDS} shards and resumed in this process (counts reset just before the "
            "resume and before the evaluation, read just after each)")
        t0 = time.perf_counter()
        detail["stream_build"], paths["stream_build"], paths["eval"] = stream_build_phase(
            torch, np, sk, work, out_dir)
        detail["stream_build"]["seconds"] = time.perf_counter() - t0
        note_errs(kernels, detail["stream_build"]["plain_err"], detail["stream_build"]["eval"]["plain_err"])
        log(f"  {card}: phase S2 {detail['stream_build']['seconds']:.1f} s")

    def train_phases(kernels, paths) -> None:
        log(f"phase: T, pretraining ({TRAIN_CASES} cases of its own; T2 SIGKILLed at {TRAIN_KILL_SHARDS} "
            "shards and resumed in this process, counts reset just before the resume, read just after)")
        t0 = time.perf_counter()
        detail["train"], paths["pretrain_build"] = train_phase(torch, np, sk, seed, work, out_dir)
        detail["train"]["seconds"] = time.perf_counter() - t0
        note_errs(kernels, detail["train"]["t2"]["plain_err"])
        log(f"  {card}: phase T {detail['train']['seconds']:.1f} s")

    if only == "wide":
        log(f"phase: W, the DeepSeek-V2-Lite cell's kernels at D={WIDE_D}")
        paths = {}
        detail["wide"], paths[f"wide D={WIDE_D}"] = wide_phase(torch, np, seed)
        return finish(torch, detail, {}, paths, out_dir, card, t_start)
    if only in ("stream", "build"):
        paths: dict = {}
        build_phases({}, paths, full=only == "stream")
        return finish(torch, detail, {}, paths, out_dir, card, t_start)
    if only == "train":
        paths = {}
        train_phases({}, paths)
        return finish(torch, detail, {}, paths, out_dir, card, t_start)
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
    state = dict(fused=fused, vi=vi, names=names)
    if only == "mesh":
        paths = {}
        build_phases({}, paths, state, full=False)
        return finish(torch, detail, {}, paths, out_dir, card, t_start)
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
    log(f"phase: W, the DeepSeek-V2-Lite cell's kernels at D={WIDE_D} (probe and fused scan vs plain, the "
        "routed experts' grouped products vs the plain loop, then Embedder -> DeepseekV2.encode with the "
        "counts reset just before, read just after)")
    t0 = time.perf_counter()
    detail["wide"], paths[f"wide D={WIDE_D}"] = wide_phase(torch, np, seed)
    detail["wide"]["seconds"] = time.perf_counter() - t0
    log(f"  {card}: phase W {detail['wide']['seconds']:.1f} s")
    if only == "kernels":
        for k in SERVING_KERNELS:
            kernels[k]["launches"] = None
        return finish(torch, detail, kernels, paths, out_dir, card, t_start)

    build_phases(kernels, paths, state)
    log(f"phase: I, ingest -> tuned build -> serve ({ingest_cases} fixture cases and {2 * ING_PLANTED} "
        "planted through ingest_bulk; counts reset just before build_indexes(tune_recall), read "
        "just after)")
    t0 = time.perf_counter()
    detail["ingest"], paths["tune"] = ingest_phase(torch, np, sk, ingest_cases, seed, work)
    detail["ingest"]["seconds"] = time.perf_counter() - t0
    note_errs(kernels, detail["ingest"]["plain_err"])
    log(f"  {card}: phase I {detail['ingest']['seconds']:.1f} s")
    train_phases(kernels, paths)

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
    warm_s, erecs, elaunches, stats, engine = engine_phase(torch, np, fused, vi, names, db_path, seed)
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

    log("phase: H1 HTTP over the full-size engine (ApiServer + BatchingQueue; counts reset just "
        "before the first request, read just after the loadtest)")
    t0 = time.perf_counter()
    h1, hlaunches = http_phase(torch, np, engine, names, seed)
    engine.storage.close()
    h1["seconds"] = time.perf_counter() - t0
    lt = h1["loadtest"]
    log(f"  {card}: loadtest {lt['requests']} requests at concurrency {lt['concurrency']}: errors "
        f"{lt['errors']}, by_status {lt['by_status']}, {lt['qps']} QPS, p50 {lt['p50_ms']} ms, p95 "
        f"{lt['p95_ms']} ms, p99 {lt['p99_ms']} ms ({lt['wall_s']} s)")
    log(f"  batcher over the loadtest (warm pass included): {h1['items']} requests in {h1['batches']} "
        f"batches, mean batch {h1['mean_batch']:.2f}; ghosts {h1['ghosts']}, shed {h1['shed']}, "
        f"failed batches {h1['batch_failures']}; escalated queries {h1['escalated']}")
    log("  engine spans over the loadtest (warm pass included): " + "; ".join(
        f"{n} {v['count']} x {v['ms_per_batch']:.2f} ms, busy {v['busy_workers']:.2f} workers"
        for n, v in h1["spans"].items()))
    log(f"  {h1['post_checks']} single POST /search replies equal search_batch([q]); "
        f"{h1['single_vs_burst']} loadtest queries served alone equal their burst results (ids, "
        f"order, match types; max score difference {h1['single_vs_burst_max_score_diff']:.3g}, "
        f"tolerance {HTTP_SCORE_TOL})")
    log(f"  launches on the http path: {hlaunches} (fused_scan: {hlaunches['fused_scan']}; the "
        f"coalesced batches of at most {HTTP_CONCURRENCY} probe); phase {h1['seconds']:.1f} s")
    missing = [k for k in ("probe_candidates", "gather_rescore") if hlaunches[k] <= 0]
    if missing or hlaunches["fused_scan_dp4a"]:
        raise AssertionError(f"kernels not launched on the http path: {missing}, or the dp4a "
                             f"fused scan launched: {hlaunches}")
    detail["http"] = h1

    log("phase: H2 CLI lifecycle over phase B's artifacts (subprocesses)")
    t0 = time.perf_counter()
    h2 = cli_phase(np, seed, work, out_dir)
    h2["seconds"] = time.perf_counter() - t0
    st = h2["steps_s"]
    log(f"  {card}: serve listening {st['serve_listening']:.1f} s, warm {st['serve_warm']:.1f} s "
        f"after start; {H2_NEW_CASES} cases stored in {st['store_new_cases']:.2f} s; incremental "
        f"reindex {st['reindex']:.1f} s ({h2['cases_before']} -> {h2['cases_after']} cases, "
        f"{h2['new_case']!r} found first; quality gate {h2['quality_gate']}); SIGINT -> 'stopped' "
        f"logged in {st['shutdown_stopped']:.1f} s, exit 0 in {st['shutdown']:.1f} s; phase "
        f"{h2['seconds']:.1f} s")
    log(f"  serve's log: {h2['update_log'].split(': ', 1)[1]}; trie builders: reindex "
        f"{h2['reindex_backends']}, fresh-store builds "
        f"{[v['trie_backends'] for k, v in h2['fresh'].items() if k.startswith('build-index')]}")
    detail["cli"] = h2
    paths = {"query_batch": launches, "SearchEngine": elaunches, "http": hlaunches, **paths}
    return finish(torch, detail, kernels, paths, out_dir, card, t_start)


def host_figures(detail: dict) -> str:
    """The host figures the native library moves, from whichever phases
    ran: phase B's text + tries and trie freeze, S2's CSR pass, H2's
    reindex read-and-insert, and S1's and S2's anonymous RSS peaks."""
    parts = [f"native host library built in {detail['native_build_seconds']:.2f} s"]
    b = detail.get("build_pipeline")
    if b:
        parts.append(f"B text + tries {b['text_and_trie_s']:.2f} s, trie freeze {b['trie_freeze_s']:.2f} s")
    s2 = detail.get("stream_build")
    if s2:
        parts.append(f"S2 CSR {s2['finalize_s']['csr']:.2f} s ({s2['csr_route']}), anonymous RSS peak "
                     f"{s2['peak_anon_rss_bytes'] / 2**30:.2f} GiB")
    s1 = detail.get("build_ann", {}).get("stream_ann")
    if s1:
        parts.append(f"S1 anonymous RSS peak {(s1['rss']['peak'] - s1['rss']['base']) / 2**30:.2f} GiB above "
                     "its base")
    cli = detail.get("cli")
    if cli:
        parts.append("H2 reindex " + cli["update_log"].split("(", 1)[1].split(",", 1)[0])
    return "; ".join(parts)


def finish(torch, detail, kernels, paths, out_dir: Path, card: str, t_start: float) -> int:
    """Write the details and print the kernel line and the last line."""
    log(f"host figures ({card}): {host_figures(detail)}")
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
