"""Command line of the port: the ``legal-search-server-torch`` program (port
of ``trie_semantic_search_tpu/cli.py``, the same subcommands and options,
with ``--device`` in place of ``--platform``).

* ``serve``        — config → logging → components (loaded artifacts, or a
  build from the store when there are none or with ``--rebuild-index``) →
  health check → maintenance tasks → warmup in a background thread → the
  API server, until SIGINT or SIGTERM
* ``ingest``       — one ingestion job from a named source (``mock``,
  ``cap``, ``courtlistener``; every source without ``--source``), bulk or
  ``--incremental``
* ``build-index``  — build and save every artifact (quality gate first;
  ``--tune-recall`` tunes the ANN's nprobe by case-level recall;
  ``--pretrain-steps`` pretrains the encoder first); ``--streaming`` runs
  the checkpointed corpus-scale build (``--work-dir``, ``--shard-chunks``,
  ``--no-resume``), which pretrains and saves an encoder first when the
  vector directory holds none
* ``check-health`` — component probes, exit code 0/1
* ``search``       — one query from the command line
* ``eval-retrieval`` — held-out probes through the engine, stage by stage
  (exact oracle, ANN at the tuned nprobe), and with ``--control`` beside a
  seeded random encoder
* ``completions``  — trie prefix completions
* ``config-dump``  — the effective config as TOML
* ``loadtest``     — concurrent ``POST /search`` against a running server

With ``[mesh] enabled`` (the default) and more than one visible card, the
engine shards the corpus over the cards (``_serving_mesh``); ``bench``
raises ``NotImplementedError`` (the benchmark is not ported).

Shared flags: ``--config/-c``, ``--device`` (default ``cuda``; a missing
card is an error, ``--device cpu`` runs on the CPU), ``--port/-p`` for
``serve`` (command line > environment > file > defaults).

Run as ``python -m trie_semantic_search_tpu_torch.cli -c config.toml
serve``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import sys
from typing import Callable, Optional

from .core.config import Config
from .core.logging import init_logging
from .core.types import AppState

_log = logging.getLogger("tss_torch.cli")


def _load_config(args: argparse.Namespace) -> Config:
    cfg = Config.from_file(args.config)
    if getattr(args, "port", None):
        cfg.server.port = args.port
    return cfg


def _serving_mesh(cfg: Config, device):
    """The serving mesh: None when ``[mesh]`` is disabled, on the CPU, or
    when its data axis would be 1; otherwise a mesh over the visible cards,
    over whose data axis the engine's fused step shards the corpus (the
    JAX package's rule)."""
    if not cfg.mesh.enabled or device.type != "cuda":
        return None
    import torch

    n = torch.cuda.device_count()
    dp = cfg.mesh.data_parallel or (n // max(1, cfg.mesh.model_parallel))
    if dp <= 1:
        return None
    from .parallel.mesh import make_mesh

    mesh = make_mesh(cfg.mesh)
    _log.info("serving mesh: %s", mesh.shape)
    return mesh


def _build_components(cfg: Config, device, rebuild: bool = False):
    """Store and engine: the saved artifacts on ``device``, or (when there
    are none, or ``rebuild``) a build from the store, saved after the
    quality gate; then both health probes."""
    from .device import resolve_device
    from .index.builder import build_indexes, load_artifacts, save_artifacts
    from .search.engine import SearchEngine
    from .storage.store import StorageManager

    dev = resolve_device(device)
    storage = StorageManager(cfg.storage)
    artifacts = None if rebuild else load_artifacts(cfg, device=dev)
    if artifacts is None:
        _log.info("building index artifacts from storage ...")
        built = build_indexes(storage, cfg, device=dev)
        save_artifacts(built, cfg, storage=storage)
        trie, vector, columns = built.trie, built.vector, built.columns
    else:
        _log.info("loaded index artifacts from %s", cfg.trie.index_path)
        trie, vector, columns = artifacts
    engine = SearchEngine(cfg, storage, trie, vector, columns, device=dev,
                          mesh=_serving_mesh(cfg, dev))
    storage.health_check()
    engine.health_check()
    return storage, engine


def cmd_serve(args: argparse.Namespace) -> int:
    cfg = _load_config(args)
    init_logging(cfg.logging)
    storage, engine = _build_components(cfg, args.device, rebuild=args.rebuild_index)

    from .api.server import ApiServer
    from .core.maintenance import make_backup_task, make_gc_task
    from .core.metrics import MetricsReporter
    from .utils import SystemUtils

    reporter = None
    if cfg.logging.enable_metrics:
        reporter = MetricsReporter(
            interval_seconds=cfg.logging.metrics_interval_seconds,
            extra=lambda: {"rss": SystemUtils.memory_usage()},
        )
        reporter.start()
    maintenance = [
        t for t in (
            make_backup_task(storage, cfg.storage.backup),
            make_gc_task(cfg.performance.gc, caches=[engine.query_cache, engine.vector_index.cache]),
        ) if t is not None
    ]
    for task in maintenance:
        task.start()
    warmup_thread = None
    if not args.no_warmup:
        # warm in the background so the server binds at once; requests
        # meanwhile run beside it
        import threading

        def _warm():
            _log.info("warming up the serving shapes ...")
            engine.warmup()
            _log.info("warmup complete")

        warmup_thread = threading.Thread(target=_warm, name="warmup", daemon=True)
        warmup_thread.start()
    server = ApiServer(AppState(config=cfg, search_engine=engine, storage=storage))

    async def _main() -> None:
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        serve_task = asyncio.create_task(server.run())
        stop_task = asyncio.create_task(stop.wait())
        await asyncio.wait([serve_task, stop_task], return_when=asyncio.FIRST_COMPLETED)
        _log.info("shutting down: flushing storage, stopping batcher")
        serve_task.cancel()
        stop_task.cancel()
        await asyncio.gather(serve_task, stop_task, return_exceptions=True)
        if warmup_thread is not None and warmup_thread.is_alive():
            # let the warmup's device work finish before the process exits
            _log.info("waiting for the warmup to finish ...")
            await asyncio.to_thread(warmup_thread.join, 600)
        await server.batcher.stop()
        if reporter is not None:
            reporter.stop()
        for task in maintenance:
            task.stop()
        storage.flush()
        storage.close()
        _log.info("stopped")

    asyncio.run(_main())
    return 0


def cmd_ingest(args: argparse.Namespace) -> int:
    """One ingestion job into the configured store (host code: no
    device); prints the job's outcome as one JSON line, exit 1 when the
    job failed."""
    cfg = _load_config(args)
    init_logging(cfg.logging)
    from .ingest.manager import IngestionManager
    from .ingest.sources import CapDataSource, CourtListenerDataSource, MockDataSource
    from .storage.store import StorageManager

    storage = StorageManager(cfg.storage)
    mgr = IngestionManager(cfg, storage)
    mgr.register_source(MockDataSource())
    mgr.register_source(CapDataSource(cfg.ingestion.cap))
    mgr.register_source(CourtListenerDataSource(cfg.ingestion.courtlistener))

    async def _run():
        if args.incremental:
            return await mgr.check_for_updates(args.source, args.limit)
        return await mgr.ingest_bulk(args.source, args.limit)

    job = asyncio.run(_run())
    print(json.dumps({
        "job": job.id,
        "status": job.status.value,
        "processed": job.stats.processed if job.stats else 0,
        "skipped": job.stats.skipped_duplicates if job.stats else 0,
        "failed_validation": job.stats.failed_validation if job.stats else 0,
        "error": job.error,
    }))
    return 0 if job.error is None else 1


def cmd_build_index(args: argparse.Namespace) -> int:
    """Build and save every artifact: in one pass, or with ``--streaming``
    checkpointed and resumable (``--tune-recall`` and ``--pretrain-steps``
    do not apply there, as in the JAX package: a streaming build over a
    store with no saved encoder pretrains the builder's default 300
    steps). Prints the report as one JSON line."""
    cfg = _load_config(args)
    init_logging(cfg.logging)
    from .storage.store import StorageManager

    storage = StorageManager(cfg.storage)
    if args.streaming:
        from .index.streaming import StreamingIndexBuilder

        built = StreamingIndexBuilder(
            storage, cfg, work_dir=args.work_dir, shard_chunks=args.shard_chunks,
            device=args.device,
        ).build(resume=not args.no_resume)
        extra = {
            "shards": built.report.shards,
            "resumed_from_row": built.report.resumed_from_row,
            "chunks_per_second": built.report.chunks_per_second,
            "peak_rss_bytes": built.report.peak_rss_bytes,
        }
    else:
        from .index.builder import build_indexes, save_artifacts

        built = build_indexes(storage, cfg, tune_recall=args.tune_recall,
                              pretrain_steps=args.pretrain_steps, device=args.device)
        save_artifacts(built, cfg, storage=storage)
        extra = {}
    print(json.dumps({
        "cases": built.report.cases,
        "content_chunks": built.report.content_chunks,
        "citations": built.report.citations,
        "seconds": round(built.report.seconds, 3),
        "trie_path": cfg.trie.index_path,
        "vector_path": cfg.vector.hnsw.index_path,
        **extra,
    }))
    return 0


def cmd_check_health(args: argparse.Namespace) -> int:
    """Probe the store, then build the engine and probe it: exit 0 when
    both are healthy."""
    cfg = _load_config(args)
    init_logging(cfg.logging)
    ok = True
    report: dict[str, str] = {}
    # each probe reports its failure rather than stopping the others
    try:
        from .storage.store import StorageManager

        StorageManager(cfg.storage).health_check()
        report["storage"] = "healthy"
    except Exception as e:
        report["storage"] = f"unhealthy: {e}"
        ok = False
    try:
        _storage, engine = _build_components(cfg, args.device)
        engine.health_check()
        report["search_engine"] = "healthy"
    except Exception as e:
        report["search_engine"] = f"unhealthy: {e}"
        ok = False
    print(json.dumps({"status": "healthy" if ok else "unhealthy", **report}))
    return 0 if ok else 1


def cmd_search(args: argparse.Namespace) -> int:
    cfg = _load_config(args)
    init_logging(cfg.logging)
    _storage, engine = _build_components(cfg, args.device)
    from .search.engine import SearchQuery

    results = engine.search_with_params(SearchQuery(query=args.query, max_results=args.limit))
    print(json.dumps([r.to_json() for r in results], indent=2))
    return 0


def cmd_eval_retrieval(args: argparse.Namespace) -> int:
    """Held-out retrieval quality of the saved artifacts: half-sentence and
    paraphrase probes from the first ``--max-cases`` stored cases, their
    source case's MRR and recall@k through the engine (``trained``) and
    stage by stage (``stages``); with ``--control`` the served encoder and
    a seeded random one (``Embedder(..., seed=1234)``) over the same probes
    and chunk sample. One JSON object."""
    cfg = _load_config(args)
    init_logging(cfg.logging)
    storage, engine = _build_components(cfg, args.device)
    from .models.quality import build_probes, evaluate_embedder_direct, evaluate_engine, evaluate_stages

    docs: list[tuple[int, list[str]]] = []
    tp = engine._text_processor
    for row, _meta, text in storage.iter_cases_rowid():
        if len(docs) >= args.max_cases:
            break
        if text:
            docs.append((row, tp.extract_sentences(tp.normalize_text(text))))
    probes = build_probes(docs, max_probes=args.probes)
    out = {
        "probes": len(probes),
        "trained": evaluate_engine(engine, engine.columns, probes),
        # exact oracle vs the ANN at the tuned nprobe over the whole index:
        # where the engine's MRR falls from the exact ceiling
        "stages": evaluate_stages(engine, engine.columns, probes),
    }
    if args.control:
        # the control beside the served encoder in the same search space
        # (a chunk sample), not beside 'trained', which searches the index
        from .models.embedder import Embedder

        served = engine.vector_index.embedder
        rnd = Embedder(cfg.vector.model, tokenizer=served.tokenizer,
                       model_config=served.model_config, seed=1234, device=served.device)
        texts, cases = [], []
        for row, sents in docs[: args.max_cases]:
            for s in sents[:8]:
                texts.append(s)
                cases.append(row)
        out["trained_direct"] = evaluate_embedder_direct(served, texts, cases, probes)
        out["random_control"] = evaluate_embedder_direct(rnd, texts, cases, probes)
        out["comparability_note"] = (
            "compare trained_direct vs random_control (same search "
            "space); 'trained' searches the full index"
        )
    print(json.dumps(out, indent=2))
    return 0


def cmd_completions(args: argparse.Namespace) -> int:
    cfg = _load_config(args)
    init_logging(cfg.logging)
    _storage, engine = _build_components(cfg, args.device)
    print(json.dumps(engine.trie_index.get_completions(args.prefix, args.limit)))
    return 0


async def run_loadtest(args: argparse.Namespace, after_warm: Optional[Callable[[], None]] = None) -> dict:
    """``args.requests`` concurrent ``POST /search`` (at most
    ``args.concurrency`` in flight) with distinct queries
    (``args.query_template.format(i=i)``) after a warm pass of
    ``args.concurrency`` requests (optionally after ``/stats`` reports the
    engine warm): QPS, latency percentiles and replies by status. The warm
    pass sends the run's first queries, so against a server with a query
    cache those come back from the cache; a caller that serves in process
    can pass ``after_warm`` to clear its caches between the two passes."""
    import time

    import aiohttp

    base = args.url.rstrip("/")
    url = base + "/search"
    latencies: list[float] = []
    errors = [0]
    by_status: dict[str, int] = {}
    sem = asyncio.Semaphore(args.concurrency)

    async def one(session: aiohttp.ClientSession, i: int) -> None:
        payload = {"query": args.query_template.format(i=i), "max_results": 5}
        async with sem:
            t0 = time.perf_counter()
            try:
                async with session.post(url, json=payload) as resp:
                    await resp.read()
                    by_status[str(resp.status)] = by_status.get(str(resp.status), 0) + 1
                    if resp.status != 200:
                        errors[0] += 1
                latencies.append((time.perf_counter() - t0) * 1000)
            except (aiohttp.ClientError, asyncio.TimeoutError):
                # a timeout is not a ClientError: without it one slow
                # request would end the whole run
                errors[0] += 1
                by_status["client_error"] = by_status.get("client_error", 0) + 1

    timeout = aiohttp.ClientTimeout(total=args.timeout)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        if args.wait_warm:
            deadline = time.monotonic() + args.wait_warm
            while time.monotonic() < deadline:
                try:
                    async with session.get(base + "/stats") as resp:
                        st = await resp.json()
                    if st.get("engine", {}).get("is_warm"):
                        break
                except aiohttp.ClientError:
                    pass
                await asyncio.sleep(5)
            else:
                print("warning: server never reported warm; measuring anyway", file=sys.stderr)
        # warm pass (first requests of each shape on a cold server)
        await asyncio.gather(*(one(session, i) for i in range(args.concurrency)))
        if after_warm is not None:
            after_warm()
        latencies.clear()
        errors[0] = 0
        by_status.clear()
        t0 = time.perf_counter()
        await asyncio.gather(*(one(session, i) for i in range(args.requests)))
        wall = time.perf_counter() - t0
    latencies.sort()

    def pct(p: float) -> float:
        if not latencies:
            return float("nan")
        return latencies[min(len(latencies) - 1, int(p * len(latencies)))]

    return {
        "requests": args.requests,
        "concurrency": args.concurrency,
        "errors": errors[0],
        "by_status": by_status,
        "wall_s": round(wall, 2),
        "qps": round(args.requests / wall, 1) if wall else None,
        "p50_ms": round(pct(0.5), 1),
        "p95_ms": round(pct(0.95), 1),
        "p99_ms": round(pct(0.99), 1),
    }


def cmd_loadtest(args: argparse.Namespace) -> int:
    print(json.dumps(asyncio.run(run_loadtest(args))))
    return 0


def cmd_config_dump(args: argparse.Namespace) -> int:
    """Print the effective config (defaults + file + environment) as TOML."""
    print(_load_config(args).to_toml())
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    raise NotImplementedError(
        "bench runs the JAX package's bench.py; the benchmark is not ported in this round "
        "(chip_smoke.py drives the port on the card)"
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="legal-search-server-torch",
        description="Trie + semantic legal search engine (PyTorch/CUDA port)",
    )
    p.add_argument("-c", "--config", default="config.toml", help="config file path")
    p.add_argument(
        "--device", default="cuda", metavar="NAME",
        help="torch device to serve and build on (default cuda; a missing card is an "
             "error, 'cpu' runs on the CPU)",
    )
    sub = p.add_subparsers(dest="command")

    s = sub.add_parser("serve", help="run the API server")
    s.add_argument("-p", "--port", type=int, help="override server port")
    s.add_argument("--rebuild-index", action="store_true", help="rebuild indexes on startup")
    s.add_argument("--no-warmup", action="store_true",
                   help="skip running the serving shapes at startup")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("ingest", help="ingest cases from a source")
    s.add_argument("--source", default=None, help="source name (cap|courtlistener|mock)")
    s.add_argument("--limit", type=int, default=None)
    s.add_argument("--incremental", action="store_true")
    s.set_defaults(fn=cmd_ingest)

    s = sub.add_parser("build-index", help="(re)build frozen index artifacts")
    s.add_argument("--tune-recall", type=float, default=None,
                   help="auto-tune nprobe to this recall@10 target")
    s.add_argument("--pretrain-steps", type=int, default=0,
                   help="corpus-contrastive encoder pretraining steps")
    s.add_argument("--streaming", action="store_true",
                   help="checkpointed corpus-scale build (resumable)")
    s.add_argument("--work-dir", default=None, help="streaming build working directory")
    s.add_argument("--shard-chunks", type=int, default=8192,
                   help="chunks per embedding shard / checkpoint interval")
    s.add_argument("--no-resume", action="store_true",
                   help="ignore an existing streaming-build checkpoint")
    s.set_defaults(fn=cmd_build_index)

    s = sub.add_parser("check-health", help="probe component health and exit")
    s.set_defaults(fn=cmd_check_health)

    s = sub.add_parser("search", help="one-shot query")
    s.add_argument("query")
    s.add_argument("--limit", type=int, default=10)
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("eval-retrieval",
                       help="held-out retrieval-quality eval of the semantic encoder")
    s.add_argument("--probes", type=int, default=256)
    s.add_argument("--max-cases", type=int, default=2000)
    s.add_argument("--control", action="store_true",
                   help="also score a random-init encoder control")
    s.set_defaults(fn=cmd_eval_retrieval)

    s = sub.add_parser("completions", help="trie prefix completions")
    s.add_argument("prefix")
    s.add_argument("--limit", type=int, default=10)
    s.set_defaults(fn=cmd_completions)

    s = sub.add_parser("bench", help="run the benchmark suite")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("config-dump", help="print the effective config as TOML")
    s.set_defaults(fn=cmd_config_dump)

    s = sub.add_parser("loadtest", help="HTTP load test against a running server")
    s.add_argument("--url", default="http://127.0.0.1:8080")
    s.add_argument("--requests", type=int, default=500)
    s.add_argument("--concurrency", type=int, default=32)
    s.add_argument("--timeout", type=float, default=120.0)
    s.add_argument("--query-template", default="question of due process number {i}")
    s.add_argument("--wait-warm", type=float, default=0.0, metavar="SECONDS",
                   help="poll /stats until engine.is_warm before the measured run "
                        "(0 = don't wait)")
    s.set_defaults(fn=cmd_loadtest)

    return p


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
