"""Open loop over HTTP: ``POST /search`` to the port's ``ApiServer`` (its
``BatchingQueue`` in front of ``SearchEngine.search_batch``), served from
an event loop on a thread of this process, at Poisson arrivals of a fixed
``rate``. The client is a child process (``http_client``) that sends each
request when it is due, whatever came back before, and times it from
then. The traced run then profiles ``trace_seconds`` more of the engine
at the window's mean batch size, on queries the window did not send."""

from __future__ import annotations

import asyncio
import copy
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time

from .. import data, hostwatch, trace

SHED = (503, 504)


def queries_needed(traffic: dict, seconds: float, trace_on: bool) -> int:
    extra = float(traffic["trace_seconds"]) if trace_on else 0.0
    return int(math.ceil(float(traffic["rate"]) * (seconds + extra)))


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def warm(s) -> None:
    from aiohttp import web

    from trie_semantic_search_tpu_torch.api.server import ApiServer
    from trie_semantic_search_tpu_torch.core.types import AppState
    from trie_semantic_search_tpu_torch.utils import BATCH_BUCKETS

    engine = s.engine
    config = copy.deepcopy(engine.config)
    server = ApiServer(AppState(config=config, search_engine=engine, storage=engine.storage))
    s.batches = trace.Batches()
    if s.trace_on:
        server.batcher.run_batch = s.batches.wrap(engine.search_batch, s.index_of)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="http-server", daemon=True)
    thread.start()
    runner = web.AppRunner(server.app, access_log=None)
    on_loop = lambda coro: asyncio.run_coroutine_threadsafe(coro, loop).result(120)  # noqa: E731
    port = _free_port()
    on_loop(runner.setup())
    on_loop(web.TCPSite(runner, "127.0.0.1", port).start())
    s.http = {"server": server, "loop": loop, "thread": thread, "runner": runner, "on_loop": on_loop,
              "url": f"http://127.0.0.1:{port}"}
    # every batch bucket the batcher can form, at both token-length
    # buckets of the mix (names alone; names with phrases), then a burst
    # through HTTP; the warm queries are not the window's
    names = [q for q in s.warm_queries if q.kind != "semantic"]
    mixed = list(s.warm_queries)
    for b in (x for x in BATCH_BUCKETS if x <= config.server.batch_max):
        for pool in (names, mixed):
            engine.search_batch([s.to_search(q) for q in pool[:b]])
    bodies = [q.body() for q in s.warm_queries[-int(s.traffic["warm_requests"]):]]
    on_loop(_burst(s.http["url"], bodies, 32))
    s.clear_caches()


async def _burst(url: str, bodies: list, concurrency: int) -> None:
    import aiohttp

    sem = asyncio.Semaphore(concurrency)
    async with aiohttp.ClientSession(base_url=url) as c:
        async def one(b):
            async with sem, c.post("/search", json=b) as r:
                await r.read()
        await asyncio.gather(*(one(b) for b in bodies))


def measure(s, seconds: float, trace_on: bool) -> dict:
    qs = s.queries
    due = data.arrivals(float(s.traffic["rate"]), len(qs), s.seed)
    n = int((due < seconds).sum())  # the window's requests; the rest feed the traced stretch
    sched = s.out_dir / "schedule.json"
    out = s.out_dir / "client.jsonl"
    sched.write_text(json.dumps([[float(d), q.body()] for d, q in zip(due[:n], qs[:n])]))
    env = dict(os.environ, PYTHONPATH=str(s.root))
    proc = subprocess.Popen(
        [sys.executable, "-m", "benchmark.drivers.http_client", "--url", s.http["url"], "--schedule",
         str(sched), "--out", str(out), "--timeout", str(float(s.traffic["request_timeout_s"]))],
        cwd=s.root, env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("T0 "):
            raise RuntimeError(f"the HTTP client did not start: {line!r}")
        t0 = float(line.split()[1])  # time.monotonic of the window's start
        server = s.http["server"]
        time.sleep(max(0.0, t0 - time.monotonic()))
        snap, b0 = s.spans(), dict(server.batcher.stats)
        n_window = len(s.batches.items)
        watch = hostwatch.Watch().start()
        time.sleep(max(0.0, t0 + seconds - time.monotonic()))
        spans, b1 = s.spans_since(snap), dict(server.batcher.stats)
        _log(watch.stop())
        window_batches = list(s.batches.items[n_window:])
        rest, _ = proc.communicate(timeout=seconds + float(s.traffic["request_timeout_s"]) + 120)
        stretch = None
        if trace_on:
            mean = (b1["items"] - b0["items"]) / max(1, b1["batches"] - b0["batches"])
            stretch = _profiled_stretch(s, s.search_queries[n:], max(1, round(mean)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the HTTP client exited with {proc.returncode}: {rest[-2000:]}")
    answers, lat, done_s, attempted, failed, lateness, dues = {}, [], [], 0, 0, [], []
    for rec in map(json.loads, out.read_text().splitlines()):
        i, d, sent, done, status, results = rec
        if d >= seconds:
            continue
        attempted += 1
        dues.append(d)
        lateness.append(sent - (t0 + d))
        if status == 200:
            answers[i] = results
            lat.append((done - (t0 + d)) * 1e3)
            done_s.append(done - t0)
        else:
            failed += 1
            lat.append(math.inf)
            done_s.append(math.inf)
            if status not in SHED:
                answers[i] = None
    batcher = {k: b1[k] - b0[k] for k in ("batches", "items", "shed", "ghosts_dropped")}
    _log(_timeline(dues, lat, seconds, spans, batcher))
    return {"answers": answers, "attempted": attempted, "failed": failed, "answered": len(answers),
            "window_s": float(seconds), "latencies_ms": lat, "done_s": done_s, "spans": spans,
            "batcher": batcher,
            "window_batches": window_batches, "stretch": stretch,
            "lateness_ms": sorted(x * 1e3 for x in lateness)}


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _timeline(dues: list, lat: list, seconds: float, spans: dict, batcher: dict, step: float = 5.0) -> str:
    """The window's spans and batches, and its latency by stretches of
    ``step`` seconds of due time (count, p50, p95, max): whether a run's
    tail comes from the whole window or from a few stalls."""
    from ..costs import percentile

    parts = [f"{n} {t / c:.1f} ms x{c}" for n, (c, t) in spans.items() if c]
    out = (f"window spans: {', '.join(parts)}; batches {batcher['batches']}, "
           f"mean {batcher['items'] / max(1, batcher['batches']):.2f}; latency ms by {step:g} s:")
    for lo in range(0, int(math.ceil(seconds / step))):
        xs = [x for d, x in zip(dues, lat) if lo * step <= d < (lo + 1) * step]
        if xs:
            out += (f" [{lo * step:g}-{(lo + 1) * step:g}) n {len(xs)} p50 {percentile(xs, 50):.0f}"
                    f" p95 {percentile(xs, 95):.0f} max {max(xs):.0f}")
    return out


def _profiled_stretch(s, queries: list, batch: int):
    """``trace_seconds`` of the engine under the profiler, after the
    window: batches of the window's mean size, from this thread (the
    profiler on the card follows only the thread that starts it, and the
    server runs its batches on worker threads)."""
    run = s.batches.wrap(s.engine.search_batch, s.index_of)
    mark = len(s.batches.items)
    with trace.Stretch(s.torch, s.out_dir) as st:
        end = time.monotonic() + float(s.traffic["trace_seconds"])
        for i in range(0, len(queries) - batch + 1, batch):
            run(queries[i : i + batch])
            if time.monotonic() >= end:
                break
    return st, s.batches.items[mark:]


def close(s) -> None:
    h = getattr(s, "http", None)
    if not h:
        return
    h["on_loop"](h["runner"].cleanup())
    h["loop"].call_soon_threadsafe(h["loop"].stop)
    h["thread"].join(timeout=60)
    if h["thread"].is_alive():
        raise RuntimeError("the HTTP server's thread did not stop")
    h["loop"].close()
    s.http = None
