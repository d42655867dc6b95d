"""Request micro-batching in front of ``SearchEngine.search_batch`` (port of
``trie_semantic_search_tpu/api/batching.py``, the same pure-asyncio code).

Requests enqueue; a dispatcher drains the queue every ``window_ms`` (or as
soon as ``max_batch`` have arrived) and runs one ``search_batch`` in a
worker thread, so concurrent requests share one device step.

Under congestion:

* **Ghost requests** — a request whose client timed out (``asyncio.wait_for``
  cancels its future) is dropped when a batch is assembled and again just
  before the batch launches, so no device time goes to dead requests.
* **Load shedding** — ``submit`` raises :class:`QueueFullError` at once when
  ``max_pending`` requests are queued (the HTTP layer answers 503 with
  Retry-After) instead of queueing into a certain timeout.
* **Failed batches** — a failed batch of at most ``single_retry_max``
  items retries each still-waiting item alone, so one poisoned request
  fails alone; larger failed batches fail fast.

Each request's wait, from ``submit`` to the moment its batch's ``run_batch``
starts on the worker thread (the window and the wait for an execution
slot), goes into the ``core/metrics`` span ``batch.queue_wait``, one
sample per request.

``inflight > 1`` pipelines batches: while one batch runs in its worker
thread (device step and host hydration), the dispatcher assembles and
launches the next. The engine's batch path is safe to call from two
threads at once: the indexes are frozen, the caches, the sqlite
connection, the lazy fused state and the counters are behind locks, and
both threads enqueue their kernels on the card's default stream, which
runs them one after another.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Optional, Sequence

from ..core.metrics import metrics

_log = logging.getLogger("tss_torch.api.batching")


class QueueFullError(RuntimeError):
    """Raised by :meth:`BatchingQueue.submit` when the pending backlog is at
    ``max_pending`` — callers should shed the request immediately (HTTP 503)
    instead of queueing it into certain timeout."""


class BatchingQueue:
    def __init__(
        self,
        run_batch: Callable[[Sequence[Any]], list[Any]],
        max_batch: int = 64,
        window_ms: float = 2.0,
        max_pending: int = 256,
        inflight: int = 2,
        single_retry_max: int = 4,
    ):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.max_pending = max_pending
        self.inflight = max(1, inflight)
        self.single_retry_max = single_retry_max
        #: (item, its future, ``time.perf_counter`` when it was queued)
        self._queue: asyncio.Queue[tuple[Any, asyncio.Future, float]] = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._sem: Optional[asyncio.Semaphore] = None
        self._closed = False
        self._batch_tasks: set[asyncio.Task] = set()
        # observability (surfaced via /stats)
        self.stats = {
            "batches": 0,
            "items": 0,
            "ghosts_dropped": 0,
            "shed": 0,
            "batch_failures": 0,
        }

    async def start(self) -> None:
        if self._task is None:
            self._sem = asyncio.Semaphore(self.inflight)
            self._task = asyncio.create_task(self._dispatch_loop())

    async def stop(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for t in list(self._batch_tasks):
            t.cancel()
        self._batch_tasks.clear()

    def depth(self) -> int:
        """Requests currently queued (excludes in-flight batches)."""
        return self._queue.qsize()

    async def submit(self, item: Any) -> Any:
        """Enqueue one request; resolves with its result (or raises).

        Raises :class:`QueueFullError` immediately when ``max_pending``
        requests are already queued — the caller must not wait."""
        if self._closed:
            raise RuntimeError("batching queue is stopped")
        if self._queue.qsize() >= self.max_pending:
            self.stats["shed"] += 1
            raise QueueFullError(
                f"{self._queue.qsize()} requests pending (max {self.max_pending})"
            )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((item, fut, time.perf_counter()))
        return await fut

    async def _dispatch_loop(self) -> None:
        assert self._sem is not None
        while True:
            pair = await self._queue.get()
            if pair[1].done():  # client gave up while queued
                self.stats["ghosts_dropped"] += 1
                continue
            batch = [pair]
            # Collect more requests until the window closes or the batch
            # fills; cancelled requests are dropped, not batched.
            deadline = asyncio.get_running_loop().time() + self.window_s
            while len(batch) < self.max_batch:
                timeout = deadline - asyncio.get_running_loop().time()
                if timeout <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                if nxt[1].done():
                    self.stats["ghosts_dropped"] += 1
                    continue
                batch.append(nxt)
            # Pipelining: block until an execution slot frees (bounds
            # in-flight batches), then launch this batch as a task and go
            # straight back to assembling the next one.
            await self._sem.acquire()
            # Re-check liveness right before spending device time: under a
            # stall, most of the assembled batch may have timed out while
            # waiting for the slot.
            alive = [p for p in batch if not p[1].done()]
            self.stats["ghosts_dropped"] += len(batch) - len(alive)
            if not alive:
                self._sem.release()
                continue
            task = asyncio.create_task(self._run_batch(alive))
            self._batch_tasks.add(task)
            task.add_done_callback(self._batch_tasks.discard)

    def _run_timed(self, items: list[Any], queued: list[float]) -> list[Any]:
        """``run_batch`` on the worker thread, after recording each item's
        queue wait."""
        start = time.perf_counter()
        h = metrics.histogram("batch.queue_wait")
        for t in queued:
            h.observe((start - t) * 1000)
        return self.run_batch(items)

    async def _run_batch(self, batch: list[tuple[Any, asyncio.Future, float]]) -> None:
        assert self._sem is not None
        items = [b[0] for b in batch]
        try:
            try:
                results = await asyncio.to_thread(self._run_timed, items, [b[2] for b in batch])
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch returned {len(results)} results for {len(items)} items"
                    )
                for (_, f, _), r in zip(batch, results):
                    if not f.done():
                        f.set_result(r)
            except Exception as e:
                self.stats["batch_failures"] += 1
                # Per-item fallback: one poisoned request must not fail the
                # whole batch — but only retry callers still waiting, and
                # only for small batches (a serial retry of a big batch
                # stalls the dispatcher for N × single_exec; observed as a
                # 504 cascade in the round-4 TPU loadtest).
                alive = [(it, f) for it, f, _ in batch if not f.done()]
                if len(alive) > self.single_retry_max:
                    _log.warning(
                        "batch of %d failed (%s); failing %d items fast",
                        len(items), e, len(alive),
                    )
                    for _, f in alive:
                        if not f.done():
                            f.set_exception(e)
                    return
                _log.debug("batch failed (%s); retrying %d singly", e, len(alive))
                for it, f in alive:
                    if f.done():
                        continue
                    try:
                        r = await asyncio.to_thread(self.run_batch, [it])
                        if not f.done():
                            f.set_result(r[0])
                    except Exception as single_e:
                        if not f.done():
                            f.set_exception(single_e)
        finally:
            self.stats["batches"] += 1
            self.stats["items"] += len(items)
            self._sem.release()
