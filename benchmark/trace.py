"""The traced stretch: ``torch.profiler`` over a few seconds of the cell's
own load after the window, read from its Chrome trace.

The stretch runs its batches one after another from the thread that
starts the profiler. Device operations (kernels, copies, sets) give the
busy time; each kernel is charged to the batch whose host interval holds
its launch (the launch's correlation id joins the two), or its own start
where the launch is missing. Host clocks map onto the trace's clock
through a marker range recorded at a known instant."""

from __future__ import annotations

import bisect
import json
import threading
import time
from pathlib import Path

from .costs import union_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARK = "bench.clock"


class Batches:
    """Host intervals of the engine's batches: ``(start, end, query
    indices)`` on ``time.perf_counter``, recorded by :meth:`wrap`."""

    def __init__(self):
        self.items: list[tuple[int, float, float, list[int]]] = []
        self._lock = threading.Lock()

    def wrap(self, fn, index_of):
        """``fn`` (a ``search_batch``) that records each call's interval;
        ``index_of`` maps a query object to its index in the mix (-1 for a
        warm-up query)."""

        def run(queries):
            t0 = time.perf_counter()
            try:
                return fn(queries)
            finally:
                idx = [index_of(q) for q in queries]
                rec = (t0, time.perf_counter(), [i for i in idx if i >= 0])
                with self._lock:
                    self.items.append(rec)

        return run


class Stretch:
    """``with Stretch(torch, out_dir) as st:`` profiles the block; after it,
    ``st.path`` is the Chrome trace and ``st.t0``/``st.t1`` its host span."""

    def __init__(self, torch, out_dir: Path):
        self.torch, self.path = torch, Path(out_dir) / "trace.json"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.torch.cuda.is_available() else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        with record_function(MARK):
            self.mark = time.perf_counter()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(str(self.path))
        return False


def read(st: Stretch, batches: list) -> dict:
    """The stretch's device time: ``busy_s``, ``window_s``, per-batch
    kernel microseconds by name, ``device_ops`` (top 10 by time) and
    ``idle_gaps`` (the 10 longest, each named by the host op that
    overlapped it most)."""
    events = json.loads(Path(st.path).read_text())["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    mark = next(e for e in xs if e.get("name") == MARK)
    offset = float(mark["ts"]) - st.mark * 1e6  # trace µs = host s * 1e6 + offset
    w0, w1 = st.t0 * 1e6 + offset, st.t1 * 1e6 + offset
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    launch = {e["args"]["correlation"]: e for e in xs
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    spans = sorted((b[0] * 1e6 + offset, b[1] * 1e6 + offset, i) for i, b in enumerate(batches))
    starts = [s[0] for s in spans]

    def batch_of(ts: float):
        k = bisect.bisect_right(starts, ts) - 1
        return spans[k][2] if k >= 0 and ts <= spans[k][1] else None

    per_batch: dict[int, dict[str, float]] = {}
    by_name: dict[str, float] = {}
    intervals = []
    for e in dev:
        s, d = float(e["ts"]), float(e["dur"])
        a, b = max(s, w0), min(s + d, w1)
        if b > a:
            intervals.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + d
        if e.get("cat") != "kernel":
            continue
        ln = launch.get(e.get("args", {}).get("correlation"))
        bi = batch_of(float(ln["ts"]) if ln is not None else s)
        if bi is not None:
            k = per_batch.setdefault(bi, {})
            k[e["name"]] = k.get(e["name"], 0.0) + d
    busy = union_seconds(intervals)
    gaps, cur = [], w0
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation", "python_function") + LAUNCH_CATS]

    def label(g) -> str:
        best, name = 0.0, "no host op recorded"
        for e in host:
            ov = min(float(e["ts"]) + float(e["dur"]), g[1]) - max(float(e["ts"]), g[0])
            if ov > best and e.get("name") != MARK:
                best, name = ov, str(e["name"])[:80]
        return name

    return {
        "busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6, "per_batch": per_batch,
        "device_ops": [[n[:80], v / 1e6] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[label(g), (g[1] - g[0]) / 1e6] for g in gaps],
    }
