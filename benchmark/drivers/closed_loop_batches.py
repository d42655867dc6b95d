"""Closed loop: one caller sends ``search_batch`` of ``batch`` distinct
queries back to back, in process, until the window is over; the traced
run then profiles ``trace_batches`` more."""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import hostwatch, trace


def as_json(results) -> list:
    """A query's results as the check reads them (the fields of ``POST
    /search``'s JSON it compares)."""
    return [{"case_metadata": {"id": str(r.case_metadata.id), "name": r.case_metadata.name,
                               "citation": r.case_metadata.citation, "court": r.case_metadata.court,
                               "decision_date": r.case_metadata.decision_date.isoformat()},
             "score": r.score, "match_type": r.match_type.value, "snippet": r.snippet}
            for r in results]


def kept_positions(s, n_batches: int, B: int) -> list[list[int]]:
    """Per batch, the positions whose answers the window keeps for the
    check: a seeded eighth of the pool (four times the check's sample of
    a pool answered about half through), and the pool's 256 longest
    queries, so that the answered prefix holds its longest. Drawn before
    the window, so the window only keeps references."""
    n = n_batches * B
    rng = np.random.default_rng([s.seed, 6])
    keep = rng.random(n) < min(1.0, 4 * int(s.traffic["check_sample"]) / n)
    keep[np.argsort([-len(t) for t in s.token_ids[:n]], kind="stable")[:256]] = True
    return [np.nonzero(keep[b * B : (b + 1) * B])[0].tolist() for b in range(n_batches)]


def queries_needed(traffic: dict, seconds: float, trace_on: bool) -> int:
    return int(traffic["pool"])


def warm(s) -> None:
    """A few batches of the mix's own shape (other queries than the
    window's), so that nothing builds or loads inside the window."""
    B = int(s.traffic["batch"])
    for i in range(len(s.warm_queries) // B):
        s.engine.search_batch([s.to_search(q) for q in s.warm_queries[i * B : (i + 1) * B]])
    s.clear_caches()


def measure(s, seconds: float, trace_on: bool) -> dict:
    B = int(s.traffic["batch"])
    qs = s.search_queries
    n_batches = len(qs) // B
    rec = trace.Batches()
    run = rec.wrap(s.engine.search_batch, s.index_of)
    # the window keeps the result objects of the answers the check may
    # sample, and no others: tens of thousands of kept objects would load
    # the interpreter's collector inside the window
    positions = kept_positions(s, n_batches, B)
    kept: dict[int, list] = {}
    snap = s.spans()
    watch = hostwatch.Watch().start()
    t0 = time.perf_counter()
    b = 0
    while True:
        if b >= n_batches:
            raise RuntimeError(f"the pool of {len(qs)} queries ran out inside the window")
        out = run(qs[b * B : (b + 1) * B])
        for k in positions[b]:
            kept[b * B + k] = out[k]
        b += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    print(watch.stop(), file=sys.stderr, flush=True)
    answers = {i: as_json(r) for i, r in kept.items()}
    obs = {"answers": answers, "attempted": b * B, "failed": 0, "answered": b * B,
           "window_s": window_s, "spans": s.spans_since(snap), "window_batches": list(rec.items)}
    if trace_on:
        left = n_batches - b
        k = min(int(s.traffic["trace_batches"]), left)
        if k < 1:
            raise RuntimeError("no queries left for the traced stretch")
        mark = len(rec.items)
        with trace.Stretch(s.torch, s.out_dir) as st:
            for j in range(b, b + k):
                run(qs[j * B : (j + 1) * B])
        obs["stretch"] = (st, rec.items[mark:])
    return obs


def close(s) -> None:
    pass
