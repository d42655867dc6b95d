#!/usr/bin/env python3
"""The knee of an open-loop HTTP cell: one set-up, then a window at each of
several fixed rates, on queries no window repeats.

    python3 benchmark/sweep.py --workload minilm-l6.http-steady --seed <n> \\
        --seconds 10 --rates 100,150,200,250,300

For each rate it prints one JSON line: the offered and the completed rate
(requests answered inside the window over its seconds), p50 and p95 (from
when each request was due), the failed count, and the median latency of the
window's first and last quarter of requests. The knee is the highest rate
whose completed rate keeps up with the offered one and whose latency does
not grow from the first quarter to the last; the cell runs at 0.8 of it,
written into its traffic file by hand. With ``--tune`` it then prints
the nprobe that the port's own tuner picks on this data."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def row(rate: float, seconds: float, obs: dict) -> dict:
    from benchmark.costs import percentile

    lat, done = obs["latencies_ms"], obs["done_s"]
    q = max(1, len(lat) // 4)
    first, last = sorted(lat[:q]), sorted(lat[-q:])
    return {"rate": rate, "offered": obs["attempted"] / seconds,
            "completed": sum(1 for d in done if d <= seconds) / seconds,
            "p50_ms": percentile(lat, 50), "p95_ms": min(percentile(lat, 95), 1e9),
            "failed": obs["failed"], "first_quarter_p50_ms": first[len(first) // 2],
            "last_quarter_p50_ms": min(last[len(last) // 2], 1e9),
            "batch_mean": obs["batcher"]["items"] / max(obs["batcher"]["batches"], 1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--tune", action="store_true", help="then print the port's nprobe tuner's pick")
    a = ap.parse_args()
    import torch

    from benchmark import cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    rates = [float(x) for x in a.rates.split(",")]
    spec = cell.load_spec(a.workload)
    n = sum(math.ceil(r * a.seconds) for r in rates)
    prep = cell.prepare(spec, a.seed, a.seconds, False, "cuda", T_START, n_queries=n)
    everything = prep.queries
    try:
        lo = 0
        for r in rates:
            k = math.ceil(r * a.seconds)
            prep.queries = everything[lo : lo + k]
            prep.traffic["rate"] = r
            lo += k
            obs = prep.driver.measure(prep, a.seconds, False)
            print(json.dumps(row(r, a.seconds, obs)), flush=True)
            prep.clear_caches()
            time.sleep(2.0)
        if a.tune:
            # what the port's tuner would pick on this data (it is not run in
            # set-up): row recall@10 0.95 over 256 phrase queries
            sem = [i for i, q in enumerate(everything) if q.kind == "semantic"][:256]
            q = prep.ref_emb[torch.as_tensor(sem, device=prep.ref_emb.device)].cpu().numpy()
            t0 = time.perf_counter()
            pick = prep.engine.vector_index.ann.tune_nprobe(q, k=10, target_recall=0.95)
            print(json.dumps({"tuned_nprobe": int(pick), "tune_s": time.perf_counter() - t0}), flush=True)
    finally:
        cell.release(prep)
        prep.tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
