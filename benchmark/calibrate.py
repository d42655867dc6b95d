#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell: the
program's compared numbers and the control's (the reference computed in
float8 in the program's place, on the same sampled queries), seed after
seed in one process, each a short window at the cell's own load.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 --seconds 8

Prints one JSON line per seed. The benchmark's own runs never run the
control."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    a = ap.parse_args()
    import torch

    from benchmark import cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = cell.load_spec(a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        out = cell.run(spec, seed, a.seconds, False, "cuda", time.perf_counter(), control=True)
        v = out["verdict"]
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "program": {k: x["value"] for k, x in out["numbers"].items()} | {"recall": v.recall},
                          "control": out["control"], "queries": v.queries, "results": v.results,
                          "notes": v.notes, "metrics": out["line"]["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
