#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's inputs from the seed, sets up and warms the port
(``trie_semantic_search_tpu_torch``) for the cell's own shapes, measures
for ``--seconds``, checks the window's answers against the plain reference
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines on standard error). Set-up seconds and the
generator's lateness go to standard error before them.

Exits non-zero, printing no result, without a CUDA card, when the process
has loaded JAX or the JAX package by the end, or on any failure."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true", help="list each cell with its files, and run nothing")
    a = ap.parse_args(argv)
    from benchmark import cell

    if a.list:
        for line in cell.listing():
            print(line)
        return 0
    if a.workload is None or a.seed is None or a.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    import torch

    spec = cell.load_spec(a.workload)
    need = int(spec.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = cell.run(spec, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    bad = cell.forbidden_modules(list(sys.modules))
    if bad:
        print(f"the run loaded {bad}: no result", file=sys.stderr)
        return 3
    for name, x in out["numbers"].items():
        print(f"check {name}: {x['value']!r} (limit {x['limit']!r})", file=sys.stderr)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
