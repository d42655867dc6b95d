"""The benchmark's own tests (run them with ``python -m pytest
benchmark/tests -q``). Tests that need an NVIDIA card take the ``card``
fixture, which skips them where there is none; the decision is made when
the fixture runs, never at import."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the size a CPU test run holds: 65,536 rows (above the engine's 50,000
#: for its partitioned mode) in 64 partitions, probed 8 at a time
TINY = {
    "corpus": {"partitions": 64, "slots": 1024, "nprobe": 8},
    "traffic": {"pool": 512, "batch": 16, "check_sample": 64, "warm_queries": 48, "trace_batches": 2,
                "rate": 20.0, "warm_requests": 16, "trace_seconds": 1},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skipped without one)")


@pytest.fixture()
def tiny_scale():
    return TINY


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return "cuda"


@pytest.fixture()
def tiny_spec():
    """A cell's spec for a CPU test run (two store workers). The bulk cell
    runs with the MiniLM configuration here: Legal-BERT's 12×768 encoder
    is the card's work."""
    import json

    from benchmark import cell

    def make(workload: str):
        spec = cell.load_spec(workload)
        if workload == "legal-bert.bulk-256":
            spec.config = json.loads((ROOT / "benchmark" / "configs" / "minilm-l6-cap1m.json").read_text())
        spec.config["serving"]["store_workers"] = 2
        return spec

    return make
