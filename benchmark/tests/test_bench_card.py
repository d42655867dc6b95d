"""On the card, at a cell's own size: a short window of the Legal-BERT
bulk cell is correct, and the reference computed in float8 in the program's
place is not. Skipped where there is no NVIDIA card; on the card run
``python -m pytest benchmark/tests -q -k card``."""

from __future__ import annotations

import time

import pytest

from benchmark import cell


@pytest.mark.card
def test_card_cell_is_correct_and_its_control_is_not(card):
    spec = cell.load_spec("legal-bert.bulk-256")
    out = cell.run(spec, 2**31 + 99, 5.0, False, card, time.perf_counter(), control=True)
    limit = out["numbers"]["score_gap"]["limit"]
    assert out["line"]["correct"], out["verdict"].notes
    assert out["control"]["score_gap"] > limit
