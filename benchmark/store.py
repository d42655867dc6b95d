"""The seeded case store, written fast: the port store's schema, statements
and rows (``UPSERT_METADATA``/``metadata_row``, ``UPSERT_TEXT``/``text_row``,
compression as configured), one transaction per batch, rows made by worker
processes and written by one. ``store_cases_batch`` writes the same rows
but commits each one; a test holds the two equal row for row.

Run as a child process beside the card's set-up (:func:`start`); it
writes its seconds to ``<db>.json``.
"""

from __future__ import annotations

import datetime as dt
import json
import multiprocessing as mp
import sqlite3
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: a fixed ingestion time, so that a seed always writes the same bytes
INGESTED = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
BATCH = 16384

_CASES = None


def case_metadata(CaseMetadata, cases, c: int):
    from . import data

    return CaseMetadata(
        id=data.case_uuid(c), name=cases.name(c), citation=cases.citation(c), court=cases.court(c),
        decision_date=cases.date(c), word_count=cases.chunks * (data.WORDS_PER_SENTENCE + 5),
        ingestion_date=INGESTED,
    )


def _init(n: int, chunks: int, seed: int) -> None:
    global _CASES
    sys.path.insert(0, str(ROOT))
    from benchmark import data

    _CASES = data.make_cases(n, chunks, seed)


def _rows(span: tuple[int, int, bool]) -> tuple[list, list]:
    from trie_semantic_search_tpu_torch.core.types import CaseMetadata
    from trie_semantic_search_tpu_torch.storage import store as st

    lo, hi, compress = span
    meta, text = [], []
    for c in range(lo, hi):
        m = case_metadata(CaseMetadata, _CASES, c)
        meta.append(st.metadata_row(m))
        text.append(st.text_row(m.id, _CASES.text(c), compress))
    return meta, text


def write(db_path: str, n: int, chunks: int, seed: int, workers: int) -> dict:
    """Write cases ``0..n-1`` into a new store at ``db_path``."""
    from trie_semantic_search_tpu_torch.core.config import StorageConfig
    from trie_semantic_search_tpu_torch.storage import store as st

    t0 = time.perf_counter()
    config = StorageConfig(db_path=db_path)
    st.StorageManager(config).close()
    conn = sqlite3.connect(db_path)
    # the bulk load journals nothing; the store's own connection sets WAL
    conn.execute("PRAGMA journal_mode=OFF")
    conn.execute("PRAGMA synchronous=OFF")
    spans = [(lo, min(n, lo + BATCH), config.enable_compression) for lo in range(0, n, BATCH)]
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers, initializer=_init, initargs=(n, chunks, seed)) as pool:
        for meta, text in pool.imap(_rows, spans):
            with conn:
                conn.executemany(st.UPSERT_METADATA, meta)
                conn.executemany(st.UPSERT_TEXT, text)
    conn.execute("PRAGMA journal_mode=WAL")
    conn.close()
    return {"store_s": time.perf_counter() - t0, "cases": n,
            "store_bytes": Path(db_path).stat().st_size}


def _child(db_path: str, n: int, chunks: int, seed: int, workers: int) -> None:
    sys.path.insert(0, str(ROOT))
    out = write(db_path, n, chunks, seed, workers)
    Path(db_path + ".json").write_text(json.dumps(out))


def start(db_path: str, n: int, chunks: int, seed: int, workers: int):
    """The writer as a child process (spawned); ``join`` it, then read
    ``<db>.json``."""
    proc = mp.get_context("spawn").Process(target=_child, args=(db_path, n, chunks, seed, workers),
                                           name="store-writer")
    proc.start()
    return proc


def finish(proc, db_path: str) -> dict:
    proc.join()
    if proc.exitcode != 0:
        raise RuntimeError(f"the store writer exited with {proc.exitcode}")
    return json.loads(Path(db_path + ".json").read_text())
