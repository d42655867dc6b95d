"""The fast store writer writes ``StorageManager.store_cases_batch``'s rows,
row for row."""

from __future__ import annotations

import gzip
import sqlite3

from benchmark import data, store


def rows(db: str):
    conn = sqlite3.connect(db)
    meta = conn.execute("SELECT rowid, * FROM case_metadata ORDER BY rowid").fetchall()
    text = [(r, cid, comp, gzip.decompress(blob) if comp else blob)
            for r, cid, comp, blob in conn.execute("SELECT rowid, * FROM case_text ORDER BY rowid")]
    conn.close()
    return meta, text


def test_fast_writer_rows_equal_store_cases_batch(tmp_path):
    from trie_semantic_search_tpu_torch.core.config import StorageConfig
    from trie_semantic_search_tpu_torch.core.types import CaseMetadata
    from trie_semantic_search_tpu_torch.storage.store import StorageManager

    n, seed = 1000, 17
    fast = str(tmp_path / "fast.sqlite")
    info = store.write(fast, n, 4, seed, workers=2)
    assert info["cases"] == n
    cases = data.make_cases(n, 4, seed)
    slow = StorageManager(StorageConfig(db_path=str(tmp_path / "slow.sqlite")))
    batch = [(store.case_metadata(CaseMetadata, cases, c), cases.text(c)) for c in range(n)]
    assert slow.store_cases_batch(batch) == (n, [])
    slow.close()
    assert rows(fast) == rows(str(tmp_path / "slow.sqlite"))
    # and the store serves them: the port reads a case back whole
    got = StorageManager(StorageConfig(db_path=fast))
    meta = got.get_case_metadata(data.case_uuid(123))
    assert (meta.name, meta.citation, meta.court) == (cases.name(123), cases.citation(123), cases.court(123))
    assert got.get_case_text(data.case_uuid(123)) == cases.text(123)
    got.close()
